"""PyTorch port, the reference checkpoint import (``utils/torch_import.py``)
against the JAX package's, on the CPU.

Torch modules with the reference's wiring are built inside the test (as
``tests/test_torch_import.py`` does): a 2-layer LSTM or GRU, a CNN (Conv1d
k5 -> BatchNorm -> ReLU -> Conv1d k3 -> BatchNorm -> ReLU -> mean) with
non-trivial BatchNorm running statistics, or a post-LN transformer of
``nn.TransformerEncoderLayer``s for the audio; the frame encoder with its
attention pool or without it (mean over frames); the concat head.  Their
modules sit under the reference LightningModule's attribute names
(``encoders.<m>.*``, ``fusion_head.*``), so their ``state_dict`` keys are
the reference layout.  Each case checks

* the port's logits, with the imported ``state_dict`` loaded
  ``strict=True``, against the torch module's own eval forward (rtol 1e-4,
  atol 2e-5, the JAX test's bound);
* the imported ``state_dict`` equal, tensor by tensor and bit for bit, to
  ``utils/weights.py::state_dict_from_jax_params`` of JAX's
  ``import_reference_state_dict`` on the same dict (BatchNorm statistics
  through JAX's ``template_batch_stats`` route);

and ``load_lightning_state_dict``'s weights-only refusal and
``allow_pickle``, beside JAX's on the same file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodal_emotion_detection_tpu.models import (
    MultimodalClassifier as JaxMultimodalClassifier,
)
from multimodal_emotion_detection_tpu.utils import torch_import as jax_import
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    MultimodalClassifier,
)
from multimodal_emotion_detection_tpu_torch.utils.torch_import import (
    import_reference_checkpoint,
    import_reference_state_dict,
    load_lightning_state_dict,
)
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

B, T_A, T_V = 3, 30, 6
AUDIO_D, VIDEO_D, HID, OUT_D, HEAD_H, C = 4, 32, 24, 16, 20, 8
TF_HID = 32  # 4 heads of 8
MAX_LEN = 4096  # the transformer's positional table


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class RefAudio(nn.Module):
    """The reference SequenceEncoder's wiring for one ``kind``."""

    def __init__(self, kind: str, hidden: int):
        super().__init__()
        self.kind = kind
        if kind in ("lstm", "gru"):
            cls = nn.LSTM if kind == "lstm" else nn.GRU
            self.rnn = cls(AUDIO_D, hidden, num_layers=2, batch_first=True)
        elif kind == "cnn":
            self.conv1 = nn.Conv1d(AUDIO_D, hidden, 5, padding=2)
            self.bn1 = nn.BatchNorm1d(hidden)
            self.conv2 = nn.Conv1d(hidden, hidden, 3, padding=1)
            self.bn2 = nn.BatchNorm1d(hidden)
        else:
            self.input_proj = nn.Linear(AUDIO_D, hidden)
            self.pos_embedding = nn.Embedding(MAX_LEN, hidden)
            layer = nn.TransformerEncoderLayer(
                hidden, 4, 4 * hidden, dropout=0.0, activation="gelu",
                batch_first=True)
            self.transformer = nn.TransformerEncoder(layer, num_layers=2,
                                                     enable_nested_tensor=False)
        self.projection = nn.Linear(hidden, OUT_D)

    def forward(self, x):
        if self.kind in ("lstm", "gru"):
            _, h_n = self.rnn(x)
            h_n = h_n[0] if self.kind == "lstm" else h_n
            return self.projection(h_n[-1])
        if self.kind == "cnn":
            h = x.transpose(1, 2)
            h = torch.relu(self.bn1(self.conv1(h)))
            h = torch.relu(self.bn2(self.conv2(h)))
            return self.projection(h.mean(dim=2))
        h = self.input_proj(x) + self.pos_embedding(torch.arange(x.shape[1]))
        return self.projection(self.transformer(h).mean(dim=1))


class RefVideo(nn.Module):
    """The reference FrameEncoder: frame MLP, attention or mean pool,
    LayerNorm -> Linear."""

    def __init__(self, attention: bool):
        super().__init__()
        self.frame_mlp = nn.Sequential(nn.Linear(VIDEO_D, HID), nn.ReLU())
        if attention:
            self.attention = nn.Linear(HID, 1)
        self.projection = nn.Sequential(nn.LayerNorm(HID), nn.Linear(HID, OUT_D))

    def forward(self, x):
        x = self.frame_mlp(x)
        if hasattr(self, "attention"):
            w = torch.softmax(self.attention(x).squeeze(-1), dim=1)
            pooled = torch.einsum("bt,bth->bh", w, x)
        else:
            pooled = x.mean(dim=1)
        return self.projection(pooled)


class RefModel(nn.Module):
    """The reference LightningModule's layout: ``encoders.<m>`` and the
    concat ``fusion_head`` (Linear -> ReLU -> Linear)."""

    def __init__(self, kind: str, attention: bool):
        super().__init__()
        hidden = TF_HID if kind == "transformer" else HID
        self.encoders = nn.ModuleDict({"audio": RefAudio(kind, hidden),
                                       "video": RefVideo(attention)})
        self.fusion_head = nn.Sequential(nn.Linear(2 * OUT_D, HEAD_H), nn.ReLU(),
                                         nn.Linear(HEAD_H, C))

    def forward(self, audio, video):
        a = self.encoders["audio"](audio)
        v = self.encoders["video"](video)
        return self.fusion_head(torch.cat([a, v], dim=-1))


def _encoder_configs(kind: str, attention: bool):
    return {
        "audio": {"type": "sequence", "input_dim": AUDIO_D, "encoder_type": kind,
                  "hidden_dim": TF_HID if kind == "transformer" else HID,
                  "num_layers": 2, "dropout": 0.0},
        "video": {"type": "frame", "input_dim": VIDEO_D, "hidden_dim": HID,
                  "temporal_pooling": "attention" if attention else "average",
                  "dropout": 0.0},
    }


def _reference(kind: str, attention: bool, seed: int = 0) -> RefModel:
    torch.manual_seed(seed)
    ref = RefModel(kind, attention)
    if kind == "cnn":
        # as after training: running statistics away from (0, 1)
        with torch.no_grad():
            for bn in (ref.encoders["audio"].bn1, ref.encoders["audio"].bn2):
                bn.running_mean.uniform_(-1.0, 1.0)
                bn.running_var.uniform_(0.5, 2.0)
    return ref.eval()


def _inputs(seed: int = 1):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T_A, AUDIO_D).astype(np.float32),
            rng.randn(B, T_V, VIDEO_D).astype(np.float32))


def _port_template(kind: str, attention: bool) -> MultimodalClassifier:
    return MultimodalClassifier(
        modalities=("audio", "video"),
        encoder_configs=_encoder_configs(kind, attention),
        num_classes=C, output_dim=OUT_D, hidden_dim=HEAD_H, dropout=0.0,
    ).eval()


def _jax_route(sd, kind: str, attention: bool, audio, video):
    """JAX's import of ``sd`` onto its own template, as the port's tree."""
    model = JaxMultimodalClassifier(
        modalities=("audio", "video"),
        encoder_configs=_encoder_configs(kind, attention),
        num_classes=C, output_dim=OUT_D, hidden_dim=HEAD_H, dropout=0.0,
    )
    variables = model.init(jax.random.PRNGKey(0),
                           {"audio": jnp.asarray(audio), "video": jnp.asarray(video)})
    np_tree = lambda t: jax.tree.map(np.asarray, dict(t))  # noqa: E731
    params = np_tree(variables["params"])
    if "batch_stats" in variables:
        params, stats = jax_import.import_reference_state_dict(
            sd, params, template_batch_stats=np_tree(variables["batch_stats"]))
        return state_dict_from_jax_params(params, stats)
    return state_dict_from_jax_params(jax_import.import_reference_state_dict(sd, params))


CASES = [
    pytest.param("lstm", True, id="lstm-attention_pool"),
    pytest.param("gru", True, id="gru-attention_pool"),
    pytest.param("cnn", True, id="cnn_batchnorm_stats-attention_pool"),
    pytest.param("transformer", True, id="transformer-attention_pool"),
    pytest.param("lstm", False, id="lstm-mean_pool"),
]


@pytest.mark.parametrize("kind,attention", CASES)
def test_imported_logits_match_the_reference_module(kind, attention):
    ref = _reference(kind, attention)
    audio, video = _inputs()
    with torch.no_grad():
        want = ref(torch.from_numpy(audio), torch.from_numpy(video)).numpy()
    model = _port_template(kind, attention)
    model.load_state_dict(import_reference_state_dict(ref.state_dict(), model),
                          strict=True)
    with torch.no_grad():
        got = model({"audio": torch.from_numpy(audio),
                     "video": torch.from_numpy(video)}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    if kind == "cnn":
        # the statistics are what makes it match: the template's (0, 1)
        # in their place does not
        model.load_state_dict(_port_template(kind, attention).state_dict()
                              | {k: v for k, v in model.state_dict().items()
                                 if "running" not in k})
        with torch.no_grad():
            bad = model({"audio": torch.from_numpy(audio),
                         "video": torch.from_numpy(video)}).numpy()
        assert np.abs(bad - want).max() > 1e-3


@pytest.mark.parametrize("kind,attention", CASES)
def test_imported_state_dict_is_the_jax_route_bit_for_bit(kind, attention):
    ref = _reference(kind, attention, seed=2)
    sd = ref.state_dict()
    audio, video = _inputs()
    port = import_reference_state_dict(sd, _port_template(kind, attention))
    jax_sd = _jax_route({k: v.numpy() for k, v in sd.items()}, kind, attention,
                        audio, video)
    assert sorted(port) == sorted(jax_sd)
    for key, value in port.items():
        assert value.dtype == jax_sd[key].dtype == torch.float32, key
        assert torch.equal(value, jax_sd[key]), key
    if kind == "cnn":
        assert torch.equal(port["audio_encoder.bn2.running_var"],
                           sd["encoders.audio.bn2.running_var"])


def test_import_keeps_the_template_where_the_reference_is_silent():
    # an audio-only reference dict: the video encoder and the head keep
    # the template's values
    ref = _reference("gru", True, seed=3)
    sd = {k: v for k, v in ref.state_dict().items() if k.startswith("encoders.audio.")}
    template = _port_template("gru", True)
    out = import_reference_state_dict(sd, template, modalities=("audio",))
    before = template.state_dict()
    for key, value in out.items():
        if key.startswith("audio_encoder."):
            continue
        assert torch.equal(value, before[key]), key
    assert torch.equal(out["audio_encoder.rnn.layer_1.b_hh"],
                       sd["encoders.audio.rnn.bias_hh_l1"])


def test_import_refuses_a_shape_the_template_does_not_have():
    ref = _reference("lstm", True)
    with pytest.raises(ValueError, match="shape"):
        import_reference_state_dict(ref.state_dict(), MultimodalClassifier(
            modalities=("audio", "video"),
            encoder_configs={**_encoder_configs("lstm", True),
                             "audio": {**_encoder_configs("lstm", True)["audio"],
                                       "hidden_dim": HID + 8}},
            num_classes=C, output_dim=OUT_D, hidden_dim=HEAD_H))


class Hparams:
    """A non-tensor object, as older Lightning checkpoints embed."""

    lr = 1e-3


def test_load_lightning_weights_only_and_allow_pickle(tmp_path):
    ref = _reference("lstm", True)
    sd = ref.state_dict()
    plain = tmp_path / "plain.ckpt"
    torch.save({"state_dict": sd, "epoch": 7}, plain)
    raw = tmp_path / "raw.pt"
    torch.save(sd, raw)
    pickled = tmp_path / "pickled.ckpt"
    torch.save({"state_dict": sd, "hparams": Hparams()}, pickled)

    for loader in (load_lightning_state_dict, jax_import.load_lightning_state_dict):
        for path in (plain, raw):
            got = loader(str(path))
            assert sorted(got) == sorted(sd)
            assert all(torch.equal(got[k], sd[k]) for k in sd)
        with pytest.raises(ValueError, match="allow_pickle=True"):
            loader(str(pickled))
        got = loader(str(pickled), allow_pickle=True)
        assert all(torch.equal(got[k], sd[k]) for k in sd)

    # the checkpoint route: the same dict, from the file
    template = _port_template("lstm", True)
    via_file = import_reference_checkpoint(str(plain), template)
    direct = import_reference_state_dict(sd, template)
    assert all(torch.equal(via_file[k], direct[k]) for k in direct)
    with pytest.raises(ValueError, match="allow_pickle"):
        import_reference_checkpoint(str(pickled), template)
    trusted = import_reference_state_dict(
        load_lightning_state_dict(str(pickled), allow_pickle=True), template)
    assert all(torch.equal(v, direct[k]) for k, v in trusted.items())
