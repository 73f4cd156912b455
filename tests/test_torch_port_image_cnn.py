"""PyTorch port, the image CNN encoder (``type: pretrained_cnn``) and
sequence ``lengths`` into the transformer encoder, on the CPU (every
kernel wrapper runs its plain version) against the JAX package:

* ``ImageCNNEncoder`` at rank 4 and at rank 5 under a frame mask, for
  each temporal pooling, eval mode, to 1e-5 of the largest output; in
  bf16 within 4 bf16 ulps of JAX's jitted encoder;
* the concat classifier with the image encoder on rank-5 frames: a JAX
  tree (with its batch statistics) loads ``strict=True`` and the logits
  agree to 1e-4;
* 1-channel (gray) frames with ``in_channels=1``: the encoder and the
  classifier against JAX's built on them, a ``Trainer.fit``, and the
  refusals of a 3-channel file and of gray frames under 3 channels;
* ``load_pretrained_encoder_weights`` grafting a torchvision-layout file
  bit for bit as JAX's does, with JAX's errors; a ``Trainer.fit`` with
  ``weights_path``: the backbone the file's before the first step, trained
  after;
* MC dropout holds the backbone's running statistics (``bn_eval=True``);
* the train, predict (``--mc-dropout`` too), export and quantize CLIs on
  rank-5 frames;
* the transformer ``SequenceEncoder`` with ``lengths`` at dropout 0,
  within ``max_len`` and on the blockwise fold (a fully padded block
  keeps its sentinel key), on JAX's XLA and flash (interpret) routes:
  outputs 1e-4 of the largest, and the parameters' gradients through the
  key bias; in bf16 within 4 ulps; an LSTM or GRU given ``lengths``
  raises, naming ROADMAP items 3 / 6.

TF32 is off on the torch side and JAX computes at matmul precision
highest."""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.config import load_config as jax_load_config
from multimodal_emotion_detection_tpu.models.classifier import (
    classifier_from_config as jax_classifier_from_config,
)
from multimodal_emotion_detection_tpu.models.classifier import (
    load_pretrained_encoder_weights as jax_load_pretrained_encoder_weights,
)
from multimodal_emotion_detection_tpu.models.encoders import (
    ImageCNNEncoder as JaxImageCNNEncoder,
)
from multimodal_emotion_detection_tpu.models.encoders import (
    SequenceEncoder as JaxSequenceEncoder,
)
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.data.loader import create_dataloaders
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
    init_weights,
    load_pretrained_encoder_weights,
)
from multimodal_emotion_detection_tpu_torch.models.encoders import (
    ImageCNNEncoder,
    SequenceEncoder,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.tools import export as port_export
from multimodal_emotion_detection_tpu_torch.tools import predict as port_predict
from multimodal_emotion_detection_tpu_torch.tools import quantize as port_quantize
from multimodal_emotion_detection_tpu_torch.training.checkpoints import load_checkpoint
from multimodal_emotion_detection_tpu_torch.training.loop import Trainer
from multimodal_emotion_detection_tpu_torch.training.steps import forward
from multimodal_emotion_detection_tpu_torch.uncertainty.mc_dropout import (
    mc_dropout_predict,
)
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

from test_torch_port_resnet import _stats_like, _torchvision_mapping

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "base.yaml")
ULP = 2.0 ** -8
POOLINGS = ("attention", "average", "max")
# the flagship narrowed as the float32 files narrow it, with the image
# encoder on the video
NARROW = ["model.frontend.audio=logmel", "model.encoders.audio.hidden_dim=128",
          "model.encoders.video.type=pretrained_cnn", "model.output_dim=16",
          "model.hidden_dim=32"]
SAMPLES, FRAMES, HW = 40 * 128, 2, 16
SIZES = {"train": 16, "val": 8, "test": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these small
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()
                 / np.abs(np.asarray(want, np.float32)).max())


def _frames(b, t=FRAMES, hw=HW, seed=0, channels=3):
    shape = (b, hw, hw, channels) if t is None else (b, t, hw, hw, channels)
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _jax_encoder(pooling, frames, dtype=jnp.float32):
    jenc = JaxImageCNNEncoder(backbone="resnet18", output_dim=16,
                              temporal_pooling=pooling, dropout=0.1, dtype=dtype)
    variables = jax.jit(lambda k: jenc.init(k, jnp.asarray(frames)))(jax.random.PRNGKey(1))
    # running statistics away from init, so eval mode reads them
    stats = _stats_like(_np(variables["batch_stats"]), np.random.RandomState(2))
    return jenc, {"params": _np(variables["params"]), "batch_stats": stats}


def _port_encoder(pooling, variables, rank, dtype=torch.float32, channels=3):
    enc = ImageCNNEncoder("resnet18", 16, pooling, 0.1, dtype=dtype, in_channels=channels)
    state = state_dict_from_jax_params(variables["params"], variables["batch_stats"])
    missing, unexpected = enc.load_state_dict(state, strict=False)
    # an attention pool's parameters exist in the JAX tree only when it was
    # built on frames
    assert not unexpected
    assert missing == ([] if rank == 5 or pooling != "attention"
                       else ["pool.attention.weight", "pool.attention.bias"])
    return enc.eval()


@pytest.mark.parametrize("pooling", POOLINGS)
@pytest.mark.parametrize("rank", [4, 5])
def test_encoder_matches_jax(rank, pooling):
    frames = _frames(3, None if rank == 4 else 4)
    mask = np.array([[1, 1, 0, 1], [1, 0, 0, 0], [1, 1, 1, 1]], np.float32)
    jenc, variables = _jax_encoder(pooling, frames)
    jmask = None if rank == 4 else jnp.asarray(mask)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jenc.apply(variables, jnp.asarray(frames), jmask))
    enc = _port_encoder(pooling, variables, rank)
    with torch.no_grad():
        got = enc(torch.from_numpy(frames), None if rank == 4 else torch.from_numpy(mask))
    assert got.shape == (3, 16)
    assert _rel(got.numpy(), want) <= 1e-5
    if rank == 5:
        # the mask reaches the pooling
        with jax.default_matmul_precision("highest"):
            unmasked = np.asarray(jenc.apply(variables, jnp.asarray(frames)))
        assert _rel(unmasked, want) > 1e-3


@pytest.mark.parametrize("pooling", ["attention", "max"])
def test_encoder_bf16_within_4_ulps(pooling):
    frames = _frames(3, 4, hw=32)
    mask = np.array([[1, 1, 0, 1], [1, 0, 0, 0], [1, 1, 1, 1]], np.float32)
    jenc, variables = _jax_encoder(pooling, frames, jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jenc.apply)(variables, jnp.asarray(frames),
                                               jnp.asarray(mask)).astype(jnp.float32))
    enc = _port_encoder(pooling, variables, 5, torch.bfloat16)
    with torch.no_grad():
        got = enc(torch.from_numpy(frames), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) / ULP <= 4.0


def test_encoder_refuses_other_ranks_as_jax():
    enc = ImageCNNEncoder().eval()
    with pytest.raises(ValueError, match=r"Expected rank-4/5 frames, got shape \(2, 3, 8\)"):
        enc(torch.zeros(2, 3, 8))
    with pytest.raises(ValueError, match="3 channels last"):
        enc(torch.zeros(2, 4, 16, 16, 1))


def _split(n, seed, channels=3):
    rng = np.random.RandomState(seed)
    return ({"audio": rng.randn(n, SAMPLES, 1).astype(np.float32),
             "video": rng.rand(n, FRAMES, HW, HW, channels).astype(np.float32)},
            rng.randint(0, 8, n).astype(np.int32))


def test_classifier_logits_match_jax():
    jmodel = jax_classifier_from_config(jax_load_config(CONFIG, NARROW))
    feats, _ = _split(2, 0)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    mask = jnp.ones((2, 2), jnp.float32)
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(3), jfeats, mask)
        ref = np.asarray(jmodel.apply(variables, jfeats, mask, deterministic=True))
    model = classifier_from_config(load_config(CONFIG, NARROW))
    state = state_dict_from_jax_params(_np(variables["params"]),
                                       _np(variables["batch_stats"]))
    assert "video_encoder.backbone.stage3_block1.bn2.running_var" in state
    model.load_state_dict(state)  # strict: every key of both trees
    logits = forward(model, {k: torch.from_numpy(v) for k, v in feats.items()})
    assert logits.shape == (2, 8)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("resnet_weights") / "resnet18.pth"
    torch.save(_torchvision_mapping("resnet18", 11), path)
    return path


def test_graft_matches_jax_and_raises_its_errors(weights_file):
    cfg = load_config(CONFIG, NARROW + [f"model.encoders.video.weights_path={weights_file}"])
    jcfg = jax_load_config(CONFIG, NARROW + [f"model.encoders.video.weights_path={weights_file}"])
    jmodel = jax_classifier_from_config(jcfg)
    feats, _ = _split(2, 0)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = jmodel.init(jax.random.PRNGKey(3), jfeats, jnp.ones((2, 2)))
    params, model_state = jax_load_pretrained_encoder_weights(
        variables["params"], {"batch_stats": variables["batch_stats"]}, jcfg.model.encoders)
    want = state_dict_from_jax_params(_np(params), _np(model_state["batch_stats"]))
    model = classifier_from_config(cfg)
    model.load_state_dict(state_dict_from_jax_params(_np(variables["params"]),
                                                     _np(variables["batch_stats"])))
    before = copy.deepcopy(model.state_dict())
    assert load_pretrained_encoder_weights(model, cfg.model.encoders) is model
    after = model.state_dict()
    for key, value in want.items():
        torch.testing.assert_close(after[key], value, rtol=0, atol=0, msg=key)
        # what the graft leaves alone is untouched
        if not key.startswith("video_encoder.backbone."):
            assert torch.equal(after[key], before[key])
    torch.testing.assert_close(after["video_encoder.backbone.stem_conv.weight"],
                               torch.load(weights_file)["conv1.weight"], rtol=0, atol=0)

    other = load_config(CONFIG, NARROW)
    other.model.encoders["audio"]["weights_path"] = str(weights_file)
    with pytest.raises(ValueError, match=r"requires type='pretrained_cnn', got 'sequence'"):
        load_pretrained_encoder_weights(model, other.model.encoders)
    lone = {"frames": {"type": "pretrained_cnn", "weights_path": str(weights_file)}}
    with pytest.raises(ValueError, match="No initialized backbone for modality 'frames'"):
        load_pretrained_encoder_weights(model, lone)


def _write_splits(root, channels=3):
    for seed, (split, n) in enumerate(SIZES.items()):
        feats, labels = _split(n, 10 + seed, channels)
        d = root / split
        d.mkdir(parents=True)
        for name, arr in feats.items():
            np.save(d / f"{name}.npy", arr)
        np.save(d / "labels.npy", labels)
    return root


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return _write_splits(tmp_path_factory.mktemp("image_cnn_data"))


def _overrides(data_dir, save_dir, *extra):
    return NARROW + [f"dataset.data_dir={data_dir}", f"experiment.save_dir={save_dir}",
                     "experiment.name=run", "dataset.batch_size=8", "training.max_epochs=2",
                     "runtime.platform=cpu", *extra]


def test_trainer_fit_with_weights_path(data_dir, weights_file, tmp_path):
    """As ``tests/test_torch_parity.py::test_pretrained_weights_path_trains_
    end_to_end`` holds the JAX trainer: the file's weights are in the
    model before the first step, and the steps move them."""
    sd = torch.load(weights_file)
    cfg = load_config(CONFIG, _overrides(data_dir, tmp_path, "model.encoders.video."
                                         f"weights_path={weights_file}"))
    trainer = Trainer(cfg, save_dir=tmp_path / "run")
    train_loader, val_loader, _ = create_dataloaders(
        cfg.dataset.name, cfg.dataset.data_dir, cfg.dataset.modalities,
        batch_size=cfg.dataset.batch_size, seed=cfg.seed)
    trainer._build(train_loader)
    backbone = trainer.model.video_encoder.backbone
    assert torch.equal(backbone.stem_conv.weight, sd["conv1.weight"])
    assert torch.equal(backbone.stem_bn.running_var, sd["bn1.running_var"])
    trainer.fit(train_loader, val_loader)
    assert trainer.step == 4
    drift = float((backbone.stem_conv.weight.detach() - sd["conv1.weight"]).abs().max())
    assert 0 < drift < 4 * 2.2e-3  # Adam moves a weight by about lr a step
    moved = float((backbone.stem_bn.running_var - sd["bn1.running_var"]).abs().max())
    assert 0 < moved < 0.5  # the grafted statistics, averaged toward the batches'
    assert all(np.isfinite(r["val/loss"]) for r in trainer.history if "val/loss" in r)


@pytest.mark.parametrize("rank", [4, 5])
def test_gray_frames_match_jax(rank):
    """One channel: flax takes the stem's channel count from the first
    input, the port from ``in_channels``."""
    frames = _frames(3, None if rank == 4 else 4, channels=1)
    mask = np.array([[1, 1, 0, 1], [1, 0, 0, 0], [1, 1, 1, 1]], np.float32)
    jenc, variables = _jax_encoder("average", frames)
    assert variables["params"]["backbone"]["stem_conv"]["kernel"].shape == (7, 7, 1, 64)
    jmask = None if rank == 4 else jnp.asarray(mask)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jenc.apply(variables, jnp.asarray(frames), jmask))
    enc = _port_encoder("average", variables, rank, channels=1)
    with torch.no_grad():
        got = enc(torch.from_numpy(frames), None if rank == 4 else torch.from_numpy(mask))
    assert _rel(got.numpy(), want) <= 1e-5


def test_gray_frames_train_and_refuse_a_3_channel_graft(tmp_path, weights_file):
    """The classifier on 1-channel rank-5 frames: a JAX tree made on them
    loads strict and the logits agree; the trainer trains on them with
    ``in_channels=1`` as JAX's does without it; a torchvision file (3
    channels) and gray frames under the default 3 channels raise."""
    gray = NARROW + ["model.encoders.video.in_channels=1"]
    jmodel = jax_classifier_from_config(jax_load_config(CONFIG, gray))
    feats, _ = _split(2, 0, channels=1)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    mask = jnp.ones((2, 2), jnp.float32)
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(3), jfeats, mask)
        ref = np.asarray(jmodel.apply(variables, jfeats, mask, deterministic=True))
    model = classifier_from_config(load_config(CONFIG, gray))
    model.load_state_dict(state_dict_from_jax_params(_np(variables["params"]),
                                                     _np(variables["batch_stats"])))
    logits = forward(model, {k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4, atol=1e-4)

    data = _write_splits(tmp_path / "gray", channels=1)
    cfg = load_config(CONFIG, _overrides(data, tmp_path, "model.encoders.video.in_channels=1"))
    trainer = Trainer(cfg, save_dir=tmp_path / "run")
    train_loader, val_loader, _ = create_dataloaders(
        cfg.dataset.name, cfg.dataset.data_dir, cfg.dataset.modalities,
        batch_size=cfg.dataset.batch_size, seed=cfg.seed)
    trainer._build(train_loader)
    start = trainer.model.video_encoder.backbone.stem_conv.weight.detach().clone()
    assert start.shape == (64, 1, 7, 7)
    trainer.fit(train_loader, val_loader)
    assert trainer.step == 4
    assert not torch.equal(trainer.model.video_encoder.backbone.stem_conv.weight, start)
    assert all(np.isfinite(r["val/loss"]) for r in trainer.history if "val/loss" in r)

    grafted = load_config(CONFIG, gray + [f"model.encoders.video.weights_path={weights_file}"])
    with pytest.raises(ValueError, match="holds a stem of 3 channels; the backbone takes 1"):
        load_pretrained_encoder_weights(classifier_from_config(grafted),
                                        grafted.model.encoders)
    rgb = classifier_from_config(load_config(CONFIG, NARROW))
    with pytest.raises(ValueError, match=r"takes 3 channels last \(model.encoders"):
        forward(rgb, {k: torch.from_numpy(v) for k, v in feats.items()})


def test_mc_dropout_keeps_the_backbone_statistics():
    cfg = load_config(CONFIG, NARROW)
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(0))
    feats = {k: torch.from_numpy(v) for k, v in _split(2, 5)[0].items()}
    before = {k: b.clone() for k, b in model.named_buffers()}
    noise = Noise(torch.Generator().manual_seed(1))
    mean, unc = mc_dropout_predict(model, feats, 3, noise=noise)
    assert all(torch.equal(b, before[k]) for k, b in model.named_buffers())
    assert mean.shape == (2, 8) and unc.shape == (2,) and float(unc.max()) > 0
    # the fold is a training-mode forward on the running statistics
    fold = {k: v.repeat((3,) + (1,) * (v.ndim - 1)) for k, v in feats.items()}
    model.train()
    with torch.no_grad():
        logits = model(fold, torch.ones(6, 2), noise=Noise(replay=noise.drawn), bn_eval=True)
    torch.testing.assert_close(logits.reshape(3, 2, -1).mean(dim=0), mean, rtol=0, atol=1e-6)


def test_clis_on_rank5_frames(data_dir, weights_file, tmp_path):
    over = _overrides(data_dir, tmp_path, f"model.encoders.video.weights_path={weights_file}")
    results = port_train.main(["--config", CONFIG, *over])
    assert all(np.isfinite(v) for v in results.values())
    best = tmp_path / "run" / "best.ckpt"
    state, _ = load_checkpoint(best)
    assert "video_encoder.backbone.stage3_block1.bn2.running_mean" in state
    base = ["--checkpoint", str(best), "--config", CONFIG]
    port_predict.main([*base, "--out", str(tmp_path / "p"), *over])
    logits = np.load(tmp_path / "p" / "logits.npy")
    assert logits.shape == (SIZES["test"], 8) and np.isfinite(logits).all()
    # the served logits are the checkpoint's eval forward
    cfg = load_config(CONFIG, over)
    model = classifier_from_config(cfg)
    model.load_state_dict(state)
    test = {m: torch.from_numpy(np.load(data_dir / "test" / f"{m}.npy"))
            for m in ("audio", "video")}
    np.testing.assert_allclose(logits, forward(model, test).numpy(), rtol=0, atol=1e-5)

    port_predict.main([*base, "--mc-dropout", "3", "--out", str(tmp_path / "mc"), *over])
    unc = np.load(tmp_path / "mc" / "uncertainty.npy")
    assert unc.shape == (SIZES["test"],) and np.isfinite(unc).all() and unc.max() > 0

    # the exported program takes the (B, T, H, W, 3) frames as they are
    out = port_export.main([*base, "--out", str(tmp_path / "m.pt2"), "--batch", "4", *over])
    program = port_export.load_exported(out).module()
    clips = {k: v[:4] for k, v in test.items()}
    with torch.inference_mode():
        served = program(clips)
    np.testing.assert_allclose(served.numpy(), logits[:4], rtol=0, atol=1e-5)

    # int8 serving: the conv kernels quantize per output channel
    stats = port_quantize.main([*base, "--out", str(tmp_path / "q.pt"), *over])
    assert stats["bytes_quantized"] < stats["bytes_f32"] / 3
    port_predict.main([*base, "--quantized-artifact", str(tmp_path / "q.pt"),
                       "--out", str(tmp_path / "qp"), *over])
    port_predict.main([*base, "--quantize-weights", "int8", "--out", str(tmp_path / "qi"),
                       *over])
    np.testing.assert_array_equal(np.load(tmp_path / "qp" / "logits.npy"),
                                  np.load(tmp_path / "qi" / "logits.npy"))
    metrics = json.loads((tmp_path / "qp" / "metrics.json").read_text())
    assert np.isfinite(metrics["accuracy"])


# --------------------------------------------------------------- lengths

ROUTES = pytest.mark.parametrize("use_flash", [False, True],
                                 ids=["jax_xla_mha", "jax_flash_interpret"])
# within max_len 16, and 37 steps folded into blocks of 8 where the second
# row's length 13 leaves its last three blocks fully padded
LENGTHS = pytest.mark.parametrize("seq_len,lengths", [(12, (12, 5)), (37, (37, 13))],
                                  ids=["within_max_len", "blockwise"])
KW = dict(input_dim=8, hidden_dim=32, output_dim=16, num_layers=2, dropout=0.0)


def _jax_sequence(seq_len, lengths, use_flash, dtype=jnp.float32):
    x = np.random.RandomState(seq_len).randn(2, seq_len, 8).astype(np.float32)
    jenc = JaxSequenceEncoder(**KW, encoder_type="transformer", max_len=16,
                              attention_block=8, use_flash=use_flash,
                              flash_interpret=True, dtype=dtype)
    variables = jenc.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(lengths))
    return jenc, variables, x


def _port_sequence(variables, dtype=torch.float32):
    enc = SequenceEncoder(**KW, encoder_type="transformer", max_len=16, attention_block=8,
                          dtype=dtype)
    enc.load_state_dict(state_dict_from_jax_params(_np(variables["params"])))
    return enc.eval()


@ROUTES
@LENGTHS
def test_transformer_lengths_match_jax(use_flash, seq_len, lengths):
    jenc, variables, x = _jax_sequence(seq_len, lengths, use_flash)
    lens = jnp.asarray(lengths)
    w = np.random.RandomState(3).randn(2, 16).astype(np.float32)

    def loss(params):
        out = jenc.apply({"params": params}, jnp.asarray(x), lens)
        return jnp.sum(out * w), out

    with jax.default_matmul_precision("highest"):
        (_, want), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
        full = np.asarray(jenc.apply(variables, jnp.asarray(x)))
    enc = _port_sequence(variables)
    got = enc(torch.from_numpy(x), lengths=torch.tensor(lengths))
    assert _rel(got.detach().numpy(), want) <= 1e-4
    # the lengths change the output (the padded steps are masked out)
    assert _rel(full, want) > 1e-3
    torch.sum(got * torch.from_numpy(w)).backward()
    want_g = state_dict_from_jax_params(_np(grads))
    g_max = max(float(g.abs().max()) for g in want_g.values())
    worst = max(float((p.grad - want_g[k]).abs().max()) for k, p in enc.named_parameters())
    assert worst / g_max <= 1e-4


@LENGTHS
def test_transformer_lengths_bf16_within_4_ulps(seq_len, lengths):
    jenc, variables, x = _jax_sequence(seq_len, lengths, True, jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jenc.apply(variables, jnp.asarray(x), jnp.asarray(lengths))
                          .astype(jnp.float32))
    enc = _port_sequence(variables, torch.bfloat16)
    with torch.no_grad():
        got = enc(torch.from_numpy(x), lengths=torch.tensor(lengths))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) / ULP <= 4.0


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_recurrent_lengths_raise_naming_items_3_and_6(cell):
    enc = SequenceEncoder(8, 16, 8, encoder_type=cell)
    with pytest.raises(NotImplementedError, match="items 3 / 6"):
        enc(torch.zeros(2, 5, 8), lengths=torch.tensor([5, 3]))
