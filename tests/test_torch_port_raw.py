"""PyTorch port, ``configs/base.yaml`` as written: the raw waveform
(``frontend.audio: "raw"``, audio ``input_dim: 1``) into the recurrent
encoder, past the 2,048 steps where the JAX package's ``SequenceEncoder``
takes the layerwise ``StackedRNN`` (one scan a layer, remat'd chunks of
512 steps, padded steps passing the carry through).

The port runs every T through ``FusedStackedRNN`` on the same parameter
tree.  At T = 2,561 (five JAX chunks of 512 and one step, so JAX's padded
chunk runs), inputs and weights from numpy seeds, JAX at matmul precision
"highest": the encoder's eval output (atol 1e-5) and its train-mode
gradients at dropout 0 (1e-4 of the largest entry, ``ops/envelope.py``'s
``INTERPRET_STRICT_ATOL`` reasoning) for a 2-layer LSTM and GRU (the pair
route) and a 3-layer LSTM (the layered route); the ``base.yaml`` model's
logits at its full widths (1e-4, the classifier tests' bound); the train
CLI and the predict CLI on ``base.yaml`` narrowed, on the CPU, where every
kernel wrapper runs its plain version; and the residual budget that
refuses, on the card, a stack whose full-length residuals do not fit.
"""

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
from multimodal_emotion_detection_tpu.models.encoders import (
    SequenceEncoder as JaxSequenceEncoder,
)
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.models.encoders import SequenceEncoder
from multimodal_emotion_detection_tpu_torch.ops import (
    _build,
    flash_attention,
    logmel,
    lstm_kernel,
    lstm_vjp,
)
from multimodal_emotion_detection_tpu_torch.tools.predict import (
    main as port_predict,
)
from multimodal_emotion_detection_tpu_torch.training.steps import forward
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "base.yaml")
T_RAW = 2561  # past JAX's 2,048: five chunks of 512 and a padded one
B = 2
# every kernel wrapper's launch counter
COUNTERS = [k for m in (logmel, lstm_kernel, flash_attention)
            for k in vars(m).values() if isinstance(k, _build.CudaKernel)]
# base.yaml narrowed for the CLIs (audio H 256 -> 16, video 4096 -> 16
# features, hidden and output widths cut); the frontend stays raw
NARROW = [
    "model.encoders.audio.hidden_dim=16",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these small
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _encoders(cell, layers, hidden=16, out=8):
    """The JAX ``SequenceEncoder`` with its variables (initialised on a
    short sequence: no parameter depends on T) and the port's with the
    JAX tree loaded ``strict=True``, after checking the tree maps key for
    key."""
    jmod = JaxSequenceEncoder(input_dim=1, hidden_dim=hidden, output_dim=out,
                              num_layers=layers, encoder_type=cell, dropout=0.0)
    variables = jmod.init(jax.random.PRNGKey(7), jnp.zeros((B, 8, 1), jnp.float32))
    state = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    model = SequenceEncoder(1, hidden, out, num_layers=layers, dropout=0.0,
                            encoder_type=cell)
    assert sorted(state) == sorted(model.state_dict())
    model.load_state_dict(state)
    return jmod, variables, model


def _wave(seed, n=B, t=T_RAW):
    return np.random.RandomState(seed).randn(n, t, 1).astype(np.float32)


CASES = [("lstm", 2), ("gru", 2), ("lstm", 3)]
IDS = ["lstm2_pair", "gru2_pair", "lstm3_layered"]


@pytest.mark.parametrize("cell,layers", CASES, ids=IDS)
def test_eval_output_matches_stacked_rnn(cell, layers):
    jmod, variables, model = _encoders(cell, layers)
    x = _wave(1)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmod.apply(variables, jnp.asarray(x), deterministic=True))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x))
    assert out.shape == ref.shape == (B, 8)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cell,layers", CASES, ids=IDS)
def test_train_gradients_match_stacked_rnn(cell, layers):
    jmod, variables, model = _encoders(cell, layers)
    x = _wave(2)
    probe = np.random.RandomState(3).randn(B, 8).astype(np.float32)

    def loss(params):
        out = jmod.apply({"params": params}, jnp.asarray(x), deterministic=False)
        return jnp.sum(out * probe)

    with jax.default_matmul_precision("highest"):
        want = state_dict_from_jax_params(jax.tree_util.tree_map(
            np.asarray, jax.grad(loss)(variables["params"])))
    model.train()
    (model(torch.from_numpy(x)) * torch.from_numpy(probe)).sum().backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    largest = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        err = float((got[k] - g).abs().max())
        assert err <= 1e-4 * largest, f"{k}: {err:.3e} of largest {largest:.3e}"


def test_base_yaml_logits_match_jax_at_full_width():
    """The config as written: raw (B, T, 1) audio, LSTM 2x256 -> Dense 128,
    the FrameEncoder over 24 frames of 4096, the concat head."""
    rng = np.random.RandomState(4)
    feats = {"audio": _wave(5),
             "video": rng.rand(B, 24, 4096).astype(np.float32)}
    jmodel = jax_classifier_from_config(jax_load_config(CONFIG, []))
    mask = jnp.ones((B, 2), jnp.float32)
    short = {"audio": jnp.zeros((B, 8, 1)), "video": jnp.asarray(feats["video"])}
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(3), short, mask)
        ref = np.asarray(jmodel.apply(
            variables, {k: jnp.asarray(v) for k, v in feats.items()}, mask,
            deterministic=True))
    cfg = load_config(CONFIG, [])
    assert cfg.model.frontend.audio == "raw"
    assert cfg.model.encoders["audio"]["input_dim"] == 1
    model = classifier_from_config(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    assert model.audio_encoder.rnn.layer_1.w_hh.shape == (256, 1024)
    logits = forward(model, {k: torch.from_numpy(v) for k, v in feats.items()})
    assert logits.shape == (B, 8)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_train_cli_then_predict_on_raw_waveform(tmp_path, cell):
    sizes = {"train": 8, "val": 4, "test": 4}  # 2 / 1 / 1 batches of 4
    data = tmp_path / "data"
    for seed, (split, n) in enumerate(sizes.items()):
        rng = np.random.RandomState(20 + seed)
        (data / split).mkdir(parents=True)
        np.save(data / split / "audio.npy", _wave(30 + seed, n))
        np.save(data / split / "video.npy", rng.rand(n, 4, 16).astype(np.float32))
        np.save(data / split / "labels.npy", rng.randint(0, 8, n).astype(np.int32))
    overrides = NARROW + [
        f"model.encoders.audio.encoder_type={cell}", "dataset.batch_size=4",
        "training.max_epochs=2", "runtime.platform=cpu", f"dataset.data_dir={data}",
        f"experiment.save_dir={tmp_path}", "experiment.name=raw"]
    for c in COUNTERS:
        c.launches = 0
    results = port_train.main(["--config", CONFIG, *overrides])
    run = tmp_path / "raw"
    for rel in ("results.json", "best.ckpt", "checkpoints/last.ckpt",
                "confusion_matrix.npy", "csv_logs/version_0/metrics.csv"):
        assert (run / rel).exists(), rel
    assert all(np.isfinite(v) for v in results.values())
    metrics = port_predict(["--checkpoint", str(run / "best.ckpt"), "--config",
                            CONFIG, "--out", str(tmp_path / "preds"), *overrides])
    logits = np.load(tmp_path / "preds" / "logits.npy")
    assert logits.shape == (sizes["test"], 8) and np.isfinite(logits).all()
    assert metrics["split"] == "test"
    assert [c.launches for c in COUNTERS] == [0] * len(COUNTERS)  # CPU tensors


GB = 1e9
T48K = 48000


@pytest.mark.parametrize("cell,layers,hidden,route,remat,gb", [
    # base.yaml at b32: packed 10H 15.73 + h0p / h1p / x1 4.72 + keep 1.57
    # + dg0 / dg1 12.58 + x 0.006
    ("lstm", 2, 256, "pair", False, 34.61),
    ("lstm", 2, 256, "pair", True, 22.05),  # packed 2H
    ("gru", 2, 256, "pair", False, 31.46),  # packed 8H, dih / dhn 8H
    # the big sweep config on raw: three layers' 6H, two inputs, two keep
    # masks, and the backward's two chain outputs and hop (9H)
    ("lstm", 3, 512, "layered", False, 97.52),
    ("gru", 3, 512, "layered", False, 88.09),
    ("lstm", 2, 256, "legacy", False, 56.63),
], ids=["base_lstm", "base_lstm_remat", "base_gru", "big_lstm", "big_gru",
        "base_lstm_legacy"])
def test_residual_bytes_at_raw_length(cell, layers, hidden, route, remat, gb):
    got = lstm_vjp.stack_residual_bytes(cell, layers, hidden, 1, 32, T48K, route,
                                        remat_gates=remat)
    assert abs(got / GB - gb) < 0.01
    # what the stack holds scales with the steps and the batch
    assert lstm_vjp.stack_residual_bytes(
        cell, layers, hidden, 1, 16, T48K // 2, route, remat_gates=remat) * 4 == got


def test_big_config_on_raw_refused_naming_item_17():
    args = ("lstm", 3, 512, 1, 32, T48K, "layered")
    with pytest.raises(NotImplementedError, match="item 17"):
        lstm_vjp.check_residual_budget(*args, free_bytes=int(80 * GB))
    # base.yaml's pair fits the same card; the caller's keep mask is held
    lstm_vjp.check_residual_budget("lstm", 2, 256, 1, 32, T48K, "pair",
                                   free_bytes=int(80 * GB), held=4 * T48K * 32 * 256)
    with pytest.raises(NotImplementedError, match="item 17"):
        lstm_vjp.check_residual_budget("gru", 2, 256, 1, 32, T48K, "pair",
                                       free_bytes=int(30 * GB))


def test_cpu_tensors_take_no_budget_check(monkeypatch):
    """The budget is the card's: a CPU tensor past 2,048 steps trains as
    before, and the check is never consulted."""
    def never(*args, **kwargs):
        raise AssertionError("the residual budget was checked for a CPU tensor")

    monkeypatch.setattr(lstm_vjp, "check_residual_budget", never)
    rng = np.random.RandomState(6)
    h, t = 4, lstm_vjp.LONG_T + 3
    layers = [{k: torch.from_numpy(rng.uniform(-0.5, 0.5, s).astype(np.float32))
               .requires_grad_() for k, s in (("w_ih", (1 if i == 0 else h, 4 * h)),
                                              ("w_hh", (h, 4 * h)), ("b", (4 * h,)))}
              for i in range(2)]
    x = torch.from_numpy(_wave(7, 1, t))
    out = lstm_vjp.fused_lstm_final(x, torch.ones(t, 1, 1, h), layers)
    out.sum().backward()
    assert out.shape == (1, h) and all(p.grad is not None for p in layers[0].values())
