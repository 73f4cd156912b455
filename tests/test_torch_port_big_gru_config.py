"""PyTorch port, the big sweep config with the GRU audio encoder (GRU 3
layers, the layered route) at a narrow width: classifier logits against
the JAX package with the JAX weights carried across by
``state_dict_from_jax_params`` (a 3-layer GRU tree loads ``strict=True``),
a 5-step train-step trajectory against JAX ``make_train_step`` with
dropout rates 0, the train CLI then the predict CLI on its ``best.ckpt``
on the CPU (``runtime.platform=cpu``, where every kernel wrapper runs its
plain version); and the recurrent encoders the JAX package runs through
its layerwise ``StackedRNN`` (depth 1, ``fused: false``), whose trees load
``strict=True`` too.  Tolerance 1e-4, as the flagship's tests
(``ops/envelope.py``'s ``INTERPRET_STRICT_ATOL``)."""

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
from multimodal_emotion_detection_tpu.ops.lstm_vjp import (
    set_bwd_kernel_mode,
    set_fwd_kernel_mode,
)
from multimodal_emotion_detection_tpu.training import optim as jax_optim
from multimodal_emotion_detection_tpu.training.steps import (
    create_train_state,
    make_train_step,
)
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.config import load_config
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.ops import logmel, lstm_kernel
from multimodal_emotion_detection_tpu_torch.tools.predict import (
    main as port_predict,
)
from multimodal_emotion_detection_tpu_torch.training import optim
from multimodal_emotion_detection_tpu_torch.training.steps import (
    forward,
    train_step,
)
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "base.yaml")
# the big sweep config's depth with the GRU encoder; widths narrowed (H 512
# -> 128, output 256 -> 16, head 512 -> 32, video 512 -> 32) and ~37
# log-mel frames per clip
BIG_GRU_NARROW = [
    "model.frontend.audio=logmel",
    "model.encoders.audio.encoder_type=gru",
    "model.encoders.audio.num_layers=3",
    "model.encoders.audio.hidden_dim=128",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
]
NO_DROPOUT = [
    "model.encoders.audio.dropout=0.0",
    "model.encoders.video.dropout=0.0",
    "training.augmentation.modality_dropout=0.0",
    "runtime.lstm_kernels=off",
]
B, SAMPLES, FRAMES, FRAME_DIM = 8, 40 * 128, 4, 16
# the attention pool's score bias: softmax over time does not see it
SHIFT_INVARIANT = "video_encoder.pool.attention.bias"
COUNTERS = (logmel.LOGMEL, lstm_kernel.GRU1_TRAIN_FWD, lstm_kernel.GRU1_INFER,
            lstm_kernel.GRU_BWD_CHAIN, lstm_kernel.GRU2_INFER,
            lstm_kernel.GRU2_TRAIN_FWD, lstm_kernel.GRU2_BWD_CHAIN)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split(n, seed):
    rng = np.random.RandomState(seed)
    return ({"audio": rng.randn(n, SAMPLES, 1).astype(np.float32),
             "video": rng.rand(n, FRAMES, FRAME_DIM).astype(np.float32)},
            rng.randint(0, 8, n).astype(np.int32))


def _logits_against_jax(overrides, key):
    """Eval logits of the port and of the JAX package on one batch, the
    JAX tree loaded into the port ``strict=True``; ``key`` must be in it."""
    jmodel = jax_classifier_from_config(jax_load_config(CONFIG, overrides))
    feats, _ = _split(B, 0)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    mask = jnp.ones((B, 2), jnp.float32)
    with jax.default_matmul_precision("highest"):
        variables = jmodel.init(jax.random.PRNGKey(3), jfeats, mask)
        ref = np.asarray(jmodel.apply(variables, jfeats, mask, deterministic=True))
    model = classifier_from_config(load_config(CONFIG, overrides))
    state = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    assert key in state
    model.load_state_dict(state)  # strict: every key of both trees
    logits = forward(model, {k: torch.from_numpy(v) for k, v in feats.items()})
    assert logits.shape == (B, 8)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_classifier_logits_match_jax():
    _logits_against_jax(BIG_GRU_NARROW, "audio_encoder.rnn.layer_2.b_hh")


# JAX's SequenceEncoder takes StackedRNN (one scan per layer) at depth 1 and
# with fused: false; the parameter tree is FusedStackedRNN's
@pytest.mark.parametrize("cell,extra", [
    ("lstm", ["model.encoders.audio.num_layers=1"]),
    ("gru", ["model.encoders.audio.num_layers=1"]),
    ("lstm", ["model.encoders.audio.fused=false"]),
    ("gru", ["model.encoders.audio.fused=false", "model.encoders.audio.num_layers=3"]),
], ids=["lstm_depth1", "gru_depth1", "lstm_fused_false", "gru3_fused_false"])
def test_stacked_rnn_encoders_match_jax(cell, extra):
    overrides = [*BIG_GRU_NARROW[:1], f"model.encoders.audio.encoder_type={cell}",
                 *BIG_GRU_NARROW[3:], *extra]
    depth = load_config(CONFIG, overrides).model.encoders["audio"]["num_layers"]
    bias = "b_hh" if cell == "gru" else "b"
    _logits_against_jax(overrides, f"audio_encoder.rnn.layer_{depth - 1}.{bias}")


def test_train_step_trajectory_matches_jax():
    overrides = BIG_GRU_NARROW + NO_DROPOUT
    feats, labels = _split(20, 1)
    rng = np.random.RandomState(2)
    idx = [rng.randint(0, 20, B).astype(np.int32) for _ in range(5)]
    valid = [np.ones(B, np.float32)] * 4 + [np.array([1] * 5 + [0] * 3, np.float32)]

    jcfg = jax_load_config(CONFIG, overrides)
    jmodel = jax_classifier_from_config(jcfg)
    tx, _ = jax_optim.build_optimizer(jcfg.training, 3)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    prev_f, prev_b = set_fwd_kernel_mode("off"), set_bwd_kernel_mode("off")
    try:
        with jax.default_matmul_precision("highest"):
            sample = {k: v[:B] for k, v in jfeats.items()}
            state = create_train_state(jmodel, tx, sample, jnp.ones((B, 2)),
                                       jax.random.PRNGKey(4))
            params0 = jax.tree_util.tree_map(np.asarray, state.params)
            step = make_train_step(jmodel, tx, num_modalities=2, donate=False)
            want_loss, want_params = [], []
            for s in range(5):
                state, metrics = step(state, jfeats, jnp.asarray(labels),
                                      jnp.asarray(idx[s]), jnp.asarray(valid[s]),
                                      jax.random.PRNGKey(0))
                want_loss.append(float(metrics["loss"]))
                want_params.append(state_dict_from_jax_params(
                    jax.tree_util.tree_map(np.asarray, state.params)))
    finally:
        set_fwd_kernel_mode(prev_f), set_bwd_kernel_mode(prev_b)

    cfg = load_config(CONFIG, overrides)
    model = classifier_from_config(cfg)
    model.load_state_dict(state_dict_from_jax_params(params0))
    opt, sched = optim.build_optimizer(cfg.training, model.parameters(), 3)
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    tlabels = torch.from_numpy(labels.astype(np.int64))
    named = dict(model.named_parameters())
    # elements whose gradient has been below AdamW's eps (1e-8): there the
    # step g / (|g| + eps) turns either framework's round-off into a step of
    # up to lr (1e-3), as for the attention pool's score bias, whose true
    # gradient is zero; they are held to that, the rest to 1e-4
    ill = {k: np.zeros(p.shape, bool) for k, p in named.items()}
    for s in range(5):
        metrics = train_step(
            model, opt, tfeats, tlabels, torch.from_numpy(idx[s].astype(np.int64)),
            torch.from_numpy(valid[s]), lr=sched(s), clip_norm=1.0,
            modality_dropout=0.0, noise=Noise(torch.Generator().manual_seed(s)))
        np.testing.assert_allclose(float(metrics["loss"]), want_loss[s],
                                   rtol=0, atol=1e-4, err_msg=f"loss, step {s}")
        got = model.state_dict()
        for k, v in want_params[s].items():
            ill[k] |= np.abs(named[k].grad.numpy()) < 1e-8
            diff = np.abs(got[k].numpy() - v.numpy())
            assert diff[~ill[k]].max(initial=0.0) <= 1e-4, f"{k}, step {s}"
            assert diff[ill[k]].max(initial=0.0) <= 1.1e-3 * (s + 1), f"{k}, step {s}"
    assert ill[SHIFT_INVARIANT].all()


def test_train_cli_then_predict_on_its_best_ckpt(tmp_path):
    sizes = {"train": 20, "val": 12, "test": 12}  # 3 / 2 / 2 batches of 8
    data = tmp_path / "data"
    for seed, (split, n) in enumerate(sizes.items()):
        feats, labels = _split(n, 10 + seed)
        (data / split).mkdir(parents=True)
        for name, arr in (*feats.items(), ("labels", labels)):
            np.save(data / split / f"{name}.npy", arr)
    overrides = BIG_GRU_NARROW + [
        "model.frontend.cache=true", "dataset.batch_size=8",
        "training.max_epochs=2", "runtime.platform=cpu",
        f"dataset.data_dir={data}", f"experiment.save_dir={tmp_path}",
        "experiment.name=big_gru"]
    for c in COUNTERS:
        c.launches = 0
    results = port_train.main(["--config", CONFIG, *overrides])
    run = tmp_path / "big_gru"
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
