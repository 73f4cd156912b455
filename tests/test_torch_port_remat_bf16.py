"""PyTorch port, the gate-rematerialising LSTM pair with bf16 residual
streams (``runtime.lstm_remat_gates: true`` with
``runtime.lstm_residual_dtype: "bfloat16"``, ``configs/fast.yaml`` with
remat): the plain no-gates forward in bf16 and the plain remat chain over
bf16 streams against the JAX package's Pallas kernels in interpret mode,
``fused_lstm_final(remat_gates=True, res_dtype="bfloat16")`` against
``jax.grad`` under ``set_res2_remat("on")`` and
``set_res2_dtype("bfloat16")``, a 5-step trajectory of fast.yaml's model
with remat against JAX ``make_train_step``, the train and predict CLIs, the
plan's room for the bf16 form and the CPU wrappers.

Inputs, weights and keep masks come from numpy seeds; JAX runs at matmul
precision "highest", at T 12, B 8, D 16, H 128 (H a multiple of 128, as
JAX's ``_res3_ok`` takes the remat route).  The tolerances are
``tests/test_torch_port_bf16_residuals.py``'s, for the same reasons: a
stored bf16 series within one bf16 ulp of JAX's (``_check_series``),
the finals within 1e-5, the chain's bf16 outputs within one bf16 ulp + 1e-6
of the largest entry (``_half_close``), gradients within 2e-3 of each
largest entry, the trajectory's losses within 1e-4 and parameters within
5e-4 of each tensor's largest entry (floored at 1e-2).
"""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_emotion_detection_tpu.ops.lstm_vjp as jax_lstm_vjp
from multimodal_emotion_detection_tpu.config import load_config as jax_load_config
from multimodal_emotion_detection_tpu.models.classifier import (
    classifier_from_config as jax_classifier_from_config,
)
from multimodal_emotion_detection_tpu.ops.lstm_kernel import (
    lstm2_bwd_chain_remat as jax_bwd_chain_remat,
    lstm2_train_fwd_residuals as jax_train_fwd,
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
from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN
from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel, lstm_vjp
from multimodal_emotion_detection_tpu_torch.tools.predict import main as port_predict
from multimodal_emotion_detection_tpu_torch.training import optim
from multimodal_emotion_detection_tpu_torch.training.steps import train_step
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    state_dict_from_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
FAST = str(ROOT / "configs" / "fast.yaml")
REMAT = "runtime.lstm_remat_gates=true"
B, T, D, H = 8, 12, 16, 128
BF16 = torch.bfloat16
PARAM_NAMES = [(0, "w_ih"), (0, "w_hh"), (0, "b"), (1, "w_ih"), (1, "w_hh"),
               (1, "b")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _remat_bf16_jax():
    """The JAX package's remat route with bf16 residual streams and its
    kernels in interpret mode, restored in ``finally``: they are module
    globals."""
    prev = (jax_lstm_vjp.set_res2_remat("on"), jax_lstm_vjp.set_res2_dtype("bfloat16"),
            jax_lstm_vjp.set_fwd_kernel_mode("interpret"),
            jax_lstm_vjp.set_bwd_kernel_mode("interpret"))
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        jax_lstm_vjp.set_res2_remat(prev[0])
        jax_lstm_vjp.set_res2_dtype(prev[1])
        jax_lstm_vjp.set_fwd_kernel_mode(prev[2])
        jax_lstm_vjp.set_bwd_kernel_mode(prev[3])


def _case(seed, b=B, t=T, d=D, h=H):
    """x (B, T, D), keep (B, T, H) Bernoulli(0.9) / 0.9, both layers'
    weights, uniform in +-1/sqrt(H)."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        return {"w_ih": rng.uniform(-k, k, (d_in, 4 * h)).astype(np.float32),
                "w_hh": rng.uniform(-k, k, (h, 4 * h)).astype(np.float32),
                "b": rng.uniform(-k, k, (4 * h,)).astype(np.float32)}

    x = rng.randn(b, t, d).astype(np.float32)
    keep = ((rng.rand(b, t, h) < 0.9) / 0.9).astype(np.float32)
    return x, keep, layer(d), layer(h)


def _tm(a):
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 0, 1))


def _torch(layer):
    return {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}


def _from_jax(a):
    """A JAX array as a torch tensor of the same dtype (bf16 by its bits)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(BF16)
    return torch.from_numpy(np.array(a))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bf16 ulps (bit patterns on a monotonic line)."""
    def ordinal(t):
        u = t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, 0x8000 - u, u)

    return (ordinal(a) - ordinal(b)).abs()


def _check_series(name, got, want):
    """A stored bf16 series: each element within one bf16 ulp of JAX's, or
    (a value near zero, where the two float32 values' ~1e-7 difference
    spans several ulps) within 1e-6 of the series' largest entry; under 1%
    of the elements off at all."""
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape, name
    ulps = _ulps(got, want)
    share = float((ulps > 0).float().mean())
    near = (got.float() - want.float()).abs() <= 1e-6 * want.float().abs().max()
    assert int(((ulps > 1) & ~near).sum()) == 0, name
    assert share < 0.01, name


def _half_close(name, got, want):
    """bf16 outputs within one bf16 ulp of want + 1e-6 of its largest entry."""
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape, name
    g, w = got.float(), want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    err = float(((g - w).abs() / (ulp + 1e-6 * w.abs().max())).max())
    assert err <= 1.0, (name, err)


def _jax_fwd(x, keep, l0, l1):
    with jax.default_matmul_precision("highest"):
        return jax_train_fwd(jnp.asarray(_tm(x)), jnp.asarray(_tm(keep)), l0, l1,
                             interpret=True, res_dtype=jnp.bfloat16, store_gates=False)


# ------------------------------------------------------------ the two kernels


def test_nogates_fwd_reference_bf16_matches_jax_kernel():
    """Row 11n in bf16: packed (T, B, 2H) = [c0_prev | c1_prev] and the
    h0_prev, h1_prev and x1 series rounded to bf16, the finals float32."""
    x, keep, l0, l1 = _case(1)
    packed, h0p, h1p, x1, _, finals, _ = _jax_fwd(x, keep, l0, l1)
    got = lstm_kernel.lstm2_train_fwd_reference(
        torch.from_numpy(_tm(x)), torch.from_numpy(_tm(keep)), _torch(l0), _torch(l1),
        store_gates=False, res_dtype=BF16)
    assert got[0].shape == (T, B, 2 * H)
    for name, g, w in zip(("packed", "h0_prev", "h1_prev", "x1"), got,
                          (packed, h0p, h1p, x1)):
        _check_series(name, g, _from_jax(w)[:T])
    assert got[4].dtype == torch.float32
    np.testing.assert_allclose(got[4].numpy(), np.asarray(finals), rtol=0, atol=1e-5)


def test_remat_chain_reference_bf16_matches_jax_kernel():
    """Row 13 over bf16 streams, fed JAX's own bf16 residuals and x cast to
    bf16 as JAX's backward casts it: the gates recomputed against the
    float32 weights, dg0 and dg1 in bf16."""
    x, keep, l0, l1 = _case(2)
    dh = np.random.RandomState(3).randn(B, H).astype(np.float32)
    packed, h0p, h1p, x1, keep_pad, _, t_pad = _jax_fwd(x, keep, l0, l1)
    x_pad = jnp.pad(jnp.asarray(_tm(x)), ((0, t_pad - T), (0, 0), (0, 0)))
    x_pad = x_pad.astype(packed.dtype)
    with jax.default_matmul_precision("highest"):
        want = jax_bwd_chain_remat(packed, keep_pad, x_pad, x1, h0p, h1p, None,
                                   jnp.asarray(dh), l0, l1, T, interpret=True)
    assert all(w.dtype == jnp.bfloat16 for w in want)
    rows = [_from_jax(a)[:T] for a in (packed, x_pad, x1, h0p, h1p)]
    got = lstm_kernel.lstm2_bwd_chain_remat_reference(
        rows[0], torch.from_numpy(_tm(keep)), rows[1], rows[2], rows[3], rows[4],
        torch.from_numpy(dh), _torch(l0), _torch(l1))
    for name, g, w in zip(("dg0", "dg1"), got, want):
        _half_close(name, g, _from_jax(w)[:T])


def test_remat_chain_reference_bf16_is_the_float32_chain_rounded():
    """The bf16 plain chain is the float32 plain chain over the same
    streams upcast, each output rounded once: the kernels' contract."""
    x, keep, l0, l1 = _case(4, b=3, t=7, d=5, h=16)
    args = (torch.from_numpy(_tm(x)), torch.from_numpy(_tm(keep)), _torch(l0), _torch(l1))
    packed, h0p, h1p, x1, _ = lstm_kernel.lstm2_train_fwd_reference(
        *args, store_gates=False, res_dtype=BF16)
    dh = torch.from_numpy(np.random.RandomState(5).randn(3, 16).astype(np.float32))
    streams = (packed, args[1], args[0].to(BF16), x1, h0p, h1p)
    got = lstm_kernel.lstm2_bwd_chain_remat_reference(*streams, dh, args[2], args[3])
    up = tuple(a.float() if a.dtype == BF16 else a for a in streams)
    want = lstm_kernel.lstm2_bwd_chain_remat_reference(*up, dh, args[2], args[3])
    for g, w in zip(got, want):
        assert g.dtype == BF16 and w.dtype == torch.float32
        assert torch.equal(g, w.to(BF16))


# ------------------------------------------------------- the Function's gradients


def _port_value_and_grads(x, keep, l0, l1, res_dtype):
    xt = torch.from_numpy(x).requires_grad_()
    params = [{k: v.requires_grad_() for k, v in _torch(p).items()} for p in (l0, l1)]
    keep_t = torch.from_numpy(_tm(keep))[:, None]
    h = lstm_vjp.fused_lstm_final(xt, keep_t, params, remat_gates=True,
                                  res_dtype=res_dtype)
    loss = (h * torch.sin(h)).sum()
    loss.backward()
    return float(loss.detach()), [xt.grad.numpy()] + [
        params[layer][name].grad.numpy() for layer, name in PARAM_NAMES]


def test_remat_bf16_grads_match_jax(monkeypatch):
    """``fused_lstm_final(remat_gates=True, res_dtype="bfloat16")`` against
    ``jax.grad`` of JAX's ``fused_lstm_final`` on its remat route with bf16
    streams; the forward's value is the float32 one bit for bit; the
    gradients' distance from the port's float32 remat route exceeds their
    distance from JAX, so the bf16 streams engaged; the chain ran once."""
    x, keep, l0, l1 = _case(6)

    def loss(x, params):
        hf = jax_lstm_vjp.fused_lstm_final(x, jnp.asarray(keep)[:, :, None, :], params)
        return jnp.sum(hf * jnp.sin(hf))

    with _remat_bf16_jax():
        assert jax_lstm_vjp._res3_ok(jnp.asarray(_tm(x)), (l0, l1), interpret=True)
        _, (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(x), (l0, l1))
    want = [np.asarray(gx)] + [np.asarray(gp[layer][name]) for layer, name in PARAM_NAMES]
    chains = []
    monkeypatch.setattr(
        lstm_vjp, "lstm2_bwd_chain_remat",
        lambda *a, **k: chains.append(a[0].dtype) or lstm_kernel.lstm2_bwd_chain_remat(
            *a, **k))
    v16, got16 = _port_value_and_grads(x, keep, l0, l1, "bfloat16")
    v32, got32 = _port_value_and_grads(x, keep, l0, l1, "float32")
    assert chains == [BF16, torch.float32]
    assert v16 == v32
    gap = max(np.abs(g - w).max() / np.abs(w).max() for g, w in zip(got16, want))
    engaged = max(np.abs(a - b).max() / np.abs(b).max() for a, b in zip(got16, got32))
    print(f"bf16 remat grads vs JAX {gap:.3e}, vs the port's float32 remat grads "
          f"{engaged:.3e} of the largest entry")
    for name, g, w in zip(["x"] + PARAM_NAMES, got16, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * np.abs(w).max(),
                                   err_msg=str(name))
    assert engaged > gap, "bf16 residual streams did not engage"


# ------------------------------------------------------ fast.yaml with remat

NARROW = [
    REMAT,
    "model.encoders.audio.hidden_dim=128",
    "model.encoders.video.input_dim=16",
    "model.encoders.video.hidden_dim=32",
    "model.output_dim=16",
    "model.hidden_dim=32",
    "model.dropout=0.0",
    "model.encoders.audio.dropout=0.0",
    "model.encoders.video.dropout=0.0",
    "training.augmentation.modality_dropout=0.0",
]


def test_fast_yaml_remat_trajectory_matches_jax():
    """5 updates of fast.yaml's model with the gates rematerialised (log-mel
    features cached, LSTM 2x128 with bf16 residual streams, hybrid library
    fusion, warmup-cosine AdamW) against JAX ``make_train_step`` on its
    remat route with bf16 streams, its kernels in interpret mode."""
    n, bsz, frames = 16, 8, 12
    rng = np.random.RandomState(0)
    feats = {"audio": rng.randn(n, frames, 64).astype(np.float32),
             "video": rng.rand(n, 4, 16).astype(np.float32)}
    labels = rng.randint(0, 8, n).astype(np.int32)
    idx = [rng.randint(0, n, bsz).astype(np.int32) for _ in range(5)]
    valid = [np.ones(bsz, np.float32)] * 4 + [np.array([1] * 5 + [0] * 3, np.float32)]

    jcfg = jax_load_config(FAST, NARROW)
    jmodel = jax_classifier_from_config(jcfg)
    tx, _ = jax_optim.build_optimizer(jcfg.training, 3)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    with _remat_bf16_jax():
        state = create_train_state(jmodel, tx, {k: v[:bsz] for k, v in jfeats.items()},
                                   jnp.ones((bsz, 2)), jax.random.PRNGKey(3))
        params0 = jax.tree_util.tree_map(np.asarray, state.params)
        step = make_train_step(jmodel, tx, num_modalities=2, donate=False)
        want_loss, want_params = [], []
        for s in range(5):
            state, metrics = step(state, jfeats, jnp.asarray(labels), jnp.asarray(idx[s]),
                                  jnp.asarray(valid[s]), jax.random.PRNGKey(0))
            want_loss.append(float(metrics["loss"]))
            want_params.append(state_dict_from_jax_params(
                jax.tree_util.tree_map(np.asarray, state.params)))

    cfg = load_config(FAST, NARROW)
    model = classifier_from_config(cfg)
    (rnn,) = [m for m in model.modules() if isinstance(m, FusedStackedRNN)]
    assert rnn.residual_dtype == BF16 and rnn.remat_gates
    model.load_state_dict(state_dict_from_jax_params(params0))
    opt, sched = optim.build_optimizer(cfg.training, model.parameters(), 3)
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    tlabels = torch.from_numpy(labels.astype(np.int64))
    for s in range(5):
        metrics = train_step(
            model, opt, tfeats, tlabels, torch.from_numpy(idx[s].astype(np.int64)),
            torch.from_numpy(valid[s]), lr=sched(s), clip_norm=1.0, modality_dropout=0.0,
            noise=Noise(torch.Generator().manual_seed(s)))
        np.testing.assert_allclose(float(metrics["loss"]), want_loss[s], rtol=0,
                                   atol=1e-4, err_msg=f"loss, step {s}")
        got = model.state_dict()
        for k, v in want_params[s].items():
            w = v.numpy()
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=5e-4 * max(np.abs(w).max(), 1e-2),
                                       err_msg=f"{k}, step {s}")


SIZES = {"train": 4, "val": 2, "test": 2}


@pytest.fixture(scope="module")
def fast_data(tmp_path_factory):
    """Full-width clips: 48,000 raw samples (log-mel cached per split as
    fast.yaml sets it) and 4 frames of 4,096 video features."""
    root = tmp_path_factory.mktemp("port_fast_remat_data")
    for seed, (split, n) in enumerate(SIZES.items()):
        rng = np.random.RandomState(seed)
        d = root / split
        d.mkdir()
        np.save(d / "audio.npy", rng.randn(n, 48000, 1).astype(np.float32))
        np.save(d / "video.npy", rng.rand(n, 4, 4096).astype(np.float32))
        np.save(d / "labels.npy", rng.randint(0, 8, n).astype(np.int32))
    return root


def test_train_and_predict_fast_yaml_with_remat(fast_data, tmp_path, monkeypatch):
    """The train CLI on fast.yaml with ``runtime.lstm_remat_gates=true``
    (full width, the CPU): every step's backward is the remat chain over
    bf16 streams, never the stored-gates chain; it writes the artifacts,
    and predict serves its best checkpoint."""
    torch.set_num_threads(4)
    calls = {"remat": [], "stored": 0}

    def remat(*a, **k):
        calls["remat"].append(a[0].dtype)
        return lstm_kernel.lstm2_bwd_chain_remat(*a, **k)

    def stored(*a, **k):
        calls["stored"] += 1
        return lstm_kernel.lstm2_bwd_chain(*a, **k)

    monkeypatch.setattr(lstm_vjp, "lstm2_bwd_chain_remat", remat)
    monkeypatch.setattr(lstm_vjp, "lstm2_bwd_chain", stored)
    overrides = [REMAT, "training.max_epochs=2", "runtime.platform=cpu",
                 f"dataset.data_dir={fast_data}", f"experiment.save_dir={tmp_path}",
                 "experiment.name=run", f"outputs.experiments_dir={tmp_path / 'exp'}"]
    results = port_train.main(["--config", FAST, *overrides])
    run = tmp_path / "run"
    for rel in ("best.ckpt", "results.json", "confusion_matrix.npy",
                "checkpoints/last.ckpt", "csv_logs/version_0/metrics.csv"):
        assert (run / rel).exists(), rel
    assert np.isfinite(list(results.values())).all()
    # one step an epoch (4 clips at batch 32), a bf16 remat chain each
    assert calls == {"remat": [BF16, BF16], "stored": 0}
    metrics = port_predict(["--checkpoint", str(run / "best.ckpt"), "--config", FAST,
                            "--out", str(tmp_path / "pred"), *overrides])
    logits = np.load(tmp_path / "pred" / "logits.npy")
    assert logits.shape == (SIZES["test"], 8) and np.isfinite(logits).all()
    assert np.isfinite([metrics[k] for k in ("ece", "nll", "accuracy")]).all()


# ------------------------------------------------------------ plan, wrappers


def _gate_bytes(din: int, half: bool) -> int:
    """One set's gate blocks at the flagship's plan (H 256, UPC 4, 4 row
    groups, B 32, blocks of 8 steps), in bytes."""
    return 4 * lstm_kernel.remat_gate_floats(256, 4, 4, 32, din, 8, half)


def test_bf16_gate_blocks_fit_the_float32_plan_at_the_flagship():
    """``remat_gate_floats`` of the bf16 form (``rnn2_bwd::GateGeom`` with
    half: kp a multiple of 8, a staged row kp / 2 floats at a stride 4 mod
    8) at the flagship's plan: below the float32 form's for both layers
    (layer 0 D 64 deep, layer 1 H), so the plan's 224,912 bytes hold for
    both forms.  At D 32 (288 deep: pieces of 36 float32 values, 40 bf16)
    the forms cut the depth differently; the plan holds the larger."""
    assert (_gate_bytes(64, False), _gate_bytes(64, True)) == (54_288, 50_192)
    assert (_gate_bytes(256, False), _gate_bytes(256, True)) == (66_576, 58_384)
    assert 4 * lstm_kernel.chain_smem_floats(4, 256, 4, 2, 4, 256, layers=2,
                                             remat=(32, 64, 8)) == 224_912
    follow = 4 * lstm_kernel.chain_smem_floats(4, 256, 4, 2, 4, 256, layers=2)
    total = 4 * lstm_kernel.chain_smem_floats(4, 256, 4, 2, 4, 256, layers=2,
                                              remat=(32, 32, 8))
    assert _gate_bytes(32, False) != _gate_bytes(32, True)
    assert total == follow + max(_gate_bytes(32, False), _gate_bytes(32, True))


@pytest.mark.parametrize("rows,cols", [(7, 5), (372 * 8, 512)])
def test_bias_gradient_row_sums_match_sum(rows, cols):
    """The Functions' bias gradients sum a flattened dgates series over its
    rows as one product with a ones row (``lstm_vjp._row_sums``), which
    holds no transient the size of the series on the card: the same sums
    as ``sum(0)`` to float32 rounding."""
    a = torch.from_numpy(np.random.RandomState(rows).randn(rows, cols).astype(np.float32))
    got = lstm_vjp._row_sums(a)
    want = a.double().sum(0)
    assert got.shape == (cols,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * rows ** 0.5 * float(a.abs().max()))


def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing():
    counters = (lstm_kernel.LSTM2_TRAIN_FWD_NOGATES_BF16,
                lstm_kernel.LSTM2_BWD_CHAIN_REMAT_BF16,
                lstm_kernel.LSTM2_TRAIN_FWD_NOGATES, lstm_kernel.LSTM2_BWD_CHAIN_REMAT)
    for c in counters:
        c.launches = 0
    x, keep, l0, l1 = _case(8, b=2, t=4, d=3, h=8)
    args = (torch.from_numpy(_tm(x)), torch.from_numpy(_tm(keep)), _torch(l0), _torch(l1))
    outs = lstm_kernel.lstm2_train_fwd_residuals(*args, store_gates=False, res_dtype=BF16)
    refs = lstm_kernel.lstm2_train_fwd_reference(*args, store_gates=False, res_dtype=BF16)
    assert [o.dtype for o in outs] == [BF16] * 4 + [torch.float32]
    assert outs[0].shape == (4, 2, 16)
    for o, r in zip(outs, refs):
        assert torch.equal(o, r)
    packed, h0p, h1p, x1, _ = outs
    chain = (packed, args[1], args[0].to(BF16), x1, h0p, h1p, torch.ones(2, 8),
             args[2], args[3])
    dgs = lstm_kernel.lstm2_bwd_chain_remat(*chain)
    for g, r in zip(dgs, lstm_kernel.lstm2_bwd_chain_remat_reference(*chain)):
        assert g.dtype == BF16 and torch.equal(g, r)
    assert all(c.launches == 0 for c in counters)
