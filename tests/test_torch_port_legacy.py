"""PyTorch port, the legacy-layout 2-layer recurrences (``set_res2_mode("off")``):
the plain versions of the four legacy kernels against the JAX package's
Pallas kernels in interpret mode (rows 5, 9, 8 and 10 of PERF.md's table),
``fused_lstm_final`` / ``fused_gru_final`` under the switch against JAX's
under its own ``set_res2_mode("off")``, the legacy route against the
residual-native one, the GRU's fused and layered legacy backwards
(``GRU_BWD2_ENABLED``), the switch's reach (the pair route only), the
module defaults, and the train CLI's trajectory with and without it.

Inputs and weights come from numpy seeds; JAX runs at matmul precision
"highest".  B=8, T=21, D=12, H=128 passes JAX's kernel predicates; its
kernels pad T to their chunk and its wrappers return rows ``[:T]``, the
port runs exactly T steps.  Every test that sets a module global restores
it in ``finally``: it lives as long as the test worker."""

import csv
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_emotion_detection_tpu.ops.lstm_kernel as jax_lk
import multimodal_emotion_detection_tpu.ops.lstm_vjp as jax_lv
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN
from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel, lstm_vjp
from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import (
    gru2_bwd_chain_legacy,
    gru2_bwd_chain_legacy_reference,
    gru2_train_fwd_legacy,
    gru2_train_fwd_legacy_reference,
    lstm2_bwd_chain_legacy,
    lstm2_bwd_chain_legacy_reference,
    lstm2_train_fwd_legacy,
    lstm2_train_fwd_legacy_reference,
)
from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import (
    fused_gru_final,
    fused_lstm_final,
    set_res2_mode,
)

B, T, D, H = 8, 21, 12, 128
NAMES = {"lstm": ("w_ih", "w_hh", "b"), "gru": ("w_ih", "w_hh", "b_ih", "b_hh")}
CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "base.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(cell, seed, b=B, t=T, d=D, h=H):
    """x (B, T, D), keep (B, T, H) at dropout 0.3 and both layers' weights:
    the LSTM at the scales of the JAX package's own kernel tests, the GRU
    at PyTorch's 1/sqrt(H) with the r third of b_ih in [-1.5, -0.5] (r
    away from 1, so db_hh's n third differs from db_ih's)."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        if cell == "lstm":
            return {"w_ih": (0.3 * rng.randn(d_in, 4 * h)).astype(np.float32),
                    "w_hh": (0.3 * rng.randn(h, 4 * h)).astype(np.float32),
                    "b": (0.1 * rng.randn(4 * h)).astype(np.float32)}
        b_ih = rng.uniform(-k, k, (3 * h,)).astype(np.float32)
        b_ih[:h] = rng.uniform(-1.5, -0.5, (h,))
        return {"w_ih": rng.uniform(-k, k, (d_in, 3 * h)).astype(np.float32),
                "w_hh": rng.uniform(-k, k, (h, 3 * h)).astype(np.float32),
                "b_ih": b_ih,
                "b_hh": rng.uniform(-k, k, (3 * h,)).astype(np.float32)}

    x = rng.randn(b, t, d).astype(np.float32)
    keep = ((rng.rand(b, t, h) > 0.3) / 0.7).astype(np.float32)
    return x, keep, layer(d), layer(h)


def _torch(layer):
    return {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}


def _tm(a):
    return np.ascontiguousarray(np.asarray(a).transpose(1, 0, 2))


def _shift(a):
    return np.concatenate([np.zeros_like(a[:1]), a[:-1]])


def _close_to_largest(got, want, rel, name):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale,
                               err_msg=name)


# --- the plain versions against the JAX kernels (interpret mode) -----------


def test_lstm_legacy_fwd_reference_matches_jax_kernel():
    x, keep, l0, l1 = _case("lstm", 1)
    with jax.default_matmul_precision("highest"):
        want = jax_lk.lstm2_train_fwd_pallas(
            jnp.asarray(_tm(x)), jnp.asarray(_tm(keep)), l0, l1, interpret=True)
    got = lstm2_train_fwd_legacy_reference(
        torch.from_numpy(_tm(x)), torch.from_numpy(_tm(keep)), _torch(l0), _torch(l1))
    names = ("ys", "h_final", "g0", "g1", "h0_new", "c0_new", "c1_new")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5, err_msg=name)


def _lstm_chain_inputs(seed, with_dys):
    """The legacy chain's inputs from the plain legacy forward: the gate
    series, the shifted c series, keep, a random dh_final and dys."""
    x, keep, l0, l1 = _case("lstm", seed)
    ys, _, g0, g1, _, c0, c1 = (a.numpy() for a in lstm2_train_fwd_legacy_reference(
        torch.from_numpy(_tm(x)), torch.from_numpy(_tm(keep)), _torch(l0), _torch(l1)))
    rng = np.random.RandomState(seed + 100)
    dh = rng.randn(B, H).astype(np.float32)
    dys = rng.randn(T, B, H).astype(np.float32) if with_dys else None
    return (g0, g1, _shift(c0), _shift(c1), dys, _tm(keep), dh,
            l0["w_hh"], l1["w_hh"], l1["w_ih"])


@pytest.mark.parametrize("with_dys", [False, True], ids=["no_dys", "dys"])
def test_lstm_legacy_chain_reference_matches_jax_kernel(with_dys):
    args = _lstm_chain_inputs(2, with_dys)
    with jax.default_matmul_precision("highest"):
        want = jax_lk.lstm2_bwd_chain_pallas(
            *(None if a is None else jnp.asarray(a) for a in args), interpret=True)
    got = lstm2_bwd_chain_legacy_reference(
        *(None if a is None else torch.from_numpy(np.array(a)) for a in args))
    for name, g, w in zip(("dg0", "dg1"), got, want):
        _close_to_largest(g.numpy(), w, 1e-5, name)


def test_gru_legacy_fwd_reference_matches_jax_kernel():
    x, keep, l0, l1 = _case("gru", 3)
    with jax.default_matmul_precision("highest"):
        ys, hf, layers = jax_lk.gru2_train_fwd_pallas(
            jnp.asarray(_tm(x)), jnp.asarray(_tm(keep)), l0, l1, interpret=True)
    g_ys, g_hf, g_layers = gru2_train_fwd_legacy_reference(
        torch.from_numpy(_tm(x)), torch.from_numpy(_tm(keep)), _torch(l0), _torch(l1))
    pairs = [("ys", g_ys, ys), ("h_final", g_hf, hf)] + [
        (f"layer_{i}.{n}", g_layers[i][j], layers[i][j])
        for i in range(2) for j, n in enumerate(("r", "z", "n", "hn", "h_new"))]
    for name, g, w in pairs:
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5, err_msg=name)


def _gru_chain_inputs(seed, with_dys):
    """The legacy GRU chain's inputs from the plain legacy forward: per
    layer (h_prev, r, z, n, hn), keep, a random dh_final and dys."""
    x, keep, l0, l1 = _case("gru", seed)
    _, _, layers = gru2_train_fwd_legacy_reference(
        torch.from_numpy(_tm(x)), torch.from_numpy(_tm(keep)), _torch(l0), _torch(l1))
    res = [tuple([_shift(lay[4].numpy())] + [a.numpy() for a in lay[:4]])
           for lay in layers]
    rng = np.random.RandomState(seed + 100)
    dh = rng.randn(B, H).astype(np.float32)
    dys = rng.randn(T, B, H).astype(np.float32) if with_dys else None
    return res[0], res[1], dys, _tm(keep), dh, l0["w_hh"], l1["w_hh"], l1["w_ih"]


@pytest.mark.parametrize("with_dys", [False, True], ids=["no_dys", "dys"])
def test_gru_legacy_chain_reference_matches_jax_kernel(with_dys):
    res0, res1, dys, keep, dh, *w = _gru_chain_inputs(4, with_dys)
    # the JAX kernel always streams dys: zeros stand for none
    jdys = np.zeros((T, B, H), np.float32) if dys is None else dys
    with jax.default_matmul_precision("highest"):
        want = jax_lk.gru2_bwd_chain_pallas(
            tuple(map(jnp.asarray, res0)), tuple(map(jnp.asarray, res1)),
            jnp.asarray(jdys), jnp.asarray(keep), jnp.asarray(dh),
            *map(jnp.asarray, w), interpret=True)
    got = gru2_bwd_chain_legacy_reference(
        [torch.from_numpy(a) for a in res0], [torch.from_numpy(a) for a in res1],
        None if dys is None else torch.from_numpy(dys), torch.from_numpy(keep),
        torch.from_numpy(dh), *(torch.from_numpy(np.array(a)) for a in w))
    for i in range(2):
        for j, name in enumerate(("dih", "dhh")):
            _close_to_largest(got[i][j].numpy(), want[i][j], 1e-5, f"{name}{i}")
        # dhh's r and z lanes are dih's; its n lane is dhn = dn_pre * r
        np.testing.assert_array_equal(got[i][1][..., :2 * H], got[i][0][..., :2 * H])


# --- the legacy routes against JAX's under set_res2_mode("off") ------------


def _port_loss_grads(cell, x, keep, layers, weight):
    """loss = sum(h * weight) of the final hidden state through the port's
    pair route, and its gradients in x and every parameter."""
    xt = torch.from_numpy(x).requires_grad_()
    ps = [{k: v.requires_grad_() for k, v in _torch(p).items()} for p in layers]
    fn = fused_lstm_final if cell == "lstm" else fused_gru_final
    hf = fn(xt, torch.from_numpy(_tm(keep))[:, None], ps)
    loss = (hf * torch.from_numpy(weight)).sum()
    loss.backward()
    return float(loss.detach()), [xt.grad.numpy()] + [
        p[n].grad.numpy() for p in ps for n in NAMES[cell]]


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("cell,bwd2", [("lstm", False), ("gru", False), ("gru", True)],
                         ids=["lstm", "gru_layered", "gru_fused"])
def test_legacy_route_grads_match_jax_legacy_route(cell, bwd2, monkeypatch):
    x, keep, l0, l1 = _case(cell, 5)
    weight = np.random.RandomState(6).randn(B, H).astype(np.float32)
    kernels = {"lstm": ("lstm2_train_fwd_pallas", "lstm2_bwd_chain_pallas"),
               "gru": ("gru2_train_fwd_pallas", "gru2_bwd_chain_pallas")}[cell]
    jax_calls, port_calls = [], []
    for name in kernels:
        _counting(monkeypatch, jax_lk, name, jax_calls)
    for name in ((f"{cell}2_train_fwd_legacy", f"{cell}2_bwd_chain_legacy")
                 if cell == "lstm" or bwd2 else ("gru2_train_fwd_legacy", "gru_bwd_chain")):
        _counting(monkeypatch, lstm_vjp, name, port_calls)
    jax_fn = jax_lv.fused_lstm_final if cell == "lstm" else jax_lv.fused_gru_final

    def loss(x, params):
        hf = jax_fn(x, jnp.asarray(keep)[:, :, None, :], params)
        return jnp.sum(hf * weight)

    prev = (jax_lv.set_fwd_kernel_mode("interpret"),
            jax_lv.set_bwd_kernel_mode("interpret"), jax_lv.set_res2_mode("off"))
    try:
        with jax.default_matmul_precision("highest"):
            v_ref, (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1))(
                jnp.asarray(x), (l0, l1))
    finally:
        jax_lv.set_fwd_kernel_mode(prev[0])
        jax_lv.set_bwd_kernel_mode(prev[1])
        jax_lv.set_res2_mode(prev[2])
    assert sorted(jax_calls) == sorted(kernels)  # rows 5 + 9, or 8 + 10
    want = [np.asarray(gx)] + [np.asarray(p[n]) for p in gp for n in NAMES[cell]]

    prev_mode, prev_bwd2 = set_res2_mode("off"), lstm_vjp.GRU_BWD2_ENABLED
    lstm_vjp.GRU_BWD2_ENABLED = bwd2
    try:
        v_ours, got = _port_loss_grads(cell, x, keep, (l0, l1), weight)
    finally:
        set_res2_mode(prev_mode)
        lstm_vjp.GRU_BWD2_ENABLED = prev_bwd2
    assert len(port_calls) == (2 if cell == "lstm" or bwd2 else 3)
    np.testing.assert_allclose(v_ours, float(v_ref), rtol=5e-5, atol=5e-5)
    labels = ["x"] + [f"layer_{i}.{n}" for i in range(2) for n in NAMES[cell]]
    for name, g, w in zip(labels, got, want):
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_legacy_route_matches_residual_route(cell):
    x, keep, l0, l1 = _case(cell, 7)
    weight = np.random.RandomState(8).randn(B, H).astype(np.float32)
    v_res, res = _port_loss_grads(cell, x, keep, (l0, l1), weight)
    prev = set_res2_mode("off")
    try:
        v_leg, leg = _port_loss_grads(cell, x, keep, (l0, l1), weight)
    finally:
        set_res2_mode(prev)
    # the JAX package's gate between the two layouts (ops/envelope.py
    # V2_VS_LEGACY_GRAD_REL), held here on every gradient
    np.testing.assert_allclose(v_leg, v_res, rtol=1e-6, atol=0)
    for i, (g, w) in enumerate(zip(leg, res)):
        _close_to_largest(g, w, 1e-6, str(i))


def test_gru_fused_legacy_backward_matches_the_layered_one(monkeypatch):
    x, keep, l0, l1 = _case("gru", 9)
    weight = np.random.RandomState(10).randn(B, H).astype(np.float32)
    calls = []
    for name in ("gru2_bwd_chain_legacy", "gru_bwd_chain"):
        _counting(monkeypatch, lstm_vjp, name, calls)
    outs = {}
    prev_mode, prev_bwd2 = set_res2_mode("off"), lstm_vjp.GRU_BWD2_ENABLED
    try:
        for bwd2 in (False, True):
            lstm_vjp.GRU_BWD2_ENABLED = bwd2
            outs[bwd2] = _port_loss_grads("gru", x, keep, (l0, l1), weight)
    finally:
        set_res2_mode(prev_mode)
        lstm_vjp.GRU_BWD2_ENABLED = prev_bwd2
    assert calls == ["gru_bwd_chain", "gru_bwd_chain", "gru2_bwd_chain_legacy"]
    assert outs[False][0] == outs[True][0]  # the same forward
    for i, (g, w) in enumerate(zip(outs[True][1], outs[False][1])):
        _close_to_largest(g, w, 1e-6, str(i))


# --- the switch's reach and the module defaults ----------------------------


def _rnn_outputs(cell, layers, hidden, training=True, remat=False):
    """A FusedStackedRNN's output and, in training, its gradients in x and
    every parameter, from fixed weights and input."""
    rng = np.random.RandomState(hidden + layers)
    x = torch.from_numpy(rng.randn(3, 6, 5).astype(np.float32))
    torch.manual_seed(0)
    rnn = FusedStackedRNN(5, hidden, layers, dropout=0.0, cell_type=cell)
    for p in rnn.parameters():
        torch.nn.init.uniform_(p, -0.3, 0.3)
    rnn.remat_gates = remat
    if not training:
        with torch.no_grad():
            return [rnn.eval()(x)]
    xg = x.clone().requires_grad_()
    h = rnn(xg)
    (h * h).sum().backward()
    return [h.detach(), xg.grad] + [p.grad for p in rnn.parameters()]


@pytest.mark.parametrize("cell,layers,hidden,training", [
    ("lstm", 3, 16, True),    # the layered LSTM route
    ("lstm", 2, 272, True),   # wider than the pair takes on an H100: layered too
    ("gru", 3, 16, True),     # the layered GRU route
    ("lstm", 2, 16, False),   # the eval forward (lstm2_infer)
    ("gru", 2, 16, False),    # the eval forward (gru2_infer)
])
def test_switch_changes_nothing_off_the_training_pair(cell, layers, hidden, training):
    auto = _rnn_outputs(cell, layers, hidden, training)
    prev = set_res2_mode("off")
    try:
        off = _rnn_outputs(cell, layers, hidden, training)
    finally:
        set_res2_mode(prev)
    for a, b in zip(auto, off):
        assert torch.equal(a, b)


def test_remat_gates_under_the_switch_takes_the_legacy_route(monkeypatch):
    calls = []
    for name in ("lstm2_train_fwd_legacy", "lstm2_bwd_chain_remat"):
        _counting(monkeypatch, lstm_vjp, name, calls)
    prev = set_res2_mode("off")
    try:
        remat = _rnn_outputs("lstm", 2, 16, remat=True)
        legacy = _rnn_outputs("lstm", 2, 16, remat=False)
    finally:
        set_res2_mode(prev)
    # as in the JAX package: the legacy route declines first, so the remat
    # chain is never reached
    assert calls == ["lstm2_train_fwd_legacy"] * 2
    for a, b in zip(remat, legacy):
        assert torch.equal(a, b)


def test_module_defaults_at_import():
    code = ("from multimodal_emotion_detection_tpu_torch.ops import lstm_vjp; "
            "print(lstm_vjp._RES2_MODE, lstm_vjp.GRU_BWD2_ENABLED)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.split() == ["auto", "False"]
    # and no earlier test of this worker left them set
    assert (lstm_vjp._RES2_MODE, lstm_vjp.GRU_BWD2_ENABLED) == ("auto", False)
    with pytest.raises(ValueError, match="neither"):
        set_res2_mode("on")
    assert set_res2_mode("off") == "auto"
    assert set_res2_mode("auto") == "off"


@pytest.mark.parametrize("source", ["lstm2_train_fwd.cu", "gru2_train_fwd.cu"])
def test_train_forwards_legacy_and_native_share_the_forward_core(source):
    # each 2-layer training forward's legacy form (its own source) is the
    # 2-layer forward core's training form with its legacy cell, as the
    # residual-native form is with its own; no source reaches the first
    # design's state-tile loader, which is gone, and editing the core
    # rebuilds both
    from multimodal_emotion_detection_tpu_torch.ops import _build

    legacy = source.replace(".cu", "_legacy.cu")
    names = [p.name for p in _build._sources(_build.CSRC / legacy, [])]
    text = (_build.CSRC / legacy).read_text()
    cell = "GruLegacyCell" if source.startswith("gru") else "LstmLegacyCell"
    assert names[:2] == [legacy, "rnn2_fwd_chain.cuh"]
    assert f"rnn2_fwd::launch<rnn2_fwd::{cell}, true>" in text
    assert "grid.sync" not in text and "__global__" not in text
    core = [p.name for p in _build._sources(_build.CSRC / source, [])]
    assert names[1:] == core[1:]
    assert not (_build.CSRC / "state_tile.cuh").exists()
    assert all("state_tile" not in p.read_text() for p in _build.CSRC.iterdir())


def test_cpu_wrappers_are_the_plain_versions():
    counters = (lstm_kernel.LSTM2_TRAIN_FWD_LEGACY, lstm_kernel.LSTM2_BWD_CHAIN_LEGACY,
                lstm_kernel.GRU2_TRAIN_FWD_LEGACY, lstm_kernel.GRU2_BWD_CHAIN_LEGACY)
    for c in counters:
        c.launches = 0
    b, t, d, h = 2, 6, 3, 8
    dys, dh = torch.ones(t, b, h), torch.ones(b, h)
    for cell, seed in (("lstm", 11), ("gru", 12)):
        x, keep, l0, l1 = _case(cell, seed, b, t, d, h)
        l0, l1 = _torch(l0), _torch(l1)
        args = (torch.from_numpy(_tm(x)), torch.from_numpy(_tm(keep)), l0, l1)
        w = (l0["w_hh"], l1["w_hh"], l1["w_ih"])
        if cell == "lstm":
            fwd = lstm2_train_fwd_legacy(*args)
            torch.testing.assert_close(fwd, lstm2_train_fwd_legacy_reference(*args),
                                       rtol=0, atol=0)
            chain = (*fwd[2:4], *fwd[5:7], dys, args[1], dh, *w)
            got = lstm2_bwd_chain_legacy(*chain)
            want = lstm2_bwd_chain_legacy_reference(*chain)
        else:
            fwd = gru2_train_fwd_legacy(*args)
            torch.testing.assert_close(fwd, gru2_train_fwd_legacy_reference(*args),
                                       rtol=0, atol=0)
            res0, res1 = ((lay[4],) + tuple(lay[:4]) for lay in fwd[2])
            chain = (res0, res1, dys, args[1], dh, *w)
            got = gru2_bwd_chain_legacy(*chain)
            want = gru2_bwd_chain_legacy_reference(*chain)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [c.launches for c in counters] == [0, 0, 0, 0]


# --- the train CLI with and without the switch -----------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_legacy_data")
    for seed, (split, n) in enumerate({"train": 20, "val": 12, "test": 12}.items()):
        rng = np.random.RandomState(seed)
        d = root / split
        d.mkdir()
        np.save(d / "audio.npy", rng.randn(n, 40 * 128, 1).astype(np.float32))
        np.save(d / "video.npy", rng.rand(n, 4, 16).astype(np.float32))
        np.save(d / "labels.npy", rng.randint(0, 8, n).astype(np.int32))
    return root


def _cli_rows(data_dir, save_dir, cell):
    """The flagship (narrowed: 2 x 128) or its GRU config through the train
    CLI for 2 epochs on the CPU; the rows of its ``metrics.csv``."""
    port_train.main([
        "--config", CONFIG, "model.frontend.audio=logmel",
        f"model.encoders.audio.encoder_type={cell}",
        "model.encoders.audio.hidden_dim=128", "model.encoders.video.input_dim=16",
        "model.encoders.video.hidden_dim=32", "model.output_dim=16",
        "model.hidden_dim=32", "dataset.batch_size=8", "training.max_epochs=2",
        "runtime.platform=cpu", f"dataset.data_dir={data_dir}",
        f"experiment.save_dir={save_dir}", "experiment.name=run"])
    with open(Path(save_dir) / "run" / "csv_logs/version_0/metrics.csv") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_train_cli_legacy_route_gives_the_residual_trajectory(cell, data_dir,
                                                              tmp_path, monkeypatch):
    calls = []
    _counting(monkeypatch, lstm_vjp, f"{cell}2_train_fwd_legacy", calls)
    residual = _cli_rows(data_dir, tmp_path / "a", cell)
    assert not calls
    prev = set_res2_mode("off")
    try:
        legacy = _cli_rows(data_dir, tmp_path / "b", cell)
    finally:
        set_res2_mode(prev)
    assert len(calls) == 6  # 2 epochs of 3 steps, each on the legacy route
    for key in ("train/loss", "val/loss", "test/loss"):
        got = [float(r[key]) for r in legacy if r.get(key)]
        want = [float(r[key]) for r in residual if r.get(key)]
        assert len(got) == len(want) == (1 if key == "test/loss" else 2), key
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=key)
