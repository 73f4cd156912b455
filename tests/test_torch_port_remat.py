"""PyTorch port, the gate-rematerialising 2-layer LSTM pair
(``runtime.lstm_remat_gates``): the plain no-gates training forward and
the plain remat reverse chain against the JAX package's Pallas kernels in
interpret mode, ``fused_lstm_final(remat_gates=True)`` against JAX's
``fused_lstm_final`` under ``set_res2_remat("on")``, the remat route
against the stored-gates route, the flag's reach (the pair only), and the
train CLI's trajectory with and without it.

Inputs and weights come from numpy seeds; JAX runs at matmul precision
"highest".  B=8, T=21, D=12, H=128 passes JAX's ``_res2_ok`` and
``_res3_ok``; its kernels pad T to 24, the port runs exactly T steps, so
rows ``[:T]`` are compared."""

import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_emotion_detection_tpu.ops.lstm_vjp as jax_lv
from multimodal_emotion_detection_tpu.ops.lstm_kernel import (
    lstm2_bwd_chain_remat as jax_bwd_chain_remat,
    lstm2_train_fwd_residuals as jax_train_fwd,
)
from multimodal_emotion_detection_tpu_torch import train as port_train
from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN
from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel, lstm_vjp
from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import (
    lstm2_bwd_chain,
    lstm2_bwd_chain_remat,
    lstm2_bwd_chain_remat_reference,
    lstm2_train_fwd_reference,
    lstm2_train_fwd_residuals,
)
from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import fused_lstm_final

B, T, D, H = 8, 21, 12, 128
PARAM_NAMES = [(0, "w_ih"), (0, "w_hh"), (0, "b"), (1, "w_ih"), (1, "w_hh"),
               (1, "b")]
CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "base.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed, b=B, t=T, d=D, h=H):
    """x (B, T, D), keep (B, T, H) at dropout 0.3, both layers' weights
    (the scales of the JAX package's own remat test)."""
    rng = np.random.RandomState(seed)

    def layer(d_in):
        return {"w_ih": (0.3 * rng.randn(d_in, 4 * h)).astype(np.float32),
                "w_hh": (0.3 * rng.randn(h, 4 * h)).astype(np.float32),
                "b": (0.1 * rng.randn(4 * h)).astype(np.float32)}

    x = rng.randn(b, t, d).astype(np.float32)
    keep = ((rng.rand(b, t, h) > 0.3) / 0.7).astype(np.float32)
    return x, keep, layer(d), layer(h)


def _torch(layer):
    return {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}


def _tm(a):
    return np.ascontiguousarray(np.asarray(a).transpose(1, 0, 2))


def _jax_fwd(x, keep, l0, l1):
    with jax.default_matmul_precision("highest"):
        return jax_train_fwd(jnp.asarray(_tm(x)), jnp.asarray(_tm(keep)), l0, l1,
                             interpret=True, store_gates=False)


def test_nogates_fwd_reference_matches_jax_kernel():
    x, keep, l0, l1 = _case(1)
    *outs, t_pad = _jax_fwd(x, keep, l0, l1)
    packed, h0p, h1p, x1, _, finals = (np.asarray(a) for a in outs)
    assert t_pad == 24 and packed.shape == (24, B, 2 * H)
    ours = lstm2_train_fwd_reference(torch.from_numpy(_tm(x)),
                                     torch.from_numpy(_tm(keep)),
                                     _torch(l0), _torch(l1), store_gates=False)
    for name, got, want in zip(
            ("packed", "h0_prev", "h1_prev", "x1", "finals"), ours,
            (packed[:T], h0p[:T], h1p[:T], x1[:T], finals)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=name)


def test_remat_chain_reference_matches_jax_kernel():
    x, keep, l0, l1 = _case(2)
    dh = np.random.RandomState(3).randn(B, H).astype(np.float32)
    packed, h0p, h1p, x1, keep_pad, _, t_pad = _jax_fwd(x, keep, l0, l1)
    x_pad = jnp.pad(jnp.asarray(_tm(x)), ((0, t_pad - T), (0, 0), (0, 0)))
    with jax.default_matmul_precision("highest"):
        want = jax_bwd_chain_remat(packed, keep_pad, x_pad, x1, h0p, h1p, None,
                                   jnp.asarray(dh), l0, l1, T, interpret=True)
    rows = [torch.from_numpy(np.array(a)[:T]) for a in (packed, x1, h0p, h1p)]
    got = lstm2_bwd_chain_remat_reference(
        rows[0], torch.from_numpy(_tm(keep)), torch.from_numpy(_tm(x)), rows[1],
        rows[2], rows[3], torch.from_numpy(dh), _torch(l0), _torch(l1))
    for name, g, w in zip(("dg0", "dg1"), got, want):
        w = np.asarray(w)[:T]
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def _port_loss_grads(x, keep, l0, l1, remat):
    """loss = sum(h sin h) of the final hidden state through the port's
    pair route, and its gradients in x and every parameter."""
    xt = torch.from_numpy(x).requires_grad_()
    p0 = {k: v.requires_grad_() for k, v in _torch(l0).items()}
    p1 = {k: v.requires_grad_() for k, v in _torch(l1).items()}
    hf = fused_lstm_final(xt, torch.from_numpy(_tm(keep))[:, None], (p0, p1),
                          remat_gates=remat)
    loss = (hf * torch.sin(hf)).sum()
    loss.backward()
    return float(loss.detach()), [xt.grad.numpy()] + [
        (p0, p1)[layer][name].grad.numpy() for layer, name in PARAM_NAMES]


def test_remat_route_grads_match_jax_remat_route():
    x, keep, l0, l1 = _case(4)

    def loss(x, params):
        hf = jax_lv.fused_lstm_final(x, jnp.asarray(keep)[:, :, None, :], params)
        return jnp.sum(hf * jnp.sin(hf))

    prev = (jax_lv.set_fwd_kernel_mode("interpret"),
            jax_lv.set_bwd_kernel_mode("interpret"), jax_lv.set_res2_remat("on"))
    try:
        assert jax_lv._res3_ok(jnp.asarray(_tm(x)), (l0, l1), interpret=True)
        with jax.default_matmul_precision("highest"):
            v_ref, (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1))(
                jnp.asarray(x), (l0, l1))
    finally:
        jax_lv.set_fwd_kernel_mode(prev[0])
        jax_lv.set_bwd_kernel_mode(prev[1])
        jax_lv.set_res2_remat(prev[2])
    want = [np.asarray(gx)] + [np.asarray(gp[layer][name])
                               for layer, name in PARAM_NAMES]
    v_ours, got = _port_loss_grads(x, keep, l0, l1, remat=True)
    # the tolerance of the JAX package's own remat test
    np.testing.assert_allclose(v_ours, float(v_ref), rtol=5e-5, atol=5e-5)
    for name, g, w in zip(["x"] + PARAM_NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-5, err_msg=str(name))


def test_remat_route_matches_stored_gates_route(monkeypatch):
    calls = []
    monkeypatch.setattr(lstm_vjp, "lstm2_bwd_chain_remat",
                        lambda *a, **k: calls.append(1) or lstm2_bwd_chain_remat(*a, **k))
    x, keep, l0, l1 = _case(5)
    v_stored, stored = _port_loss_grads(x, keep, l0, l1, remat=False)
    assert not calls
    v_remat, remat = _port_loss_grads(x, keep, l0, l1, remat=True)
    assert calls == [1]
    assert v_remat == v_stored  # the forward's arithmetic is the same
    for name, g, w in zip(["x"] + PARAM_NAMES, remat, stored):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=str(name))


@pytest.mark.parametrize("cell,layers,hidden", [
    ("lstm", 3, 16),    # the layered LSTM route
    ("lstm", 2, 272),   # wider than the pair takes on an H100: layered too
    ("gru", 2, 16),     # the GRU pair
])
def test_remat_flag_changes_nothing_off_the_lstm_pair(cell, layers, hidden):
    rng = np.random.RandomState(hidden + layers)
    x = torch.from_numpy(rng.randn(3, 6, 5).astype(np.float32))
    outs = []
    for remat in (False, True):
        torch.manual_seed(0)
        rnn = FusedStackedRNN(5, hidden, layers, dropout=0.0, cell_type=cell)
        for p in rnn.parameters():
            torch.nn.init.uniform_(p, -0.3, 0.3)
        rnn.remat_gates = remat
        xg = x.clone().requires_grad_()
        h = rnn(xg)
        (h * h).sum().backward()
        outs.append([h.detach(), xg.grad] + [p.grad for p in rnn.parameters()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_cpu_wrappers_are_the_plain_versions():
    lstm_kernel.LSTM2_TRAIN_FWD_NOGATES.launches = 0
    lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches = 0
    x, keep, l0, l1 = _case(6, b=2, t=6, d=3, h=8)
    x_tm, keep_tm = torch.from_numpy(_tm(x)), torch.from_numpy(_tm(keep))
    l0, l1 = _torch(l0), _torch(l1)
    ours = lstm2_train_fwd_residuals(x_tm, keep_tm, l0, l1, store_gates=False)
    ref = lstm2_train_fwd_reference(x_tm, keep_tm, l0, l1, store_gates=False)
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    dh = torch.ones(2, 8)
    args = (ours[0], keep_tm, x_tm, ours[3], ours[1], ours[2], dh, l0, l1)
    for a, r in zip(lstm2_bwd_chain_remat(*args),
                    lstm2_bwd_chain_remat_reference(*args)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    # on the same forward, the stored-gates chain differs only by the
    # rounding of the recompute
    stored = lstm2_train_fwd_residuals(x_tm, keep_tm, l0, l1)
    for a, r in zip(lstm2_bwd_chain_remat(*args),
                    lstm2_bwd_chain(stored[0], keep_tm, dh, l0["w_hh"],
                                    l1["w_hh"], l1["w_ih"])):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="item 3"):
        lstm2_bwd_chain_remat(*args, dys=torch.zeros(6, 2, 8))
    assert lstm_kernel.LSTM2_TRAIN_FWD_NOGATES.launches == 0
    assert lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches == 0


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_remat_data")
    for seed, (split, n) in enumerate({"train": 20, "val": 12, "test": 12}.items()):
        rng = np.random.RandomState(seed)
        d = root / split
        d.mkdir()
        np.save(d / "audio.npy", rng.randn(n, 40 * 128, 1).astype(np.float32))
        np.save(d / "video.npy", rng.rand(n, 4, 16).astype(np.float32))
        np.save(d / "labels.npy", rng.randint(0, 8, n).astype(np.int32))
    return root


def _cli_rows(data_dir, save_dir, *extra):
    """The flagship (narrowed: LSTM 2x128) through the train CLI for 2
    epochs on the CPU; the rows of its ``metrics.csv``."""
    port_train.main([
        "--config", CONFIG, "model.frontend.audio=logmel",
        "model.encoders.audio.hidden_dim=128", "model.encoders.video.input_dim=16",
        "model.encoders.video.hidden_dim=32", "model.output_dim=16",
        "model.hidden_dim=32", "dataset.batch_size=8", "training.max_epochs=2",
        "runtime.platform=cpu", f"dataset.data_dir={data_dir}",
        f"experiment.save_dir={save_dir}", "experiment.name=run", *extra])
    with open(Path(save_dir) / "run" / "csv_logs/version_0/metrics.csv") as f:
        return list(csv.DictReader(f))


def test_train_cli_remat_gives_the_stored_gates_trajectory(data_dir, tmp_path,
                                                           monkeypatch):
    calls = []
    monkeypatch.setattr(lstm_vjp, "lstm2_bwd_chain_remat",
                        lambda *a, **k: calls.append(1) or lstm2_bwd_chain_remat(*a, **k))
    stored = _cli_rows(data_dir, tmp_path / "a")
    assert not calls
    remat = _cli_rows(data_dir, tmp_path / "b", "runtime.lstm_remat_gates=true")
    assert len(calls) == 6  # 2 epochs of 3 steps, each through the remat chain
    for key in ("train/loss", "val/loss", "test/loss"):
        got = [float(r[key]) for r in remat if r.get(key)]
        want = [float(r[key]) for r in stored if r.get(key)]
        assert len(got) == len(want) == (1 if key == "test/loss" else 2), key
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=key)
