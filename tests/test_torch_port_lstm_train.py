"""PyTorch port, 2-layer LSTM training path: the plain training forward
and reverse chain against the JAX package's Pallas kernels (interpret
mode), and ``FusedLSTMFinal``'s gradients against ``jax.grad`` of
``fused_lstm_final`` on both JAX routes and against plain autograd.

Inputs and weights come from numpy seeds; JAX runs at matmul precision
"highest".  The JAX kernels pad T to a multiple of their chunk; the port
runs exactly T steps, so rows ``[:T]`` are compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.ops.lstm_kernel import (
    lstm2_bwd_chain_padded,
    lstm2_train_fwd_residuals as jax_train_fwd,
)
from multimodal_emotion_detection_tpu.ops.lstm_vjp import (
    fused_lstm_final as jax_fused_lstm_final,
    set_bwd_kernel_mode,
    set_fwd_kernel_mode,
)
from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel
from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import (
    lstm2_bwd_chain,
    lstm2_bwd_chain_reference,
    lstm2_train_fwd_reference,
    lstm2_train_fwd_residuals,
)
from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import fused_lstm_final

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


def _case(b, t, d, h, seed):
    """x (B, T, D), keep (B, T, H) Bernoulli(0.75)/0.75, both layers."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        return {
            "w_ih": rng.uniform(-k, k, (d_in, 4 * h)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (h, 4 * h)).astype(np.float32),
            "b": rng.uniform(-k, k, (4 * h,)).astype(np.float32),
        }

    x = rng.randn(b, t, d).astype(np.float32)
    keep = ((rng.rand(b, t, h) < 0.75) / 0.75).astype(np.float32)
    return x, keep, layer(d), layer(h)


def _torch(layer):
    return {k: torch.from_numpy(v) for k, v in layer.items()}


def _tm(a):
    return np.ascontiguousarray(a.transpose(1, 0, 2))


@pytest.mark.parametrize("t", [12, 37])  # 37 pads to 40 on the JAX side
def test_train_fwd_reference_matches_jax_kernel(t):
    x, keep, l0, l1 = _case(8, t, 6, 128, seed=t)
    with jax.default_matmul_precision("highest"):
        ref = jax_train_fwd(jnp.asarray(_tm(x)), jnp.asarray(_tm(keep)),
                            l0, l1, interpret=True)
    packed, h0p, h1p, x1, _, finals, _ = (np.asarray(a) for a in ref)
    ours = lstm2_train_fwd_reference(torch.from_numpy(_tm(x)),
                                     torch.from_numpy(_tm(keep)),
                                     _torch(l0), _torch(l1))
    for name, got, want in zip(
            ("packed", "h0_prev", "h1_prev", "x1", "finals"), ours,
            (packed[:t], h0p[:t], h1p[:t], x1[:t], finals)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("t", [12, 37])
def test_bwd_chain_reference_matches_jax_kernel(t):
    x, keep, l0, l1 = _case(8, t, 6, 128, seed=100 + t)
    dh = np.random.RandomState(t).randn(8, 128).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        packed, _, _, _, keep_pad, _, _ = jax_train_fwd(
            jnp.asarray(_tm(x)), jnp.asarray(_tm(keep)), l0, l1,
            interpret=True)
        dg0, dg1 = lstm2_bwd_chain_padded(
            packed, keep_pad, None, jnp.asarray(dh), l0["w_hh"], l1["w_hh"],
            l1["w_ih"], t, interpret=True)
    packed = torch.from_numpy(np.array(packed)[:t])
    ours = lstm2_bwd_chain_reference(
        packed, torch.from_numpy(_tm(keep)), torch.from_numpy(dh),
        torch.from_numpy(l0["w_hh"]), torch.from_numpy(l1["w_hh"]),
        torch.from_numpy(l1["w_ih"]))
    for got, want in zip(ours, (dg0, dg1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:t], rtol=0,
                                   atol=1e-5)


def _torch_grads(x, keep, l0, l1, weight):
    """Gradients of sum(h_final * weight) through FusedLSTMFinal."""
    xt = torch.from_numpy(x).requires_grad_()
    p0 = {k: v.requires_grad_() for k, v in _torch(l0).items()}
    p1 = {k: v.requires_grad_() for k, v in _torch(l1).items()}
    h = fused_lstm_final(xt, torch.from_numpy(_tm(keep))[:, None], (p0, p1))
    (h * torch.from_numpy(weight)).sum().backward()
    return h.detach().numpy(), [xt.grad.numpy()] + [
        (p0, p1)[layer][name].grad.numpy() for layer, name in PARAM_NAMES]


@pytest.mark.parametrize("route", ["interpret", "off"])
def test_fused_lstm_final_grads_match_jax(route):
    b, t, d, h = 8, 12, 6, 128
    x, keep, l0, l1 = _case(b, t, d, h, seed=7)
    weight = np.random.RandomState(8).randn(b, h).astype(np.float32)

    def loss(x, params):
        hf = jax_fused_lstm_final(x, jnp.asarray(keep)[:, :, None, :], params)
        return jnp.sum(hf * weight), hf

    prev_f, prev_b = set_fwd_kernel_mode(route), set_bwd_kernel_mode(route)
    try:
        with jax.default_matmul_precision("highest"):
            (_, h_ref), (gx, gp) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), (l0, l1))
    finally:
        set_fwd_kernel_mode(prev_f), set_bwd_kernel_mode(prev_b)
    want = [np.asarray(gx)] + [np.asarray(gp[layer][name])
                               for layer, name in PARAM_NAMES]
    h_ours, got = _torch_grads(x, keep, l0, l1, weight)
    np.testing.assert_allclose(h_ours, np.asarray(h_ref), rtol=2e-5, atol=2e-5)
    for name, g, w in zip(["x"] + PARAM_NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=str(name))


@pytest.mark.parametrize("b", [1, 3])  # batches the JAX kernels refuse
def test_fused_lstm_final_matches_plain_autograd(b):
    t, d, h = 9, 5, 16
    x, keep, l0, l1 = _case(b, t, d, h, seed=20 + b)
    weight = np.random.RandomState(b).randn(b, h).astype(np.float32)
    h_ours, got = _torch_grads(x, keep, l0, l1, weight)

    xt = torch.from_numpy(_tm(x)).requires_grad_()
    p0 = {k: v.requires_grad_() for k, v in _torch(l0).items()}
    p1 = {k: v.requires_grad_() for k, v in _torch(l1).items()}
    finals = lstm2_train_fwd_reference(xt, torch.from_numpy(_tm(keep)), p0, p1)[4]
    (finals[2] * torch.from_numpy(weight)).sum().backward()
    want = [_tm(xt.grad.numpy())] + [
        (p0, p1)[layer][name].grad.numpy() for layer, name in PARAM_NAMES]
    np.testing.assert_allclose(h_ours, finals[2].detach().numpy(), rtol=0,
                               atol=1e-6)
    for name, g, w in zip(["x"] + PARAM_NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=str(name))


def test_cpu_wrappers_are_the_plain_versions():
    lstm_kernel.LSTM2_TRAIN_FWD.launches = 0
    lstm_kernel.LSTM2_BWD_CHAIN.launches = 0
    x, keep, l0, l1 = _case(2, 6, 3, 8, seed=3)
    x_tm, keep_tm = torch.from_numpy(_tm(x)), torch.from_numpy(_tm(keep))
    l0, l1 = _torch(l0), _torch(l1)
    ours = lstm2_train_fwd_residuals(x_tm, keep_tm, l0, l1)
    ref = lstm2_train_fwd_reference(x_tm, keep_tm, l0, l1)
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    dh = torch.ones(2, 8)
    args = (ours[0], keep_tm, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    for a, r in zip(lstm2_bwd_chain(*args), lstm2_bwd_chain_reference(*args)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="item 3"):
        lstm2_bwd_chain(*args, dys=torch.zeros(6, 2, 8))
    assert lstm_kernel.LSTM2_TRAIN_FWD.launches == 0
    assert lstm_kernel.LSTM2_BWD_CHAIN.launches == 0
