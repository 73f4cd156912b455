"""PyTorch port, the one-layer-per-launch LSTM route (any depth, wide
layers): the plain single-layer training forward and reverse chain against
the JAX package's Pallas kernels (interpret mode), the L=3
``fused_lstm_final`` value and gradients against ``jax.grad`` on both JAX
routes (the layered kernels and the scan), the L=3 eval forward against
the JAX ``FusedStackedRNN``, and the route rule.

Inputs, weights and keep masks come from numpy seeds; JAX runs at matmul
precision "highest".  The JAX kernels pad T to a multiple of their chunk;
the port runs exactly T steps, so rows ``[:T]`` are compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.models.recurrent import (
    FusedStackedRNN as JaxFusedStackedRNN,
)
from multimodal_emotion_detection_tpu.ops.lstm_kernel import (
    lstm1_train_fwd_pallas,
    lstm_bwd_chain_pallas,
)
from multimodal_emotion_detection_tpu.ops.lstm_vjp import (
    fused_lstm_final as jax_fused_lstm_final,
    set_bwd_kernel_mode,
    set_fwd_kernel_mode,
)
from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN
from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel
from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import (
    lstm1_infer,
    lstm1_infer_reference,
    lstm1_train_fwd,
    lstm1_train_fwd_reference,
    lstm2_train_fwd_reference,
    lstm_bwd_chain,
    lstm_bwd_chain_reference,
)
from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import (
    H100_SMS,
    fused_lstm_final,
    lstm_route,
)

NAMES = ("w_ih", "w_hh", "b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layers(rng, d, h, n_layers):
    k = 1.0 / np.sqrt(h)
    return [{
        "w_ih": rng.uniform(-k, k, (d if i == 0 else h, 4 * h)).astype(np.float32),
        "w_hh": rng.uniform(-k, k, (h, 4 * h)).astype(np.float32),
        "b": rng.uniform(-k, k, (4 * h,)).astype(np.float32),
    } for i in range(n_layers)]


def _ih_case(b, t, h, seed):
    """A layer's hoisted input projection (T, B, 4H) and its w_hh."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)
    ih = rng.uniform(-1.0, 1.0, (t, b, 4 * h)).astype(np.float32)
    return ih, rng.uniform(-k, k, (h, 4 * h)).astype(np.float32)


def _torch(layer):
    return {k: torch.from_numpy(v) for k, v in layer.items()}


@pytest.mark.parametrize("t", [5, 13])  # 13 is not a multiple of the chunk
def test_lstm1_train_fwd_reference_matches_jax_kernel(t):
    ih, w_hh = _ih_case(8, t, 128, seed=t)
    with jax.default_matmul_precision("highest"):
        want = lstm1_train_fwd_pallas(jnp.asarray(ih), jnp.asarray(w_hh),
                                      interpret=True)
    got = lstm1_train_fwd_reference(torch.from_numpy(ih), torch.from_numpy(w_hh))
    for name, g, w in zip(("g", "h_prev", "c_prev", "finals"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dh_series", ["random", "zero"])
def test_lstm_bwd_chain_reference_matches_jax_kernel(dh_series):
    b, t, h = 8, 13, 128
    ih, w_hh = _ih_case(b, t, h, seed=21)
    rng = np.random.RandomState(22)
    dhs = (rng.randn(t, b, h).astype(np.float32) if dh_series == "random"
           else np.zeros((t, b, h), np.float32))
    dhf = rng.randn(b, h).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        g, _, c_prev, _ = lstm1_train_fwd_pallas(jnp.asarray(ih),
                                                 jnp.asarray(w_hh), interpret=True)
        want = lstm_bwd_chain_pallas(g, c_prev, jnp.asarray(dhs), jnp.asarray(dhf),
                                     jnp.asarray(w_hh), interpret=True)
    got = lstm_bwd_chain_reference(
        torch.from_numpy(np.array(g)), torch.from_numpy(np.array(c_prev)),
        torch.from_numpy(dhs) if dh_series == "random" else None,
        torch.from_numpy(dhf), torch.from_numpy(w_hh))
    assert got.shape == (t, b, 4 * h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _keep_bt(rng, b, t, n_gaps, h, p=0.1):
    """JAX's keep layout (B, T, L-1, H), Bernoulli(1-p)/(1-p)."""
    return ((rng.rand(b, t, n_gaps, h) >= p) / (1.0 - p)).astype(np.float32)


def _port_grads(x, keep_bt, layers, weight):
    """Gradients of sum(h_final * weight) through the port's
    fused_lstm_final: [dx, then (w_ih, w_hh, b) per layer]."""
    xt = torch.from_numpy(x).requires_grad_()
    params = [{k: v.requires_grad_() for k, v in _torch(p).items()} for p in layers]
    keep = torch.from_numpy(np.ascontiguousarray(keep_bt.transpose(1, 2, 0, 3)))
    h = fused_lstm_final(xt, keep, params)
    (h * torch.from_numpy(weight)).sum().backward()
    return h.detach().numpy(), [xt.grad.numpy()] + [
        p[name].grad.numpy() for p in params for name in NAMES]


@pytest.mark.parametrize("route", ["interpret", "off"])
def test_layered_fused_lstm_final_grads_match_jax(route):
    b, t, d, h, n_layers = 8, 12, 6, 128, 3
    rng = np.random.RandomState(31)
    layers = _layers(rng, d, h, n_layers)
    x = rng.randn(b, t, d).astype(np.float32)
    keep = _keep_bt(rng, b, t, n_layers - 1, h)
    weight = rng.randn(b, h).astype(np.float32)

    def loss(x, params):
        hf = jax_fused_lstm_final(x, jnp.asarray(keep), params)
        return jnp.sum(hf * weight), hf

    prev_f, prev_b = set_fwd_kernel_mode(route), set_bwd_kernel_mode(route)
    try:
        with jax.default_matmul_precision("highest"):
            (_, h_ref), (gx, gp) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), tuple(layers))
    finally:
        set_fwd_kernel_mode(prev_f), set_bwd_kernel_mode(prev_b)
    want = [np.asarray(gx)] + [np.asarray(p[name]) for p in gp for name in NAMES]
    h_ours, got = _port_grads(x, keep, layers, weight)
    np.testing.assert_allclose(h_ours, np.asarray(h_ref), rtol=2e-5, atol=2e-5)
    labels = ["x"] + [f"layer_{i}.{n}" for i in range(n_layers) for n in NAMES]
    for name, g, w in zip(labels, got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("b,n_layers,h", [(1, 3, 16), (3, 4, 16), (2, 2, 300)])
def test_layered_grads_match_plain_autograd(b, n_layers, h):
    """Batches the JAX kernels refuse, depth 4, and a 2-layer stack too
    wide for the 2-layer kernels (H > 2 x 132), against autograd through
    the plain loops."""
    t, d = 7, 5
    rng = np.random.RandomState(40 + b)
    layers = _layers(rng, d, h, n_layers)
    x = rng.randn(b, t, d).astype(np.float32)
    keep = _keep_bt(rng, b, t, n_layers - 1, h)
    weight = rng.randn(b, h).astype(np.float32)
    h_ours, got = _port_grads(x, keep, layers, weight)

    xt = torch.from_numpy(x).requires_grad_()
    params = [{k: v.requires_grad_() for k, v in _torch(p).items()} for p in layers]
    keep_tm = torch.from_numpy(np.ascontiguousarray(keep.transpose(1, 2, 0, 3)))
    if n_layers == 2:
        h_ref = lstm2_train_fwd_reference(xt.transpose(0, 1), keep_tm[:, 0],
                                          *params)[4][2]
    else:
        x_l = xt.transpose(0, 1)
        for i, p in enumerate(params):
            _, hp, _, finals = lstm1_train_fwd_reference(x_l @ p["w_ih"] + p["b"],
                                                         p["w_hh"])
            h_ref = finals[:, :h]
            x_l = torch.cat([hp[1:], h_ref[None]])
            if i < n_layers - 1:
                x_l = x_l * keep_tm[:, i]
    (h_ref * torch.from_numpy(weight)).sum().backward()
    want = [xt.grad.numpy()] + [p[name].grad.numpy() for p in params for name in NAMES]
    np.testing.assert_allclose(h_ours, h_ref.detach().numpy(), rtol=0, atol=1e-6)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=str(i))


def test_eval_forward_matches_jax_fused_stacked_rnn():
    b, t, d, h, n_layers = 8, 20, 6, 128, 3
    rng = np.random.RandomState(50)
    layers = _layers(rng, d, h, n_layers)
    x = rng.randn(b, t, d).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, want = JaxFusedStackedRNN(hidden_dim=h, num_layers=n_layers).apply(
            {"params": {f"layer_{i}": p for i, p in enumerate(layers)}},
            jnp.asarray(x))
    rnn = FusedStackedRNN(d, h, n_layers, dropout=0.1).eval()
    rnn.load_state_dict({f"layer_{i}.{k}": torch.from_numpy(v)
                         for i, p in enumerate(layers) for k, v in p.items()})
    with torch.no_grad():
        got = rnn(torch.from_numpy(x))
    assert got.shape == (b, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_layers,h,route", [
    (2, 256, "pair"), (2, 264, "pair"), (2, 512, "layered"),
    (3, 64, "layered"), (3, 256, "layered"), (3, 512, "layered"),
])
def test_lstm_route(n_layers, h, route):
    assert lstm_route(n_layers, h, H100_SMS) == route


def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing():
    counters = (lstm_kernel.LSTM1_TRAIN_FWD, lstm_kernel.LSTM1_INFER,
                lstm_kernel.LSTM_BWD_CHAIN)
    for c in counters:
        c.launches = 0
    ih, w_hh = (torch.from_numpy(a) for a in _ih_case(3, 6, 8, seed=60))
    for a, r in zip(lstm1_train_fwd(ih, w_hh), lstm1_train_fwd_reference(ih, w_hh)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    for series in (True, False):
        got = lstm1_infer(ih, w_hh, series)
        torch.testing.assert_close(got, lstm1_infer_reference(ih, w_hh, series),
                                   rtol=0, atol=0)
        assert got.shape == ((6, 3, 8) if series else (3, 8))
    g, _, c_prev, finals = lstm1_train_fwd_reference(ih, w_hh)
    torch.testing.assert_close(lstm1_infer(ih, w_hh, False), finals[:, :8])
    dhf = torch.ones(3, 8)
    for dhs in (None, torch.ones(6, 3, 8)):
        torch.testing.assert_close(lstm_bwd_chain(g, c_prev, dhs, dhf, w_hh),
                                   lstm_bwd_chain_reference(g, c_prev, dhs, dhf, w_hh),
                                   rtol=0, atol=0)
    assert [c.launches for c in counters] == [0, 0, 0]
