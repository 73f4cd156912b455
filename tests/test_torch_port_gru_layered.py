"""PyTorch port, the one-layer-per-launch GRU route (any depth, wide
layers): the plain single-layer training forward and its eval form against
one layer of the JAX package's GRU scan (``_gru_fwd_scan``), the plain
reverse chain against ``gru_bwd_chain_pallas`` (interpret mode), the
layered ``fused_gru_final`` value and gradients against ``jax.grad`` of
JAX's ``fused_gru_final`` (depth 1 and 3 on its layered Pallas route, 2
layers of H=272 on its scan), the eval forward against JAX's
``StackedRNN`` and ``FusedStackedRNN``, the route rule and the CPU
wrappers.

Inputs, weights and keep masks come from numpy seeds; JAX runs at matmul
precision "highest".  The JAX kernel needs H % 128 == 0 and B >= 8 and
pads T to a multiple of its chunk; the port runs exactly T steps, so rows
``[:T]`` are compared.  The r third of ``b_ih`` is drawn from [-1.5,
-0.5] so that r sits well away from 1: there ``dhn = dn_pre * r`` and
``dn_pre`` differ, and a swap of the two lanes shows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.models.recurrent import (
    FusedStackedRNN as JaxFusedStackedRNN,
    StackedRNN as JaxStackedRNN,
)
from multimodal_emotion_detection_tpu.ops import lstm_kernel as jax_lstm_kernel
from multimodal_emotion_detection_tpu.ops.lstm_kernel import gru_bwd_chain_pallas
from multimodal_emotion_detection_tpu.ops.lstm_vjp import (
    _gru_fwd_scan,
    fused_gru_final as jax_fused_gru_final,
    set_bwd_kernel_mode,
    set_fwd_kernel_mode,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN
from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel
from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import (
    gru1_infer,
    gru1_infer_reference,
    gru1_train_fwd,
    gru1_train_fwd_reference,
    gru_bwd_chain,
    gru_bwd_chain_reference,
)
from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import (
    H100_SMS,
    fused_gru_final,
    gru_route,
)

NAMES = ("w_ih", "w_hh", "b_ih", "b_hh")
B, D, H = 8, 12, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layers(rng, d, h, n_layers):
    """GRU layers in the JAX layout; the r third of b_ih in [-1.5, -0.5]."""
    k = 1.0 / np.sqrt(h)
    out = []
    for i in range(n_layers):
        b_ih = rng.uniform(-k, k, (3 * h,)).astype(np.float32)
        b_ih[:h] = rng.uniform(-1.5, -0.5, (h,))
        out.append({
            "w_ih": rng.uniform(-k, k, (d if i == 0 else h, 3 * h)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (h, 3 * h)).astype(np.float32),
            "b_ih": b_ih,
            "b_hh": rng.uniform(-k, k, (3 * h,)).astype(np.float32),
        })
    return out


def _torch(layer):
    return {k: torch.from_numpy(v) for k, v in layer.items()}


def _jax_layer(x_tm, layer):
    """One layer of JAX's GRU scan over x_tm (T, B, D): ``(h_final, ys,
    (h_prev, r, z, n, hn))`` as numpy arrays."""
    t, b, _ = x_tm.shape
    keep = jnp.ones((t, 0, b, layer["w_hh"].shape[0]), jnp.float32)
    with jax.default_matmul_precision("highest"):
        carry, ys, res = _gru_fwd_scan(jnp.asarray(x_tm), keep, (layer,))
    return np.array(carry[0]), np.array(ys), tuple(np.array(a) for a in res[0][:5])


def _ih(x_tm, layer):
    return torch.from_numpy(x_tm) @ torch.from_numpy(layer["w_ih"]) + torch.from_numpy(
        layer["b_ih"])


@pytest.mark.parametrize("t", [5, 21])
def test_gru1_train_fwd_and_eval_form_match_jax_scan(t):
    rng = np.random.RandomState(t)
    (layer,) = _layers(rng, D, H, 1)
    x_tm = rng.randn(t, B, D).astype(np.float32)
    h_final, ys, (h_prev, r, z, n, hn) = _jax_layer(x_tm, layer)
    ih = _ih(x_tm, layer)
    gates, hp, h = gru1_train_fwd_reference(ih, *(torch.from_numpy(layer[k])
                                                   for k in ("w_hh", "b_hh")))
    want = {"gates": np.concatenate([r, z, n, hn], axis=-1), "h_prev": h_prev,
            "h": h_final}
    for name, got in (("gates", gates), ("h_prev", hp), ("h", h)):
        assert got.shape == want[name].shape, name
        np.testing.assert_allclose(got.numpy(), want[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    w_hh, b_hh = torch.from_numpy(layer["w_hh"]), torch.from_numpy(layer["b_hh"])
    np.testing.assert_allclose(gru1_infer_reference(ih, w_hh, b_hh, True).numpy(), ys,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(gru1_infer_reference(ih, w_hh, b_hh, False).numpy(),
                               h_final, rtol=0, atol=1e-5)
    # r well away from 1 (the r third of b_ih is negative)
    assert float(r.mean()) < 0.5


@pytest.mark.parametrize("with_series", [True, False], ids=["dh_series", "no_series"])
@pytest.mark.parametrize("t", [5, 21])  # 21 is not a multiple of the chunk
def test_gru_bwd_chain_reference_matches_jax_kernel(t, with_series):
    rng = np.random.RandomState(20 + t)
    (layer,) = _layers(rng, D, H, 1)
    x_tm = rng.randn(t, B, D).astype(np.float32)
    _, _, (h_prev, r, z, n, hn) = _jax_layer(x_tm, layer)
    dhs = (rng.randn(t, B, H).astype(np.float32) if with_series
           else np.zeros((t, B, H), np.float32))
    dhf = rng.randn(B, H).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want_dih, want_dhh = gru_bwd_chain_pallas(
            *(jnp.asarray(a) for a in (h_prev, r, z, n, hn, dhs, dhf)),
            jnp.asarray(layer["w_hh"]), interpret=True)
    dih, dhn = gru_bwd_chain_reference(
        torch.from_numpy(np.concatenate([r, z, n, hn], axis=-1)),
        torch.from_numpy(h_prev), torch.from_numpy(dhs) if with_series else None,
        torch.from_numpy(dhf), torch.from_numpy(layer["w_hh"]))
    assert dih.shape == (t, B, 3 * H) and dhn.shape == (t, B, H)
    # dhh = [dih[:, :2H] | dhn]: the lanes the port shares with dih
    dhh = torch.cat([dih[..., :2 * H], dhn], dim=-1)
    np.testing.assert_allclose(dih.numpy(), np.asarray(want_dih), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dhh.numpy(), np.asarray(want_dhh), rtol=0, atol=1e-5)
    # dhn = dn_pre * r is not dn_pre at this r
    assert np.abs(dhn.numpy() - dih[..., 2 * H:].numpy()).max() > 1e-2


def _keep_bt(rng, b, t, n_gaps, h, p=0.1):
    """JAX's keep layout (B, T, L-1, H), Bernoulli(1-p)/(1-p)."""
    return ((rng.rand(b, t, n_gaps, h) >= p) / (1.0 - p)).astype(np.float32)


def _port_grads(x, keep_bt, layers, weight):
    """Gradients of sum(h_final * weight) through the port's
    fused_gru_final: [dx, then (w_ih, w_hh, b_ih, b_hh) per layer]."""
    xt = torch.from_numpy(x).requires_grad_()
    params = [{k: v.requires_grad_() for k, v in _torch(p).items()} for p in layers]
    keep = torch.from_numpy(np.ascontiguousarray(keep_bt.transpose(1, 2, 0, 3)))
    h = fused_gru_final(xt, keep, params)
    (h * torch.from_numpy(weight)).sum().backward()
    return h.detach().numpy(), [xt.grad.numpy()] + [
        p[name].grad.numpy() for p in params for name in NAMES]


@pytest.mark.parametrize("n_layers,h,pallas_chains", [
    (1, 128, 1),  # JAX: the row-7 kernel (interpret), once per layer
    (3, 128, 3),
    (2, 272, 0),  # JAX: the reverse scan (H % 128 != 0); the port: layered
], ids=["depth1_row7", "depth3_row7", "2x272_scan"])
def test_layered_fused_gru_final_grads_match_jax(monkeypatch, n_layers, h,
                                                  pallas_chains):
    t = 12
    rng = np.random.RandomState(31 + n_layers)
    layers = _layers(rng, D, h, n_layers)
    x = rng.randn(B, t, D).astype(np.float32)
    keep = _keep_bt(rng, B, t, n_layers - 1, h)
    weight = rng.randn(B, h).astype(np.float32)
    assert gru_route(n_layers, h, H100_SMS) == "layered"

    chains = []

    def counted(*args, **kwargs):
        chains.append(args[0].shape)
        return gru_bwd_chain_pallas(*args, **kwargs)

    # JAX's layered backward imports the kernel from its module when it runs
    monkeypatch.setattr(jax_lstm_kernel, "gru_bwd_chain_pallas", counted)

    def loss(x, params):
        hf = jax_fused_gru_final(x, jnp.asarray(keep), params)
        return jnp.sum(hf * weight), hf

    prev_f, prev_b = set_fwd_kernel_mode("interpret"), set_bwd_kernel_mode("interpret")
    try:
        with jax.default_matmul_precision("highest"):
            (_, h_ref), (gx, gp) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), tuple(layers))
    finally:
        set_fwd_kernel_mode(prev_f), set_bwd_kernel_mode(prev_b)
    assert len(chains) == pallas_chains
    want = [np.asarray(gx)] + [np.asarray(p[name]) for p in gp for name in NAMES]
    h_ours, got = _port_grads(x, keep, layers, weight)
    np.testing.assert_allclose(h_ours, np.asarray(h_ref), rtol=2e-5, atol=2e-5)
    labels = ["x"] + [f"layer_{i}.{n}" for i in range(n_layers) for n in NAMES]
    for name, g, w in zip(labels, got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=name)
    # the n thirds of db_ih and db_hh are told apart at this r
    for i in range(n_layers):
        db_ih, db_hh = got[3 + 4 * i], got[4 + 4 * i]
        assert np.abs(db_ih[2 * h:] - db_hh[2 * h:]).max() > 100 * 2e-5


@pytest.mark.parametrize("b,n_layers,h", [(1, 3, 16), (3, 4, 16)])
def test_layered_grads_match_plain_autograd(b, n_layers, h):
    """Batches the JAX kernel refuses, and depth 4, against autograd
    through the plain forward loops."""
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
    x_l = xt.transpose(0, 1)
    for i, p in enumerate(params):
        _, hp, h_ref = gru1_train_fwd_reference(x_l @ p["w_ih"] + p["b_ih"],
                                                p["w_hh"], p["b_hh"])
        x_l = torch.cat([hp[1:], h_ref[None]])
        if i < n_layers - 1:
            x_l = x_l * keep_tm[:, i]
    (h_ref * torch.from_numpy(weight)).sum().backward()
    want = [xt.grad.numpy()] + [p[name].grad.numpy() for p in params for name in NAMES]
    np.testing.assert_allclose(h_ours, h_ref.detach().numpy(), rtol=0, atol=1e-6)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=str(i))


def _port_rnn(layers, cell, d, h):
    rnn = FusedStackedRNN(d, h, len(layers), dropout=0.1, cell_type=cell).eval()
    rnn.load_state_dict({f"layer_{i}.{k}": torch.from_numpy(v)
                         for i, p in enumerate(layers) for k, v in p.items()})
    return rnn


@pytest.mark.parametrize("cell,n_layers", [("gru", 1), ("gru", 3), ("lstm", 1),
                                           ("lstm", 3)])
def test_eval_forward_matches_jax_stacked_rnn(cell, n_layers):
    """The JAX package's layerwise module (depth 1, ``fused: false``, long
    sequences) computes the same function on the same parameter tree."""
    t = 20
    rng = np.random.RandomState(50 + n_layers)
    x = rng.randn(B, t, D).astype(np.float32)
    if cell == "gru":
        layers = _layers(rng, D, H, n_layers)
    else:
        k = 1.0 / np.sqrt(H)
        layers = [{"w_ih": rng.uniform(-k, k, (D if i == 0 else H, 4 * H)),
                   "w_hh": rng.uniform(-k, k, (H, 4 * H)),
                   "b": rng.uniform(-k, k, (4 * H,))} for i in range(n_layers)]
        layers = [{n: v.astype(np.float32) for n, v in p.items()} for p in layers]
    params = {f"layer_{i}": p for i, p in enumerate(layers)}
    with jax.default_matmul_precision("highest"):
        _, want = JaxStackedRNN(hidden_dim=H, num_layers=n_layers, cell_type=cell).apply(
            {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port_rnn(layers, cell, D, H)(torch.from_numpy(x))
    assert got.shape == (B, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_eval_forward_matches_jax_fused_stacked_rnn():
    t, n_layers = 20, 3
    rng = np.random.RandomState(55)
    layers = _layers(rng, D, H, n_layers)
    x = rng.randn(B, t, D).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, want = JaxFusedStackedRNN(hidden_dim=H, num_layers=n_layers,
                                     cell_type="gru").apply(
            {"params": {f"layer_{i}": p for i, p in enumerate(layers)}},
            jnp.asarray(x))
    with torch.no_grad():
        got = _port_rnn(layers, "gru", D, H)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_layers,h,route", [
    (2, 128, "pair"), (2, 256, "pair"), (2, 264, "pair"), (2, 272, "layered"),
    (1, 64, "layered"), (1, 256, "layered"), (3, 64, "layered"),
    (3, 512, "layered"),
])
def test_gru_route(n_layers, h, route):
    assert gru_route(n_layers, h, H100_SMS) == route


def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing():
    counters = (lstm_kernel.GRU1_TRAIN_FWD, lstm_kernel.GRU1_INFER,
                lstm_kernel.GRU_BWD_CHAIN, lstm_kernel.GRU2_INFER,
                lstm_kernel.GRU2_TRAIN_FWD, lstm_kernel.GRU2_BWD_CHAIN)
    for c in counters:
        c.launches = 0
    rng = np.random.RandomState(60)
    (layer,) = _layers(rng, 3, 8, 1)
    ih = _ih(rng.randn(6, 3, 3).astype(np.float32), layer)
    w_hh, b_hh = torch.from_numpy(layer["w_hh"]), torch.from_numpy(layer["b_hh"])
    ours, refs = gru1_train_fwd(ih, w_hh, b_hh), gru1_train_fwd_reference(ih, w_hh, b_hh)
    for a, r in zip(ours, refs):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    for series in (True, False):
        got = gru1_infer(ih, w_hh, b_hh, series)
        torch.testing.assert_close(got, gru1_infer_reference(ih, w_hh, b_hh, series),
                                   rtol=0, atol=0)
        assert got.shape == ((6, 3, 8) if series else (3, 8))
    gates, h_prev, _ = refs
    for dhs in (None, torch.ones(6, 3, 8)):
        for a, r in zip(gru_bwd_chain(gates, h_prev, dhs, torch.ones(3, 8), w_hh),
                        gru_bwd_chain_reference(gates, h_prev, dhs, torch.ones(3, 8),
                                                w_hh)):
            torch.testing.assert_close(a, r, rtol=0, atol=0)
    # a 3-layer GRU FusedStackedRNN trains and serves through the same
    # wrappers, and the 2-layer kernels do not run for it
    rnn = FusedStackedRNN(3, 8, num_layers=3, cell_type="gru", dropout=0.1)
    for i in range(3):
        getattr(rnn, f"layer_{i}").reset_parameters(torch.Generator().manual_seed(i))
    x = torch.from_numpy(rng.randn(2, 6, 3).astype(np.float32))
    rnn(x, Noise(torch.Generator().manual_seed(1))).sum().backward()
    assert all(p.grad is not None for p in rnn.parameters())
    with torch.no_grad():
        assert rnn.eval()(x).shape == (2, 8)
    assert [c.launches for c in counters] == [0] * len(counters)
