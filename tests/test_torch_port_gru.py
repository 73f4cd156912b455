"""PyTorch port, the 2-layer GRU: the three plain versions against the JAX
package's Pallas kernels (interpret mode), ``fused_gru_final``'s value and
gradients against ``jax.grad`` of JAX's ``fused_gru_final`` on both JAX
routes (the residual-native kernel pair and the scan), the eval forward
against JAX's ``FusedStackedRNN(cell_type="gru")`` on both its routes, the
stacks the pair does not take (the layered route's, against the plain
loop), the width the port refuses, and the CPU wrappers.

Inputs, weights and keep masks come from numpy seeds; JAX runs at matmul
precision "highest".  The JAX kernels need H % 128 == 0 and B >= 8 and pad
T to a multiple of their chunk; the port runs exactly T steps, so rows
``[:T]`` are compared.  The r-gate bias is drawn from [-1.5, -0.5] so that
r sits well away from 1: there ``db_hh``'s n third (``sum dn_pre * r``)
and ``db_ih``'s (``sum dn_pre``) differ, and a swap of the two shows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.models.recurrent import (
    FusedStackedRNN as JaxFusedStackedRNN,
)
from multimodal_emotion_detection_tpu.ops.lstm_kernel import (
    gru2_bwd_chain_res_padded,
    gru2_infer_pallas,
    gru2_train_fwd_residuals as jax_train_fwd,
)
from multimodal_emotion_detection_tpu.ops.lstm_vjp import (
    fused_gru_final as jax_fused_gru_final,
    set_bwd_kernel_mode,
    set_fwd_kernel_mode,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN
from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel
from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import (
    gru1_train_fwd_reference,
    gru2_bwd_chain,
    gru2_bwd_chain_reference,
    gru2_infer,
    gru2_infer_reference,
    gru2_train_fwd_reference,
    gru2_train_fwd_residuals,
)
from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import fused_gru_final

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


def _case(b, t, d, h, seed):
    """x (B, T, D), keep (B, T, H) Bernoulli(0.9)/0.9, both GRU layers;
    the r third of b_ih in [-1.5, -0.5]."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        b_ih = rng.uniform(-k, k, (3 * h,)).astype(np.float32)
        b_ih[:h] = rng.uniform(-1.5, -0.5, (h,))
        return {
            "w_ih": rng.uniform(-k, k, (d_in, 3 * h)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (h, 3 * h)).astype(np.float32),
            "b_ih": b_ih,
            "b_hh": rng.uniform(-k, k, (3 * h,)).astype(np.float32),
        }

    x = rng.randn(b, t, d).astype(np.float32)
    keep = ((rng.rand(b, t, h) < 0.9) / 0.9).astype(np.float32)
    return x, keep, layer(d), layer(h)


def _torch(layer):
    return {k: torch.from_numpy(v) for k, v in layer.items()}


def _tm(a):
    return np.ascontiguousarray(a.transpose(1, 0, 2))


@pytest.mark.parametrize("t", [5, 21])  # 21 is not a multiple of the chunk
def test_gru2_infer_reference_matches_jax_kernel(t):
    x, _, l0, l1 = _case(B, t, D, H, seed=t)
    with jax.default_matmul_precision("highest"):
        want = gru2_infer_pallas(jnp.asarray(x), l0, l1, interpret=True)
    got = gru2_infer_reference(torch.from_numpy(x), _torch(l0), _torch(l1))
    assert got.shape == (B, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("t", [5, 21])
def test_gru2_train_fwd_reference_matches_jax_kernel(t):
    x, keep, l0, l1 = _case(B, t, D, H, seed=10 + t)
    with jax.default_matmul_precision("highest"):
        ref = jax_train_fwd(jnp.asarray(_tm(x)), jnp.asarray(_tm(keep)), l0, l1,
                            interpret=True)
    packed, h0p, h1p, x1, _, finals, _ = (np.asarray(a) for a in ref)
    ours = gru2_train_fwd_reference(torch.from_numpy(_tm(x)),
                                    torch.from_numpy(_tm(keep)),
                                    _torch(l0), _torch(l1))
    for name, got, want in zip(
            ("packed", "h0_prev", "h1_prev", "x1", "finals"), ours,
            (packed[:t], h0p[:t], h1p[:t], x1[:t], finals)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=name)
    # r well away from 1 (the r third of b_ih is negative)
    assert float(ours[0][..., :H].mean()) < 0.5


@pytest.mark.parametrize("t", [5, 21])
def test_gru2_bwd_chain_reference_matches_jax_kernel(t):
    x, keep, l0, l1 = _case(B, t, D, H, seed=20 + t)
    dh = np.random.RandomState(t).randn(B, H).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        packed, h0p, h1p, _, keep_pad, _, _ = jax_train_fwd(
            jnp.asarray(_tm(x)), jnp.asarray(_tm(keep)), l0, l1, interpret=True)
        want = gru2_bwd_chain_res_padded(
            packed, h0p, h1p, keep_pad, None, jnp.asarray(dh), l0["w_hh"],
            l1["w_hh"], l1["w_ih"], t, interpret=True)
    ours = gru2_bwd_chain_reference(
        *(torch.from_numpy(np.array(a)[:t]) for a in (packed, h0p, h1p)),
        torch.from_numpy(_tm(keep)), torch.from_numpy(dh),
        torch.from_numpy(l0["w_hh"]), torch.from_numpy(l1["w_hh"]),
        torch.from_numpy(l1["w_ih"]))
    for name, got, w in zip(("dih0", "dhn0", "dih1", "dhn1"), ours, want):
        w = np.asarray(w)[:t]
        assert got.shape == w.shape, name
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-5, err_msg=name)


def _port_grads(x, keep_bt, layers, weight):
    """Gradients of sum(h_final * weight) through the port's
    fused_gru_final: [dx, then (w_ih, w_hh, b_ih, b_hh) per layer]."""
    xt = torch.from_numpy(x).requires_grad_()
    params = [{k: v.requires_grad_() for k, v in _torch(p).items()} for p in layers]
    keep = torch.from_numpy(_tm(keep_bt))[:, None]
    h = fused_gru_final(xt, keep, params)
    (h * torch.from_numpy(weight)).sum().backward()
    return h.detach().numpy(), [xt.grad.numpy()] + [
        p[name].grad.numpy() for p in params for name in NAMES]


@pytest.mark.parametrize("route", ["interpret", "off"])
def test_fused_gru_final_grads_match_jax(route):
    t = 12
    x, keep, l0, l1 = _case(B, t, D, H, seed=31)
    weight = np.random.RandomState(32).randn(B, H).astype(np.float32)

    def loss(x, params):
        hf = jax_fused_gru_final(x, jnp.asarray(keep)[:, :, None, :], params)
        return jnp.sum(hf * weight), hf

    prev_f, prev_b = set_fwd_kernel_mode(route), set_bwd_kernel_mode(route)
    try:
        with jax.default_matmul_precision("highest"):
            (_, h_ref), (gx, gp) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), (l0, l1))
    finally:
        set_fwd_kernel_mode(prev_f), set_bwd_kernel_mode(prev_b)
    want = [np.asarray(gx)] + [np.asarray(p[name]) for p in gp for name in NAMES]
    h_ours, got = _port_grads(x, keep, (l0, l1), weight)
    np.testing.assert_allclose(h_ours, np.asarray(h_ref), rtol=2e-5, atol=2e-5)
    labels = ["x"] + [f"layer_{i}.{n}" for i in range(2) for n in NAMES]
    for name, g, w in zip(labels, got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=name)
    # the n thirds of db_ih and db_hh are told apart at this r
    for i in range(2):
        db_ih, db_hh = got[3 + 4 * i], got[4 + 4 * i]
        assert np.abs(db_ih[2 * H:] - db_hh[2 * H:]).max() > 100 * 2e-5


@pytest.mark.parametrize("b", [1, 3])  # batches the JAX kernels refuse
def test_fused_gru_final_matches_plain_autograd(b):
    t, d, h = 9, 5, 16
    x, keep, l0, l1 = _case(b, t, d, h, seed=40 + b)
    weight = np.random.RandomState(b).randn(b, h).astype(np.float32)
    h_ours, got = _port_grads(x, keep, (l0, l1), weight)

    xt = torch.from_numpy(_tm(x)).requires_grad_()
    params = [{k: v.requires_grad_() for k, v in _torch(p).items()} for p in (l0, l1)]
    finals = gru2_train_fwd_reference(xt, torch.from_numpy(_tm(keep)), *params)[4]
    (finals[1] * torch.from_numpy(weight)).sum().backward()
    want = [_tm(xt.grad.numpy())] + [p[name].grad.numpy() for p in params
                                     for name in NAMES]
    np.testing.assert_allclose(h_ours, finals[1].detach().numpy(), rtol=0, atol=1e-6)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=str(i))


@pytest.mark.parametrize("inference_kernel", [True, False],
                         ids=["jax_pallas_interpret", "jax_scan"])
def test_eval_forward_matches_jax_fused_stacked_rnn(inference_kernel):
    x, _, l0, l1 = _case(B, 20, D, H, seed=50)
    with jax.default_matmul_precision("highest"):
        _, want = JaxFusedStackedRNN(
            hidden_dim=H, num_layers=2, cell_type="gru",
            inference_kernel=inference_kernel,
        ).apply({"params": {"layer_0": l0, "layer_1": l1}}, jnp.asarray(x))
    rnn = FusedStackedRNN(D, H, 2, dropout=0.1, cell_type="gru").eval()
    rnn.load_state_dict({f"layer_{i}.{k}": torch.from_numpy(v)
                         for i, p in enumerate((l0, l1)) for k, v in p.items()})
    with torch.no_grad():
        got = rnn(torch.from_numpy(x))
    assert got.shape == (B, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _zero_gru(num_layers, h, d=4):
    return [{n: torch.zeros(s) for n, s in (("w_ih", (d if i == 0 else h, 3 * h)),
                                             ("w_hh", (h, 3 * h)),
                                             ("b_ih", (3 * h,)), ("b_hh", (3 * h,)))}
            for i in range(num_layers)]


def _plain_stack(x, keep, layers):
    """The final h of a GRU stack through the plain one-layer loop."""
    x_l = x.transpose(0, 1)
    for i, p in enumerate(layers):
        _, hp, h = gru1_train_fwd_reference(x_l @ p["w_ih"] + p["b_ih"], p["w_hh"],
                                            p["b_hh"])
        x_l = torch.cat([hp[1:], h[None]])
        if i < len(layers) - 1:
            x_l = x_l * keep[:, i]
    return h


@pytest.mark.parametrize("num_layers,h", [(3, 8), (1, 8), (2, 384)],
                         ids=["depth3", "depth1", "h384"])
def test_gru_stacks_the_kernels_do_not_take_raise(num_layers, h):
    """Stacks the 2-layer kernels do not take (depth other than 2, or H
    above twice the SM count; the CPU mirrors an H100's 132) were refused
    until the layered route came: now they train and serve through it, the
    same function as the plain one-layer loop, and launch nothing of the
    2-layer pair on the CPU.  ``test_gru_wider_than_the_kernels_raises``
    holds the one refusal left."""
    gen = torch.Generator().manual_seed(num_layers + h)
    rnn = FusedStackedRNN(4, h, num_layers=num_layers, dropout=0.1, cell_type="gru")
    for i in range(num_layers):
        getattr(rnn, f"layer_{i}").reset_parameters(gen)
    x = torch.randn(2, 5, 4, generator=gen)
    weight = torch.randn(2, h, generator=gen)
    noise = Noise(torch.Generator().manual_seed(1))
    (rnn(x, noise) * weight).sum().backward()
    got = {n: p.grad for n, p in rnn.named_parameters()}
    keep = noise.drawn[0] if num_layers > 1 else None
    layers = [{k: v.detach().clone().requires_grad_()
               for k, v in getattr(rnn, f"layer_{i}").as_dict().items()}
              for i in range(num_layers)]
    (_plain_stack(x, keep, layers) * weight).sum().backward()
    for i, p in enumerate(layers):
        for k, v in p.items():
            torch.testing.assert_close(got[f"layer_{i}.{k}"], v.grad, rtol=1e-5,
                                       atol=1e-6, msg=f"layer_{i}.{k}")
    ones = torch.ones(5, max(num_layers - 1, 1), 2, h)
    with torch.no_grad():
        torch.testing.assert_close(rnn.eval()(x), _plain_stack(x, ones, layers),
                                   rtol=1e-5, atol=1e-6)


def test_gru_wider_than_the_kernels_raises():
    """Above 8 hidden units per SM (1,056 on the H100) no GRU kernel takes
    the layer: refused on the CPU as on the card, by the module and by the
    autograd route."""
    with pytest.raises(NotImplementedError, match="shape ceilings"):
        FusedStackedRNN(4, 1064, num_layers=3, cell_type="gru")
    with pytest.raises(NotImplementedError, match="shape ceilings"):
        fused_gru_final(torch.zeros(2, 3, 4), torch.ones(3, 2, 2, 1064),
                        _zero_gru(3, 1064))


def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing():
    counters = (lstm_kernel.GRU2_INFER, lstm_kernel.GRU2_TRAIN_FWD,
                lstm_kernel.GRU2_BWD_CHAIN)
    for c in counters:
        c.launches = 0
    x, keep, l0, l1 = _case(2, 6, 3, 8, seed=60)
    l0, l1 = _torch(l0), _torch(l1)
    xt = torch.from_numpy(x)
    torch.testing.assert_close(gru2_infer(xt, l0, l1),
                               gru2_infer_reference(xt, l0, l1), rtol=0, atol=0)
    x_tm, keep_tm = torch.from_numpy(_tm(x)), torch.from_numpy(_tm(keep))
    ours = gru2_train_fwd_residuals(x_tm, keep_tm, l0, l1)
    for a, r in zip(ours, gru2_train_fwd_reference(x_tm, keep_tm, l0, l1)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    # the eval forward is the training forward's final h at keep = 1
    ones = torch.ones_like(keep_tm)
    torch.testing.assert_close(gru2_infer(xt, l0, l1),
                               gru2_train_fwd_reference(x_tm, ones, l0, l1)[4][1])
    args = (*ours[:3], keep_tm, torch.ones(2, 8), l0["w_hh"], l1["w_hh"], l1["w_ih"])
    for a, r in zip(gru2_bwd_chain(*args), gru2_bwd_chain_reference(*args)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="item 6"):
        gru2_bwd_chain(*args, dys=torch.zeros(6, 2, 8))
    # a GRU FusedStackedRNN trains and serves through the same wrappers
    rnn = FusedStackedRNN(3, 8, cell_type="gru", dropout=0.1)
    for p in (rnn.layer_0, rnn.layer_1):
        p.reset_parameters(torch.Generator().manual_seed(0))
    rnn(xt, Noise(torch.Generator().manual_seed(1))).sum().backward()
    assert all(p.grad is not None for p in rnn.parameters())
    with torch.no_grad():
        assert rnn.eval()(xt).shape == (2, 8)
    assert [c.launches for c in counters] == [0, 0, 0]
