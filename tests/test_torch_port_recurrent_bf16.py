"""PyTorch port, the LSTM and GRU stacks under a bf16 compute dtype
(``FusedStackedRNN(dtype=torch.bfloat16)``: ``runtime.compute_dtype`` or
the encoder's ``dtype: bfloat16``) on the CPU, where every kernel wrapper
runs its plain version, against the JAX package's ``FusedStackedRNN`` with
``dtype=bfloat16`` and its kernels in interpret mode, as its own tests run
them.

The JAX kernels compute in float32 on whatever operands they are given:
bf16 x and weights, and the keep mask made in bf16 (a kept element is
bf16(1 / bf16(0.9)) = 1.109375 at p = 0.1), read into float32.  So on a
kernel route the two sides compute the same float32 function of the same
rounded operands, and the final h, rounded to bf16, is held to 1 bf16 ulp
of its largest entry (one = 2^-8 of it) and the float32 parameters'
gradients to 1e-4 of the largest, under a fixed bf16-exact cotangent (so no
ulp flip of h's rounding enters them).  The routes: the residual-native
pairs (float32 and bf16 residual streams, the LSTM's with its gates
rematerialised too), the legacy-layout pairs, and the layered LSTM.

The JAX package has no kernel route for a GRU deeper than 2 layers: its
training forward is an XLA scan in bf16 arithmetic.  There the port's
layered GRU (float32 kernels on the rounded operands) is held to 1 ulp of
JAX's float32 route on the same rounded operands, and to JAX's bf16 route
by the bf16 rule: h within 4 ulps, the gradients' distance from the float32
gradients within max(2e-2, 2 x JAX's own).

The eval forward is the port's float32 eval kernels on the rounded
operands: JAX's ``inference_kernel=True`` numerics, held to 1 ulp of it;
JAX's default bf16 eval forward (an XLA scan in bf16 arithmetic) is held
within max(4 ulps, 2 x the distance between JAX's own two bf16 routes)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.models import recurrent as jax_recurrent
from multimodal_emotion_detection_tpu.models.recurrent import (
    FusedStackedRNN as JaxFusedStackedRNN,
)
from multimodal_emotion_detection_tpu.ops import lstm_vjp as jax_lstm_vjp
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN
from multimodal_emotion_detection_tpu_torch.ops import lstm_vjp

B, T, D, H, P = 8, 20, 12, 128, 0.1
ULP = 2.0 ** -8
BF16 = jnp.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(cell, layers, seed):
    """x (B, T, D), the layers' float32 parameters (the JAX init's
    U(-1/sqrt(H), 1/sqrt(H))), the 0/1 keep draws (T, L-1, B, H) at 1 - P
    and a bf16-exact cotangent of h (B, H)."""
    rng = np.random.RandomState(seed)
    k, gates = 1.0 / np.sqrt(H), 4 if cell == "lstm" else 3
    names = ("w_ih", "w_hh", "b") if cell == "lstm" else ("w_ih", "w_hh", "b_ih", "b_hh")
    params = []
    for layer in range(layers):
        shapes = {"w_ih": (D if layer == 0 else H, gates * H), "w_hh": (H, gates * H)}
        params.append({n: rng.uniform(-k, k, shapes.get(n, (gates * H,))).astype(np.float32)
                       for n in names})
    x = rng.randn(B, T, D).astype(np.float32)
    draws = (rng.rand(T, layers - 1, B, H) < 1.0 - P).astype(np.float32)
    cot = np.asarray(jnp.asarray(rng.randn(B, H)).astype(BF16).astype(jnp.float32))
    return x, params, draws, cot


@contextlib.contextmanager
def _jax_route(residual="float32", remat="off", res2="auto"):
    """JAX's kernels in interpret mode with the given residual dtype,
    gate remat and pair layout, and its inference kernel enabled, restored
    after (its trainer sets these module globals and leaves them)."""
    prev = (jax_lstm_vjp.set_fwd_kernel_mode("interpret"),
            jax_lstm_vjp.set_bwd_kernel_mode("interpret"),
            jax_lstm_vjp.set_res2_dtype(residual), jax_lstm_vjp.set_res2_remat(remat),
            jax_lstm_vjp.set_res2_mode(res2), jax_recurrent.set_infer_kernel_enabled(True))
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        jax_recurrent.set_infer_kernel_enabled(prev[5])
        jax_lstm_vjp.set_fwd_kernel_mode(prev[0])
        jax_lstm_vjp.set_bwd_kernel_mode(prev[1])
        jax_lstm_vjp.set_res2_dtype(prev[2])
        jax_lstm_vjp.set_res2_remat(prev[3])
        jax_lstm_vjp.set_res2_mode(prev[4])


def _jax_train(cell, x, params, draws, cot, dtype=BF16, keep_value=None):
    """JAX's training forward of the module's final h, as its
    ``FusedStackedRNN(dtype=dtype)`` runs it (x, weights and the keep mask
    in ``dtype``; a kept element ``keep_value`` where given), and the
    float32 parameters' gradients of sum(h * cot)."""
    fn = jax_lstm_vjp.fused_lstm_final if cell == "lstm" else jax_lstm_vjp.fused_gru_final
    keep = jnp.asarray(np.transpose(draws, (2, 0, 1, 3))).astype(dtype)
    keep = keep / (1.0 - P) if keep_value is None else keep * keep_value

    def final(ps):
        layers = tuple(jax.tree_util.tree_map(lambda a: a.astype(dtype), ps))
        return fn(jnp.asarray(x).astype(dtype), keep, layers)

    h, vjp = jax.vjp(final, [{k: jnp.asarray(v) for k, v in p.items()} for p in params])
    (grads,) = vjp(jnp.asarray(cot).astype(h.dtype))
    return (np.asarray(h.astype(jnp.float32)), [{k: np.asarray(v) for k, v in g.items()}
                                                for g in grads], keep)


def _rnn(cell, params, dtype=torch.bfloat16):
    rnn = FusedStackedRNN(D, H, len(params), dropout=P, cell_type=cell, dtype=dtype)
    rnn.load_state_dict({f"layer_{i}.{k}": torch.from_numpy(v)
                         for i, p in enumerate(params) for k, v in p.items()})
    return rnn


def _port_train(rnn, x, draws, cot):
    """The port's training forward on the same keep draws (replayed as the
    float32 mask Noise draws) and the gradients of sum(h * cot)."""
    rnn.train()
    h = rnn(torch.from_numpy(x), Noise(replay=[torch.from_numpy(draws) / (1.0 - P)]))
    assert h.dtype == rnn.compute_dtype
    (h.float() * torch.from_numpy(cot)).sum().backward()
    grads = [{k: p.grad.numpy() for k, p in getattr(rnn, f"layer_{i}").named_parameters()}
             for i in range(rnn.num_layers)]
    assert all(g.dtype == np.float32 for layer in grads for g in layer.values())
    return h.detach().float().numpy(), grads


def _ulps(got, want):
    return float(np.abs(got - want).max()) / (ULP * float(np.abs(want).max()))


def _grad_err(got, want):
    g_max = max(float(np.abs(g).max()) for layer in want for g in layer.values())
    return max(float(np.abs(got[i][k] - g).max())
               for i, layer in enumerate(want) for k, g in layer.items()) / g_max


# the kernel routes: the cell, the depth, the residual streams' dtype, the
# gate remat and the pair layout (res2 "off": the legacy-layout pairs)
ROUTES = [
    pytest.param("lstm", 2, "float32", "off", "auto", id="lstm_pair"),
    pytest.param("lstm", 2, "bfloat16", "off", "auto", id="lstm_pair_bf16_streams"),
    pytest.param("lstm", 2, "float32", "on", "auto", id="lstm_remat_f32_streams"),
    pytest.param("lstm", 2, "bfloat16", "on", "auto", id="lstm_remat_bf16_streams"),
    pytest.param("lstm", 2, "float32", "off", "off", id="lstm_legacy"),
    pytest.param("lstm", 3, "float32", "off", "auto", id="lstm_layered"),
    pytest.param("lstm", 3, "bfloat16", "off", "auto", id="lstm_layered_bf16_streams"),
    pytest.param("gru", 2, "float32", "off", "auto", id="gru_pair"),
    pytest.param("gru", 2, "bfloat16", "off", "auto", id="gru_pair_bf16_streams"),
    pytest.param("gru", 2, "float32", "off", "off", id="gru_legacy"),
]


@pytest.mark.parametrize("cell,layers,residual,remat,res2", ROUTES)
def test_train_route_matches_jax_kernels(cell, layers, residual, remat, res2):
    x, params, draws, cot = _case(cell, layers, seed=layers + 10 * len(cell))
    with _jax_route(residual, remat, res2):
        want_h, want_g, keep = _jax_train(cell, x, params, draws, cot)
    # the keep mask made in bf16: bf16(1 / bf16(0.9)), not 1 / 0.9
    assert set(np.unique(np.asarray(keep.astype(jnp.float32)))) == {0.0, 1.109375}
    rnn = _rnn(cell, params)
    rnn.residual_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[residual]
    rnn.remat_gates = remat == "on"
    prev = lstm_vjp.set_res2_mode(res2)
    try:
        got_h, got_g = _port_train(rnn, x, draws, cot)
    finally:
        lstm_vjp.set_res2_mode(prev)
    h_ulps, g_err = _ulps(got_h, want_h), _grad_err(got_g, want_g)
    print(f"{cell} x{layers} {residual} streams, remat {remat}, res2 {res2}: h "
          f"{h_ulps:.3f} ulps, gradients {g_err:.3e} of the largest")
    assert h_ulps <= 1.0
    assert g_err <= 1e-4


def test_gru_depth3_train_route_against_jax():
    x, params, draws, cot = _case("gru", 3, seed=33)
    with _jax_route():
        bf_h, bf_g, _ = _jax_train("gru", x, params, draws, cot)
        f32_g = _jax_train("gru", x, params, draws, cot, jnp.float32)[1]
        # JAX's float32 route on the operands the port rounds: bf16 x,
        # weights and keep values, computed in float32
        rounded = [{k: np.asarray(jnp.asarray(v).astype(BF16).astype(jnp.float32))
                    for k, v in p.items()} for p in params]
        x16 = np.asarray(jnp.asarray(x).astype(BF16).astype(jnp.float32))
        same_h = _jax_train("gru", x16, rounded, draws, cot, jnp.float32, 1.109375)[0]
    got_h, got_g = _port_train(_rnn("gru", params), x, draws, cot)
    same_h = np.asarray(jnp.asarray(same_h).astype(BF16).astype(jnp.float32))
    g_max = max(float(np.abs(g).max()) for layer in f32_g for g in layer.values())
    port_d, jax_d = _grad_err(got_g, f32_g), _grad_err(bf_g, f32_g)
    print(f"gru x3: h {_ulps(got_h, same_h):.3f} ulps from JAX's float32 route on the "
          f"rounded operands, {_ulps(got_h, bf_h):.3f} from its bf16 scan; gradients' "
          f"distance from float32 (of the largest, {g_max:.3e}): port {port_d:.3e}, JAX "
          f"bf16 {jax_d:.3e}")
    assert _ulps(got_h, same_h) <= 1.0
    assert _ulps(got_h, bf_h) <= 4.0
    assert port_d <= max(2e-2, 2 * jax_d)


@pytest.mark.parametrize("cell,layers", [("lstm", 2), ("gru", 2), ("lstm", 3), ("gru", 3)],
                         ids=["lstm_pair", "gru_pair", "lstm_layered", "gru_layered"])
def test_eval_forward_against_jax_routes(cell, layers):
    x, params, _, _ = _case(cell, layers, seed=50 + layers)
    variables = {"params": {f"layer_{i}": {k: jnp.asarray(v) for k, v in p.items()}
                            for i, p in enumerate(params)}}
    outs = {}
    with _jax_route():
        for kernel in (True, False):
            _, h = JaxFusedStackedRNN(hidden_dim=H, num_layers=layers, cell_type=cell,
                                      dtype=BF16, inference_kernel=kernel).apply(
                variables, jnp.asarray(x))
            outs[kernel] = np.asarray(h.astype(jnp.float32))
    rnn = _rnn(cell, params).eval()
    with torch.no_grad():
        got = rnn(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (B, H)
    got = got.float().numpy()
    to_kernel, to_scan = _ulps(got, outs[True]), _ulps(got, outs[False])
    jax_routes = _ulps(outs[True], outs[False])
    print(f"{cell} x{layers} eval: port {to_kernel:.3f} ulps from JAX's inference kernel, "
          f"{to_scan:.3f} from its bf16 scan; JAX's two routes {jax_routes:.3f} apart")
    if layers == 2:  # JAX's inference kernel takes 2 layers only
        assert to_kernel <= 1.0
    assert to_scan <= max(4.0, 2 * jax_routes)


def test_float32_stack_is_unchanged_by_the_dtype_plumbing():
    """The default float32 module computes what it computed before the
    compute dtype existed: float32 out, no rounding, float32 keep values."""
    x, params, draws, cot = _case("lstm", 2, seed=7)
    rnn32 = _rnn("lstm", params, torch.float32)
    got_h, got_g = _port_train(rnn32, x, draws, cot)
    with _jax_route():
        want_h, want_g, _ = _jax_train("lstm", x, params, draws, cot, jnp.float32)
    np.testing.assert_allclose(got_h, want_h, rtol=0, atol=1e-6)
    assert _grad_err(got_g, want_g) <= 1e-5
