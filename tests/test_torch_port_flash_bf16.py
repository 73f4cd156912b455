"""PyTorch port, the bf16 forms of flash attention (``ops/flash_attention.py``
on bf16 q, k, v) on the CPU, where every kernel wrapper runs its plain
version:

* O, and dQ / dK / dV through ``FlashAttention``'s backward, against the
  JAX package's ``flash_attention(..., interpret=True)`` on the same bf16
  inputs (``jax.vjp``): one key block, a key-padding bias, Tk 600 (two JAX
  key blocks, P rounded after a running max there) and the two-pass route
  past 4,096 keys;
* the plain forms round at the contract's points: dropping any one of
  them (P before P V, P before P^T dO, dS before dS^T Q and dS K) moves
  thousands of elements away from JAX's, which the contract meets all but
  a few of;
* float16 and mixed operands raise;
* dropout in bf16: the kept fraction and same-seed determinism of the
  mask through the bf16 forward, and the gradients given the extracted
  mask against float32 autograd through the plain attention.

Tolerances: one bf16 ulp is taken as 2^-8 of the largest entry; each
assert states its bound and why."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

ULP = 2.0 ** -8  # one bf16 ulp, relative to the largest entry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these small
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed, b, h, tq, tk, d, masked, q_scale=1.0):
    """bf16-exact float32 arrays (q, k, v, cotangent) and the key bias."""
    rng = np.random.default_rng(seed)
    half = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q = half(q_scale * rng.standard_normal((b, h, tq, d)).astype(np.float32))
    k, v = (half(rng.standard_normal((b, h, tk, d)).astype(np.float32)) for _ in range(2))
    cot = half(rng.standard_normal((b, h, tq, d)).astype(np.float32))
    bias = None
    if masked:
        keep = rng.random((b, tk)) > 0.25
        keep[:, 0] = True  # no fully masked row
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    return q, k, v, bias, cot


def _bf16(*arrays):
    return [torch.from_numpy(np.array(a)).to(torch.bfloat16) for a in arrays]


def _jax_vjp(q, k, v, bias, cot):
    """JAX's bf16 O and (dQ, dK, dV) in interpret mode, as float32 arrays."""
    jb = None if bias is None else jnp.asarray(bias)
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda *a: jax_flash_attention(*a, jb, interpret=True), *args)
    assert out.dtype == jnp.bfloat16
    grads = vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _port_vjp(q, k, v, bias, cot):
    leaves = [t.requires_grad_() for t in _bf16(q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias)
    out = fa.flash_attention(*leaves, tb)
    out.backward(_bf16(cot)[0])
    assert out.dtype == torch.bfloat16 and all(t.grad.dtype == torch.bfloat16 for t in leaves)
    return [t.float().numpy() for t in (out.detach(), *(t.grad for t in leaves))]


CASES = [
    # b, h, tq, tk, d, masked
    pytest.param((0, 2, 4, 37, 37, 64, False), id="one-block"),
    pytest.param((1, 2, 4, 37, 37, 64, True), id="key-bias"),
    pytest.param((2, 1, 2, 40, 600, 32, True), id="Tk600-two-jax-blocks"),
    pytest.param((3, 1, 1, 24, 4200, 16, False), id="two-pass-Tk4200"),
]


@pytest.mark.parametrize("case", CASES)
def test_bf16_forms_match_jax_flash_interpret(case):
    q, k, v, bias, cot = _case(*case)
    tk = case[4]
    # the two-pass case really takes the two-pass route on both sides
    assert fa.bwd_route(tk) == ("two_pass" if tk > fa.FUSE_MAX_TK else "fused")
    want = _jax_vjp(q, k, v, bias, cot)
    got = _port_vjp(q, k, v, bias, cot)
    for name, g, w in zip(("O", "dQ", "dK", "dV"), got, want):
        # both round at the same points from float32 values summed in
        # another order; at Tk 600 JAX also rounds P after a running max
        # (two key blocks): an element may land an ulp away, so 2 ulps of
        # the largest entry
        bound = 2 * ULP * np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"


def _contract(q, k, v, do, round_p_fwd=True, round_p_bwd=True, round_ds=True):
    """The bf16 rounding contract written out in float32 torch, with any
    one rounding point switchable off -> (O, dQ, dK, dV) as float32."""
    r = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = q @ k.transpose(-1, -2) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_sum = p.sum(-1, keepdim=True)
    o = r((r(p) if round_p_fwd else p) @ v / l_sum)
    lse = (m + torch.log(l_sum))[..., 0]
    p = torch.exp(s - lse[..., None])
    delta = (do * o).sum(-1)
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None]) * scale
    ds = r(ds) if round_ds else ds
    pb = r(p) if round_p_bwd else p
    return o, r(ds @ k), r(ds.transpose(-1, -2) @ q), r(pb.transpose(-1, -2) @ do)


def test_plain_forms_round_at_the_contract_points():
    # q scaled by 2: peaked probabilities, where every rounding point shows
    q, k, v, _, cot = _case(7, 2, 4, 37, 37, 64, False, q_scale=2.0)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(a)) for a in (q, k, v, cot))
    want = _jax_vjp(q, k, v, None, cot)
    got = _port_vjp(q, k, v, None, cot)
    contract = _contract(tq, tk, tv, tdo)
    # the plain forms are the contract, bit for bit
    for g, c in zip(got, contract):
        np.testing.assert_array_equal(g, c.numpy())

    def differ(outs):
        return [int((o.numpy() != w).sum()) for o, w in zip(outs, want)]

    meets = differ(contract)
    n = q.size
    # JAX's own rounding points: all but a few elements (float32 sums in
    # another order put one across a rounding boundary now and then)
    assert max(meets) <= n // 1000, meets
    # each rounding point dropped: thousands of elements move, in the
    # outputs it feeds and only there
    no_p_fwd = differ(_contract(tq, tk, tv, tdo, round_p_fwd=False))
    no_p_bwd = differ(_contract(tq, tk, tv, tdo, round_p_bwd=False))
    no_ds = differ(_contract(tq, tk, tv, tdo, round_ds=False))
    assert no_p_fwd[0] > n // 10, no_p_fwd           # O
    assert no_p_bwd[3] > n // 10, no_p_bwd           # dV
    assert min(no_ds[1:3]) > n // 10, no_ds          # dQ and dK
    assert no_p_bwd[:3] == meets[:3] and no_ds[3] == meets[3]


def test_float16_and_mixed_operands_raise():
    q, k, v, bias, cot = _case(5, 1, 1, 4, 6, 8, True)
    f32 = [torch.from_numpy(np.array(a)) for a in (q, k, v)]
    half = [t.to(torch.bfloat16) for t in f32]
    fp16 = [t.to(torch.float16) for t in f32]
    tb = torch.from_numpy(bias)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(*fp16, tb)
    with pytest.raises(ValueError, match="share one dtype"):
        fa.flash_attention(half[0], f32[1], half[2], tb)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_fwd(*fp16, tb, None, 0.0)
    o, lse = fa.flash_fwd(*half, tb, None, 0.0)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    delta = (o.float() * o.float()).sum(-1)
    # a float32 dO beside bf16 operands, in every backward form
    for form in (fa.flash_bwd_fused, fa.flash_bwd_dkv, fa.flash_bwd_dq):
        with pytest.raises(ValueError, match="share one dtype"):
            form(*half, tb, None, 0.0, o.float(), lse, delta)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            form(*fp16, tb, None, 0.0, o.half(), lse, delta)


def test_bf16_keep_mask_fraction_and_determinism():
    # the mask is the float32 forms' (a function of the seed and the
    # coordinates only); through the bf16 forward with V = 1 and no bias,
    # O's row sums of P M / l show which elements were kept
    rate, (b, h, t, d) = 0.1, (2, 4, 66, 16)
    seed = torch.tensor([2**40 + 17], dtype=torch.int64)
    q = torch.zeros(b, h, t, d, dtype=torch.bfloat16)  # uniform P = 1 / T
    v = torch.zeros(b, h, t, d, dtype=torch.bfloat16)
    v[..., 0] = 1.0
    o, _ = fa.flash_fwd(q, q, v, None, seed, rate)
    again, _ = fa.flash_fwd(q, q, v, None, seed, rate)
    assert torch.equal(o, again)  # same seed, same bits
    other, _ = fa.flash_fwd(q, q, v, None, seed + 1, rate)
    assert not torch.equal(o, other)
    mask = fa.attn_keep_mask(seed, rate, (b, h, t, t))
    kept_rows = (mask > 0).float().mean(-1)
    # O[..., 0] = the kept share / 0.9: P M = 1 / 0.9 rounds to bf16 (1.109,
    # 0.16% low) and O rounds once more, so within 2 bf16 ulps (2^-7
    # relative) of the mask's kept share per row
    want = kept_rows / (1 - rate)
    assert float(((o[..., 0].float() - want).abs() / want).max()) <= 2 * ULP
    kept = float((mask > 0).float().mean())
    sigma = np.sqrt(rate * (1 - rate) / mask.numel())
    assert abs(kept - (1 - rate)) < 6 * sigma, kept
    # rate 0 is the dropout-free forward bit for bit
    q2, k2, v2 = _bf16(*_case(6, 1, 2, 20, 20, 16, False)[:3])
    assert torch.equal(fa.flash_fwd(q2, k2, v2, None, seed, 0.0)[0],
                       fa.flash_attention(q2, k2, v2))


def test_bf16_dropout_grads_match_float32_autograd_with_the_mask():
    q, k, v, bias, cot = _case(4, 2, 2, 45, 45, 16, True)
    seed = torch.tensor([987654321], dtype=torch.int64)
    rate = 0.3
    keep = fa.attn_keep_mask(seed, rate, (2, 2, 45, 45))
    tb = torch.from_numpy(bias)

    def run(f, dtype):
        leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
        out = f(*leaves)
        out.backward(torch.from_numpy(cot).to(dtype))
        return [out.detach().float()] + [t.grad.float() for t in leaves]

    got = run(lambda *a: fa.flash_attention(*a, tb, dropout_rate=rate, dropout_seed=seed),
              torch.bfloat16)
    want = run(lambda *a: fa.attention_reference(*a, tb, keep=keep), torch.float32)
    for name, g, w in zip(("O", "dQ", "dK", "dV"), got, want):
        # the bf16 forms against exact float32 arithmetic: P M, dS and the
        # outputs rounded to bf16 (2^-9 relative each), so 2 ulps of the
        # largest entry
        bound = 2 * ULP * float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"
    # dropout really acts
    plain = fa.attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), tb)
    assert float((got[0] - plain).abs().max()) > 1e-2
