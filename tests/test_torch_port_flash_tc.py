"""PyTorch port, the 3xTF32 arithmetic of the tensor-core flash kernels
(``csrc/flash_mma.cuh``: ``flash_fwd`` and ``flash_bwd_dq``, q-major, and
``flash_bwd_fused``, kv-major) on the CPU.

``ops/flash_attention.py::tf32_round`` / ``matmul_3xtf32`` emulate the
kernels' products (each operand split into two TF32 values, three TF32
products, small x small dropped).  The forward, the dQ formula and the
fused backward (its products in the kernel's kv-major order: S^T = K Q^T,
dP^T = V dO^T, dV = (P M)^T dO, dK = dS^T Q, dQ = dS K) run through that
emulation are held against the plain versions and against the JAX
package's ``flash_attention(interpret=True)`` (its gradients by
``jax.grad``) at the transformer encoder's (2, 4, 372, 64) and at a
long-key (1, 2, 64, 5000, 64), rate 0, under the kernels' own bounds (O and
LSE 1e-4 abs + 1e-4 rel, a gradient 1e-4 of its largest entry); the fused
backward also at rate 0.1 against the plain version, and one TF32 pass
shown to miss that bound; its dK / dV form (the kernel without the dQ
phase, ``flash_bwd_dkv``) against the JAX package's two-pass route
(``_bwd_dkv_kernel``, past ``_FUSE_MAX_NK`` key blocks).  A numpy model of the m16n8k8 fragments checks
the kernels' index tricks: P multiplied straight from the accumulator
registers (permuted k order), the four-tile output order, the Philox words
shared by shuffle in both layouts, and the fused backward's dS transpose
through shared memory into dQ.

    python tests/test_torch_port_flash_tc.py   # prints the errors of
                                               # 3xTF32 and of one TF32 pass
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from multimodal_emotion_detection_tpu_torch.ops import _build
from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

# the module (the package's ops namespace exports its function by the same name)
jax_fa = importlib.import_module("multimodal_emotion_detection_tpu.ops.flash_attention")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these small
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The kernels' formulas with their products emulated
# ---------------------------------------------------------------------------


def _tf32_once(a, b):
    """One TF32 pass, for comparison only: no kernel does this."""
    return torch.matmul(fa.tf32_round(a), fa.tf32_round(b))


def fwd_emulated(q, k, v, bias, mm=fa.matmul_3xtf32):
    """flash_fwd.cu at rate 0 with its products as ``mm`` -> (O, LSE)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    lse = torch.logsumexp(s, dim=-1)
    return mm(torch.exp(s - lse[..., None]), v), lse


def dq_emulated(q, k, v, bias, do, lse, delta, mm=fa.matmul_3xtf32):
    """flash_bwd_dq.cu at rate 0 with its products as ``mm`` -> dQ."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    ds = p * (mm(do, v.transpose(-1, -2)) - delta[..., None]) * scale
    return mm(ds, k)


def fused_bwd_emulated(q, k, v, bias, seed, rate, do, lse, delta, mm=fa.matmul_3xtf32,
                       dq=True):
    """flash_bwd_fused.cu with its products as ``mm``, each with the
    kernel's A and B operands: kv-major scores S^T = K Q^T and dP^T = V dO^T
    (keys as rows), P^T with the key bias per row and LSE and Delta per
    column, the mask transposed, then dV = (P M)^T dO, dK = dS^T Q and dQ =
    dS K -> (dQ, dK, dV); its dK / dV form (``dq=False``, the kernel
    compiled without the dQ phase) -> (dK, dV)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    st = mm(k, q.transpose(-1, -2)) * scale
    if bias is not None:
        st = st + bias[:, None, :, None]
    pt = torch.exp(st - lse[..., None, :])
    dpt = mm(v, do.transpose(-1, -2))
    mt = 1.0
    if rate > 0.0:
        b, h, tq, _ = q.shape
        mt = fa.attn_keep_mask(seed, rate, (b, h, tq, k.shape[2])).transpose(-1, -2)
    dst = pt * (dpt * mt - delta[..., None, :]) * scale
    dkv = (mm(dst, q), mm(pt * mt, do))
    return (mm(dst.transpose(-1, -2), k), *dkv) if dq else dkv


SHAPES = {
    "encoder-2x4x372x64": (2, 4, 372, 372, 64, False),
    "long-1x2x64x5000x64-masked": (1, 2, 64, 5000, 64, True),
}


def _inputs(b, h, tq, tk, d, masked, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, tk, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    bias = None
    if masked:
        keep = rng.random((b, tk)) > 0.2
        keep[:, 0] = True
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    return q, k, v, bias, do


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _case(name):
    q, k, v, bias, do = _inputs(*SHAPES[name])
    tq, tk, tv, tb, tdo = map(_t, (q, k, v, bias, do))
    o_ref, lse_ref = fa.flash_fwd_reference(tq, tk, tv, tb, None, 0.0)
    delta = (tdo * o_ref).sum(-1)
    return (q, k, v, bias, do), (tq, tk, tv, tb, tdo), o_ref, lse_ref, delta


@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_in_3xtf32_matches_plain_and_jax(name):
    arrays, (q, k, v, bias, _), o_ref, lse_ref, _ = _case(name)
    o, lse = fwd_emulated(q, k, v, bias)
    # the kernels' bounds (chip_smoke.py [flash_fwd])
    torch.testing.assert_close(o, o_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    jargs = [None if a is None else jnp.asarray(a) for a in arrays[:4]]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_flash_attention(*jargs, interpret=True))
    np.testing.assert_allclose(o.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(SHAPES))
def test_dq_in_3xtf32_matches_plain_and_jax(name):
    arrays, (q, k, v, bias, do), _, lse_ref, delta = _case(name)
    dq = dq_emulated(q, k, v, bias, do, lse_ref, delta)
    want_plain = fa.flash_bwd_reference(q, k, v, bias, None, 0.0, do, lse_ref, delta)[0]
    jq, jk, jv = (jnp.asarray(a) for a in arrays[:3])
    jbias = None if arrays[3] is None else jnp.asarray(arrays[3])
    cot = jnp.asarray(arrays[4])

    def loss(q_):
        return jnp.sum(jax_flash_attention(q_, jk, jv, jbias, interpret=True) * cot)

    with jax.default_matmul_precision("highest"):
        want_jax = np.asarray(jax.grad(loss)(jq))
    for want in (want_plain.numpy(), want_jax):
        # a gradient sums up to Tk terms: 1e-4 of its largest entry
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(dq.numpy(), want, rtol=1e-4, atol=1e-4 * scale)


def _close_to_largest(got, want, what):
    # a gradient sums up to T terms: 1e-4 of its largest entry
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=what)


@pytest.mark.parametrize("name", list(SHAPES))
def test_fused_bwd_in_3xtf32_matches_plain_and_jax(name):
    arrays, (q, k, v, bias, do), _, lse_ref, delta = _case(name)
    got = fused_bwd_emulated(q, k, v, bias, None, 0.0, do, lse_ref, delta)
    plain = fa.flash_bwd_reference(q, k, v, bias, None, 0.0, do, lse_ref, delta)
    jq, jk, jv = (jnp.asarray(a) for a in arrays[:3])
    jbias = None if arrays[3] is None else jnp.asarray(arrays[3])
    cot = jnp.asarray(arrays[4])

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash_attention(q_, k_, v_, jbias, interpret=True) * cot)

    with jax.default_matmul_precision("highest"):
        want_jax = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for label, g, p, j in zip(("dQ", "dK", "dV"), got, plain, want_jax):
        _close_to_largest(g.numpy(), p.numpy(), f"{label} vs plain")
        _close_to_largest(g.numpy(), np.asarray(j), f"{label} vs JAX")


def test_fused_bwd_in_3xtf32_with_dropout_matches_plain():
    # rate 0.1 (the transformer config's training rate): the mask enters
    # transposed, one Philox word per (key, query)
    _, (q, k, v, bias, do), _, _, _ = _case("encoder-2x4x372x64")
    seed = torch.tensor([0x5EED_0F_F1A5], dtype=torch.int64)
    o, lse = fa.flash_fwd_reference(q, k, v, bias, seed, 0.1)
    args = (q, k, v, bias, seed, 0.1, do, lse, (do * o).sum(-1))
    for label, g, p in zip(("dQ", "dK", "dV"), fused_bwd_emulated(*args),
                           fa.flash_bwd_reference(*args)):
        _close_to_largest(g.numpy(), p.numpy(), label)


@pytest.mark.parametrize("masked", [False, True])
def test_dkv_form_in_3xtf32_matches_jax_two_pass_and_plain(masked):
    # the two-pass route of the JAX package: 160 keys in blocks of 16 are 10
    # key blocks, past its _FUSE_MAX_NK, so jax.grad runs _bwd_dkv_kernel
    # (and _bwd_dq_kernel) in interpret mode; the port's dK / dV form
    # against its dK and dV and against the plain version
    b, h, tq, tk, d = 1, 2, 48, 160, 64
    assert tk // 16 > jax_fa._FUSE_MAX_NK
    q, k, v, bias, do = _inputs(b, h, tq, tk, d, masked, seed=11)
    tq_, tk_, tv_, tb_, tdo_ = map(_t, (q, k, v, bias, do))
    o, lse = fa.flash_fwd_reference(tq_, tk_, tv_, tb_, None, 0.0)
    args = (tq_, tk_, tv_, tb_, None, 0.0, tdo_, lse, (tdo_ * o).sum(-1))
    got = fused_bwd_emulated(*args, dq=False)
    assert len(got) == 2
    jbias = None if bias is None else jnp.asarray(bias)
    cot = jnp.asarray(do)

    def loss(k_, v_):
        out = jax_flash_attention(jnp.asarray(q), k_, v_, jbias, block_q=16,
                                  block_k=16, interpret=True)
        return jnp.sum(out * cot)

    with jax.default_matmul_precision("highest"):
        want_jax = jax.grad(loss, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(v))
    for label, g, p, j in zip(("dK", "dV"), got, fa.flash_bwd_reference(*args)[1:],
                              want_jax):
        _close_to_largest(g.numpy(), p.numpy(), f"{label} vs plain")
        _close_to_largest(g.numpy(), np.asarray(j), f"{label} vs JAX two-pass")
    # the same products as the fused form's: its dK and dV exactly
    full = fused_bwd_emulated(*args)
    for g, f in zip(got, full[1:]):
        assert torch.equal(g, f)


def test_one_tf32_pass_misses_the_fused_bound():
    # the three passes are needed: one TF32 product per product misses the
    # kernels' 1e-4 of the largest entry
    _, (q, k, v, bias, do), _, lse_ref, delta = _case("encoder-2x4x372x64")
    args = (q, k, v, bias, None, 0.0, do, lse_ref, delta)
    plain = fa.flash_bwd_reference(*args)
    once = fused_bwd_emulated(*args, mm=_tf32_once)
    errs = [float((g - p).abs().max() / max(float(p.abs().max()), 1.0))
            for g, p in zip(once, plain)]
    assert max(errs) > 1e-4, errs


# ---------------------------------------------------------------------------
# tf32_round / matmul_3xtf32
# ---------------------------------------------------------------------------


def test_tf32_round_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 4, 1.0 + 3 * ulp / 4,
                      -(1.0 + ulp / 2), 3.0, 1.0 + ulp, 0.0, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + ulp, 1.0, 1.0 + ulp, -(1.0 + ulp), 3.0,
                         1.0 + ulp, 0.0, -0.0], dtype=torch.float32)
    got = fa.tf32_round(x)
    assert torch.equal(got, want)
    rng = np.random.default_rng(3)
    y = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(
        -20, 20, 4096)).astype(np.float32))
    r = fa.tf32_round(y)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()  # low 13 bits clear
    # nearest: within half a TF32 ulp of the input
    assert ((r - y).abs() <= y.abs() * 2.0 ** -11 * (1 + 1e-6)).all()
    # the split is exact to about 2^-24: big + small recovers the input
    small = fa.tf32_round(y - r)
    assert ((r + small - y).abs() <= y.abs() * 2.0 ** -21).all()


def test_matmul_3xtf32_keeps_float32_accuracy():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 372)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    three = fa.matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(b)).double().numpy()
    f32 = (torch.from_numpy(a) @ torch.from_numpy(b)).double().numpy()
    scale = np.abs(exact).max()
    # as close to the exact product as a float32 product is, within 4x
    assert np.abs(three - exact).max() <= 4 * max(np.abs(f32 - exact).max(), 1e-7 * scale)


# ---------------------------------------------------------------------------
# Fragment model: the kernels' index tricks
# ---------------------------------------------------------------------------


def _mma_m16n8k8(afrag, bfrag):
    """D = A B of mma.m16n8k8 from per-lane fragments (PTX ISA layouts):
    a[lane] = (A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]), b[lane] =
    (B[t][g], B[t+4][g]); returns d[lane] = (D[g][2t], D[g][2t+1],
    D[g+8][2t], D[g+8][2t+1])."""
    a = np.zeros((16, 8))
    b = np.zeros((8, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = afrag[lane]
        b[t, g], b[t + 4, g] = bfrag[lane]
    d = a @ b
    return [(d[l // 4, 2 * (l % 4)], d[l // 4, 2 * (l % 4) + 1],
             d[l // 4 + 8, 2 * (l % 4)], d[l // 4 + 8, 2 * (l % 4) + 1])
            for l in range(32)]


def test_pb_from_accumulator_registers_and_four_tile_output_order():
    # flash_mma.cuh::mma_pb: P (16 x 8 keys) as it sits in an m16n8 score
    # accumulator is used as the A fragment as it is, with k column t meaning
    # key 2t and t + 4 key 2t + 1; output tile 4m + e, n column c is head
    # dim 32m + 4c + e; store_rows writes dims 32m + 8t + e (and + 4)
    rng = np.random.default_rng(11)
    dp = 64
    p = rng.standard_normal((16, 8))
    x = rng.standard_normal((8, dp))  # (keys, head dims)
    acc_p = [(p[l // 4, 2 * (l % 4)], p[l // 4, 2 * (l % 4) + 1],
              p[l // 4 + 8, 2 * (l % 4)], p[l // 4 + 8, 2 * (l % 4) + 1])
             for l in range(32)]
    afrag = [(c[0], c[2], c[1], c[3]) for c in acc_p]
    out = np.full((16, dp), np.nan)
    for n in range(dp // 8):
        m, e = n // 4, n % 4
        bfrag = []
        for lane in range(32):
            g, t = lane // 4, lane % 4
            dim = 32 * m + 4 * g + e
            bfrag.append((x[2 * t, dim], x[2 * t + 1, dim]))
        d = _mma_m16n8k8(afrag, bfrag)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for hf in range(2):
                for half in range(2):
                    out[g + 8 * hf, 32 * m + 8 * t + 4 * half + e] = d[lane][2 * hf + half]
    np.testing.assert_allclose(out, p @ x, rtol=1e-12, atol=1e-12)


def test_abt_fragment_reads_give_scores():
    # mma_abt: A = the warp's rows (a0 = row g, column 8ks + t, ...), B read
    # from the key-major tile at rows 8j + g, columns 8ks + t and + 4
    rng = np.random.default_rng(12)
    qa = rng.standard_normal((16, 64))
    kt = rng.standard_normal((8, 64))
    acc = np.zeros((32, 4))
    for ks in range(8):
        afrag = [(qa[l // 4, 8 * ks + l % 4], qa[l // 4 + 8, 8 * ks + l % 4],
                  qa[l // 4, 8 * ks + l % 4 + 4], qa[l // 4 + 8, 8 * ks + l % 4 + 4])
                 for l in range(32)]
        bfrag = [(kt[l // 4, 8 * ks + l % 4], kt[l // 4, 8 * ks + l % 4 + 4])
                 for l in range(32)]
        acc += np.array(_mma_m16n8k8(afrag, bfrag))
    s = qa @ kt.T
    for lane in range(32):
        g, t = lane // 4, lane % 4
        np.testing.assert_allclose(acc[lane], [s[g, 2 * t], s[g, 2 * t + 1],
                                               s[g + 8, 2 * t], s[g + 8, 2 * t + 1]])


def test_keep_bits_shuffles_give_the_plain_mask():
    # flash_mma.cuh::keep_bits / keep_scales: lane L makes the Philox call
    # of four-row group (i0 / 4 + L / 8) at key j0 + L % 8 and packs its 4
    # keep bits; lane (g, t) takes bit g % 4 from lanes 8 (g / 4) + 2t (+1,
    # +16, +17)
    seed = torch.tensor([0x5EED_0F_F1A5], dtype=torch.int64)
    rate, b, h = 0.1, 1, 3
    shape = (b + 1, h + 1, 48, 40)
    mask = fa.attn_keep_mask(seed, rate, shape)[b, h] > 0
    s = int(seed)
    key = (torch.tensor(s & 0xFFFFFFFF), torch.tensor((s >> 32) & 0xFFFFFFFF))
    thr = fa.drop_threshold(rate)
    for i0, j0 in ((0, 0), (16, 8), (32, 32)):
        lanes = torch.arange(32)
        words = fa.philox4x32(((j0 + lanes % 8), (i0 // 4 + lanes // 8),
                               torch.full((32,), h), torch.full((32,), b)), key)
        bits = sum((w >= thr).long() << e for e, w in enumerate(words))
        for lane in range(32):
            g, t = lane // 4, lane % 4
            src, e = 8 * (g // 4) + 2 * t, g % 4
            got = [(int(bits[src + o]) >> e) & 1 for o in (0, 1, 16, 17)]
            want = [mask[i0 + g, j0 + 2 * t], mask[i0 + g, j0 + 2 * t + 1],
                    mask[i0 + g + 8, j0 + 2 * t], mask[i0 + g + 8, j0 + 2 * t + 1]]
            assert got == [int(w) for w in want], (i0, j0, lane)


def test_keep_bits_kv_shuffles_give_the_plain_mask():
    # flash_mma.cuh::keep_bits_kv / keep_scales_kv: lane L makes the Philox
    # call of key j0 + L % 16 and four-query group i0 / 4 + L / 16; lane (g,
    # t) takes words 2 (t % 2) and + 1 of lanes 16 (t / 2) + g (key g) and +
    # 8 (key g + 8), for queries i0 + 2t and + 1
    seed = torch.tensor([0x5EED_0F_F1A5], dtype=torch.int64)
    rate, b, h = 0.1, 1, 3
    shape = (b + 1, h + 1, 48, 80)
    mask = fa.attn_keep_mask(seed, rate, shape)[b, h] > 0
    s = int(seed)
    key = (torch.tensor(s & 0xFFFFFFFF), torch.tensor((s >> 32) & 0xFFFFFFFF))
    thr = fa.drop_threshold(rate)
    for i0, j0 in ((0, 0), (8, 16), (40, 64)):
        lanes = torch.arange(32)
        words = fa.philox4x32(((j0 + lanes % 16), (i0 // 4 + lanes // 16),
                               torch.full((32,), h), torch.full((32,), b)), key)
        bits = sum((w >= thr).long() << e for e, w in enumerate(words))
        for lane in range(32):
            g, t = lane // 4, lane % 4
            src, e = 16 * (t // 2) + g, 2 * (t % 2)
            got = [(int(bits[src]) >> e) & 1, (int(bits[src]) >> (e + 1)) & 1,
                   (int(bits[src + 8]) >> e) & 1, (int(bits[src + 8]) >> (e + 1)) & 1]
            want = [mask[i0 + 2 * t, j0 + g], mask[i0 + 2 * t + 1, j0 + g],
                    mask[i0 + 2 * t, j0 + g + 8], mask[i0 + 2 * t + 1, j0 + g + 8]]
            assert got == [int(w) for w in want], (i0, j0, lane)


def test_ds_transpose_through_shared_memory_gives_dq():
    # flash_bwd_fused.cu: warp w's dS^T fragments (keys 16w + g (+ 8),
    # queries 8j + 2t (+ 1)) written at (query) * SD + key; warp w of the
    # dQ product reads rows 16 (w % 2) + g (+ 8), keys 8j + 2t (+ 1) as its
    # A fragment and multiplies by K over head-dim half w / 2
    # (mma_pb_cols), which gives dS K
    rng = np.random.default_rng(13)
    tq, tk, dp, sd = 32, 64, 64, 72
    ds = rng.standard_normal((tq, tk))
    kt = rng.standard_normal((tk, dp))
    smem = np.full(tq * sd, np.nan)
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for j in range(tq // 8):
                for e in range(4):
                    q_, key = 8 * j + 2 * t + (e & 1), 16 * w + g + 8 * (e >> 1)
                    smem[q_ * sd + key] = ds[q_, key]
    out = np.full((tq, dp), np.nan)
    for w in range(4):
        rq0, m0 = 16 * (w % 2), w // 2
        acc = {}
        for jk in range(tk // 8):
            acc_p = []
            for lane in range(32):
                g, t = lane // 4, lane % 4
                r = (rq0 + g) * sd + 8 * jk + 2 * t
                acc_p.append((smem[r], smem[r + 1], smem[r + 8 * sd], smem[r + 8 * sd + 1]))
            afrag = [(c[0], c[2], c[1], c[3]) for c in acc_p]
            for e in range(4):
                bfrag = []
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    dim = 32 * m0 + 4 * g + e
                    bfrag.append((kt[8 * jk + 2 * t, dim], kt[8 * jk + 2 * t + 1, dim]))
                d = np.array(_mma_m16n8k8(afrag, bfrag))
                acc[e] = acc.get(e, 0) + d
        for e in range(4):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for hf in range(2):
                    for half in range(2):
                        out[rq0 + g + 8 * hf, 32 * m0 + 8 * t + 4 * half + e] = \
                            acc[e][lane][2 * hf + half]
    assert not np.isnan(smem).reshape(tq, sd)[:, :tk].any()
    np.testing.assert_allclose(out, ds @ kt, rtol=1e-12, atol=1e-12)


def test_fused_backward_source_reaches_the_tile_core():
    # the fused backward is the tensor-core kv-major kernel, and the two-pass
    # form's dK / dV entry is the same kernel without its dQ phase: both
    # entries in one source on the tile core, the float32 dK / dV kernel
    # and its tiles gone
    names = [p.name for p in _build._sources(_build.CSRC / "flash_bwd_fused.cu", [])]
    assert names == ["flash_bwd_fused.cu", "flash_mma.cuh", "philox.cuh"]
    assert fa.FLASH_BWD_FUSED.source == "flash_bwd_fused"
    text = (_build.CSRC / "flash_bwd_fused.cu").read_text()
    # K and V as the A operands of the score products; the kv-major mask
    for call in ("mma_abt<", ", ka, va);", "keep_bits_kv(", "mma_pb_cols<"):
        assert call in text, call
    assert "flash_bwd_dkv_launch" in text and "flash_bwd_fused_launch" in text
    assert "run<false>" in text and "run<true>" in text
    assert fa.FLASH_BWD_DKV.source == "flash_bwd_fused"
    for gone in ("flash_bwd.cu", "flash_common.cuh"):
        assert not (_build.CSRC / gone).exists(), gone


def test_q_major_sources_reach_the_tile_core():
    for src in ("flash_fwd.cu", "flash_bwd_dq.cu"):
        names = [p.name for p in _build._sources(_build.CSRC / src, [])]
        assert names == [src, "flash_mma.cuh", "philox.cuh"]
    assert fa.FLASH_BWD_DQ.source == "flash_bwd_dq"
    assert fa.FLASH_FWD.source == "flash_fwd"


def _errors():
    """Max abs errors of O, LSE, dQ and of the fused backward's dQ, dK and
    dV (each gradient relative to its largest entry) against the plain
    versions, in 3xTF32 and in one TF32 pass."""
    out = {}
    for name in SHAPES:
        _, (q, k, v, bias, do), o_ref, lse_ref, delta = _case(name)
        args = (q, k, v, bias, None, 0.0, do, lse_ref, delta)
        refs = fa.flash_bwd_reference(*args)

        def rel(g, r):
            return float((g - r).abs().max() / r.abs().max())

        for label, mm in (("3xTF32", fa.matmul_3xtf32), ("1xTF32", _tf32_once)):
            o, lse = fwd_emulated(q, k, v, bias, mm)
            dq = dq_emulated(q, k, v, bias, do, lse_ref, delta, mm)
            fused = fused_bwd_emulated(*args, mm=mm)
            out[(name, label)] = (float((o - o_ref).abs().max()),
                                  float((lse - lse_ref).abs().max()), rel(dq, refs[0]),
                                  *(rel(g, r) for g, r in zip(fused, refs)))
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    for (name, label), (eo, el, edq, fq, fk, fv) in _errors().items():
        print(f"{name} {label}: O max abs err {eo:.3e}, LSE {el:.3e}, "
              f"dQ {edq:.3e}; fused backward dQ {fq:.3e}, dK {fk:.3e}, dV {fv:.3e} "
              "of the largest entry (bounds 1e-4)")
