"""PyTorch port, the 3xTF32 arithmetic of the q-major flash kernels
(``csrc/flash_mma.cuh``: ``flash_fwd`` and ``flash_bwd_dq``) on the CPU.

``ops/flash_attention.py::tf32_round`` / ``matmul_3xtf32`` emulate the
kernels' products (each operand split into two TF32 values, three TF32
products, small x small dropped).  The forward and the dQ formula run
through that emulation are held against the plain versions and against the
JAX package's ``flash_attention(interpret=True)`` at the transformer
encoder's (2, 4, 372, 64) and at a long-key (1, 2, 64, 5000, 64), rate 0,
under the kernels' own bounds (O and LSE 1e-4 abs + 1e-4 rel, dQ 1e-4 of
its largest entry).  A numpy model of the m16n8k8 fragments checks the
kernels' index tricks: P multiplied straight from the accumulator
registers (permuted k order), the four-tile output order, and the Philox
words shared by shuffle.

    python tests/test_torch_port_flash_tc.py   # prints the errors of
                                               # 3xTF32 and of one TF32 pass
"""

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


def test_q_major_sources_reach_the_tile_core():
    for src in ("flash_fwd.cu", "flash_bwd_dq.cu"):
        names = [p.name for p in _build._sources(_build.CSRC / src, [])]
        assert names == [src, "flash_mma.cuh", "philox.cuh"]
    assert fa.FLASH_BWD_DQ.source == "flash_bwd_dq"
    assert fa.FLASH_FWD.source == "flash_fwd"


def _errors():
    """Max abs errors of O, LSE and dQ (dQ relative to its largest entry)
    against the plain versions, in 3xTF32 and in one TF32 pass."""
    out = {}
    for name in SHAPES:
        _, (q, k, v, bias, do), o_ref, lse_ref, delta = _case(name)
        dq_ref = fa.flash_bwd_reference(q, k, v, bias, None, 0.0, do, lse_ref, delta)[0]
        for label, mm in (("3xTF32", fa.matmul_3xtf32), ("1xTF32", _tf32_once)):
            o, lse = fwd_emulated(q, k, v, bias, mm)
            dq = dq_emulated(q, k, v, bias, do, lse_ref, delta, mm)
            out[(name, label)] = (float((o - o_ref).abs().max()),
                                  float((lse - lse_ref).abs().max()),
                                  float((dq - dq_ref).abs().max() / dq_ref.abs().max()))
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    for (name, label), (eo, el, edq) in _errors().items():
        print(f"{name} {label}: O max abs err {eo:.3e}, LSE {el:.3e}, "
              f"dQ {edq:.3e} of its largest entry (bounds 1e-4)")
