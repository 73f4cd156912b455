"""Flash attention: CUDA kernels + plain PyTorch versions.

The JAX package's layout at the public function: ``flash_attention(q, k, v,
bias=None, *, dropout_rate=0.0, dropout_seed=None)`` takes q (B, H, Tq, D),
k and v (B, H, Tk, D), all float32 or all bfloat16, and an optional (B, Tk)
additive key bias (0 valid, -1e9 masked; a mask, so it gets no gradient;
float32 whatever the operands).  Scale is 1/sqrt(D); any Tq, Tk >= 1 is
taken.  Other dtypes (float16) and mixed operands raise.

Four kernels, each in a float32 and a bf16 form, each form behind a wrapper
with its own launch counter (``FLASH_FWD`` / ``FLASH_FWD_BF16`` and so on):

* ``flash_fwd`` (``csrc/flash_fwd.cu``; bf16: ``csrc/flash_fwd_bf16.cu``):
  online-softmax attention, writes O and the per-row logsumexp LSE (B, H,
  Tq);
* ``flash_bwd_fused``: the backward that recomputes the probabilities from
  LSE in one launch.  The float32 form (``csrc/flash_bwd_fused.cu``) is
  kv-major, accumulates dK and dV on chip and writes each kv span's dQ
  partial to its own slot, which the wrapper sums (no atomics, so the
  result is deterministic); the bf16 form (``csrc/flash_bwd_bf16.cu``)
  runs a kv-major role for dK / dV and a q-major role that sums dQ over
  every key on chip, so it writes dQ once, in bf16;
* ``flash_bwd_dkv`` (the fused kernels' dK/dV form, without dQ) and
  ``flash_bwd_dq`` (``csrc/flash_bwd_dq.cu``; bf16: the dQ form of
  ``csrc/flash_bwd_bf16.cu``): the two-pass backward for long key
  sequences, dK and dV kv-major, dQ q-major.

The float32 forms run their products on the tensor cores in 3xTF32
(``csrc/flash_mma.cuh``): each float32 operand is split into two TF32
values and a product is three TF32 MMAs, which keeps float32 accuracy.
``tf32_round`` and ``matmul_3xtf32`` emulate that arithmetic on the CPU for
the tests; no path of the port calls them.

The bf16 forms take bf16 q, k, v and dO as the JAX kernels take them: the
products' operands stay bf16 (one bf16 MMA each) and accumulate in
float32; S, the softmax statistics, LSE, Delta and dP are float32; P (times
the keep mask) is rounded to bf16 before P V and P^T dO, dS before dS^T Q
and dS K; O, dK, dV and dQ are rounded to bf16 once.  O, dQ, dK and dV
come out bf16, LSE float32.  The bf16 forms run on Hopper's warpgroup
MMAs over tiles that TMA loads
(``csrc/flash_wgmma.cuh``); ``flash_bf16_plan`` is their launch plan, and
TMA's 16-byte rows make the wrapper pad a head dim that is not a multiple
of 8 with zero columns (``_tma_operand``).  Their plain versions
(``flash_fwd_reference`` and ``flash_bwd_reference`` on bf16 inputs)
compute in float32 from the upcast operands and round at exactly those
points, with P taken after the row's final max (the JAX kernel's
one-block form, T <= 512); the kernels round P relative to the running
max of their key tiles, which can put an element an ulp away.

``flash_fwd`` calls the custom op ``med_torch::flash_fwd`` (both dtypes;
``_build.kernel_op``), so ``torch.export`` traces a forward as one node.
``FlashAttention`` (an ``autograd.Function``) saves (q, k, v, bias, seed,
O, LSE); its backward forms Delta = rowsum(dO * O) in float32 and takes the
fused or the two-pass form by ``bwd_route(Tk)``, as the JAX package does
past 8 blocks of 512 keys.

Attention-probability dropout follows torch's semantics, as the JAX
kernel's: the softmax normaliser comes from the undropped probabilities,
only the P V stream is masked and rescaled by 1/(1 - rate).  The keep mask
is a pure function of (seed, b, h, i, j): Philox4x32-10 keyed by the
call's int64 seed (low word, high word), counter (j, i // 4, h, b), the
output word i % 4; an element is kept iff that word >= min(floor(rate *
2**32), 2**32 - 1).  ``attn_keep_mask`` computes it in torch integer ops,
the kernels in ``csrc/philox.cuh``, so the mask on the card and on the CPU
is the same, and the backward regenerates the forward's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from multimodal_emotion_detection_tpu_torch.ops._build import (
    CudaKernel,
    check_cuda,
    kernel_op,
    stream_of,
)

MASKED = -1e9  # additive bias of a masked key (the JAX package's convention)
# past this many keys the two-pass form takes over, as the JAX package's
# _FUSE_MAX_NK = 8 blocks of 512; below it the float32 fused backward's dQ
# partials (one slot per kv span, at most MAX_SPANS) stay <= 8 x |dQ|
FUSE_MAX_TK = 4096
MAX_SPANS = 8
KV_TILE = 64  # keys per tile of the kernels
MAX_HEAD_DIM = 128
# the bf16 kernels (csrc/flash_fwd_bf16.cu, csrc/flash_bwd_bf16.cu): 64-row
# tiles, rings of two stages (the forward) and three (the backward and its
# dQ form), CTAs of one warpgroup, 64-column TMA boxes of 128 bytes a row
BF16_TILE = 64
BF16_FWD_STAGES = 2
BF16_BWD_STAGES = 3
BF16_DQ_STAGES = 3
BF16_THREADS = 128
SMEM_LIMIT = 232448  # shared memory a CTA may use on the H100

# ---------------------------------------------------------------------------
# Dropout mask: Philox4x32-10 in torch integer ops
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product a * x, for a 32-bit
    constant ``a`` and int64 ``x`` in [0, 2**32): the product overflows
    int64, so it is formed from a's 16-bit halves."""
    p_lo = x * (a & 0xFFFF)  # < 2**48
    p_hi = x * (a >> 16)  # < 2**48
    s = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (s >> 32), s & _U32


def philox4x32(counter, key):
    """Philox4x32-10 (Random123): four int64 tensors of 32-bit words
    (broadcastable) and a key of two -> the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def drop_threshold(rate: float) -> int:
    """The 32-bit word below which an element is dropped."""
    return min(int(math.floor(rate * 4294967296.0)), _U32)


def attn_keep_mask(seed: torch.Tensor, rate: float, shape) -> torch.Tensor:
    """The (B, H, Tq, Tk) float32 keep mask of one attention call: 0 for a
    dropped element, 1/(1 - rate) for a kept one.  ``seed`` is the call's
    int64 tensor of one element (on any device; read without a host sync)."""
    b, h, tq, tk = shape
    dev = seed.device
    s = seed.reshape(()).to(torch.int64)
    key = (s & _U32, (s >> 32) & _U32)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa: E731
    counter = (ar(tk).view(1, 1, 1, tk), ar((tq + 3) // 4).view(1, 1, -1, 1),
               ar(h).view(1, h, 1, 1), ar(b).view(b, 1, 1, 1))
    words = torch.stack(philox4x32(counter, key), dim=3)  # (B, H, Tq/4, 4, Tk)
    words = words.reshape(b, h, -1, tk)[:, :, :tq]
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=dev)
    return (words >= drop_threshold(rate)).to(torch.float32) * scale


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def attention_reference(q, k, v, bias=None, keep=None) -> torch.Tensor:
    """Plain softmax attention with the kernels' scale and bias
    conventions; ``keep`` (B, H, Tq, Tk), e.g. ``attn_keep_mask``'s,
    multiplies the probabilities after the softmax.  Differentiable."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = p * keep
    return torch.matmul(p, v)


def _probs(q, k, bias, lse=None):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    return torch.exp(s - lse[..., None]), lse, scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 value (ties to even), kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def flash_fwd_reference(q, k, v, bias, seed, rate: float):
    """Plain version of the forward kernel -> (O (B, H, Tq, D) in the
    operands' dtype, LSE (B, H, Tq) float32).

    On bf16 operands: S from the upcast operands in float32, P = exp(S - m)
    after the row's max m, l = rowsum(P) and LSE = m + log(l) in float32, P
    (times the keep mask) rounded to bf16, O = (P V) / l rounded to bf16
    once, the rounding points of the JAX kernel in one key block."""
    if q.dtype != torch.bfloat16:
        p, lse, _ = _probs(q, k, bias)
        if rate > 0.0:
            p = p * attn_keep_mask(seed, rate, p.shape)
        return torch.matmul(p, v), lse
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l_sum))[..., 0]
    if rate > 0.0:
        p = p * attn_keep_mask(seed, rate, p.shape)
    o = torch.matmul(_bf16(p), v.float()) / l_sum
    return o.to(torch.bfloat16), lse


def flash_bwd_reference(q, k, v, bias, seed, rate: float, do, lse, delta):
    """Plain version of the backward kernels' contract -> (dQ, dK, dV), in
    the operands' dtype.

    P = exp(S - LSE); with M the keep mask (1/(1 - rate) where kept),
    dV = (P M)^T dO, dS = P (M (dO V^T) - Delta) / sqrt(D), dQ = dS K,
    dK = dS^T Q; Delta = rowsum(dO O) is unchanged by dropout.  On bf16
    operands everything is float32 from the upcast operands except that P M
    and dS are rounded to bf16 before they enter a product and dQ, dK, dV
    are rounded to bf16 at the end."""
    half = q.dtype == torch.bfloat16
    if half:
        q, k, v, do = (x.float() for x in (q, k, v, do))
    p, _, scale = _probs(q, k, bias, lse)
    dp = torch.matmul(do, v.transpose(-1, -2))
    p_drop = p
    if rate > 0.0:
        keep = attn_keep_mask(seed, rate, p.shape)
        p_drop, dp = p * keep, dp * keep
    ds = p * (dp - delta[..., None]) * scale
    if half:
        p_drop, ds = _bf16(p_drop), _bf16(ds)
    grads = (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
             torch.matmul(p_drop.transpose(-1, -2), do))
    return tuple(g.to(torch.bfloat16) for g in grads) if half else grads


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: the low 13 bits of the magnitude rounded
    half up (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the tensor-core kernels form it (``csrc/flash_mma.cuh``): each
    operand split into big = tf32(x) and small = tf32(x - big), the product
    small·big + big·small + big·big (small·small dropped), float32 sums."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = tf32_round(a - a_big), tf32_round(b - b_big)
    return (torch.matmul(a_small, b_big) + torch.matmul(a_big, b_small)
            + torch.matmul(a_big, b_big))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_U, _F = ctypes.c_uint, ctypes.c_float
_FWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _U, _F, _P]
FLASH_FWD = CudaKernel("flash_fwd", "flash_fwd_launch", _FWD_ARGS)
_BWD_ARGS = [_P] * 11 + [_I] * 6 + [_F, _U, _F, _P]
FLASH_BWD_FUSED = CudaKernel("flash_bwd_fused", "flash_bwd_fused_launch", _BWD_ARGS)
FLASH_BWD_DKV = CudaKernel("flash_bwd_fused", "flash_bwd_dkv_launch", _BWD_ARGS)
FLASH_BWD_DQ = CudaKernel("flash_bwd_dq", "flash_bwd_dq_launch", _BWD_ARGS)
# the bf16 forms, counted apart: the forward and the fused backward (and its
# dK / dV and dQ forms) on wgmma and TMA, with the plan's numbers in their
# arguments
_FWD_BF16_ARGS = [_P] * 7 + [_I] * 7 + [_F, _U, _F, _P]
_BWD_BF16_ARGS = [_P] * 11 + [_I] * 8 + [_F, _U, _F, _P]
FLASH_FWD_BF16 = CudaKernel("flash_fwd_bf16", "flash_fwd_bf16_launch", _FWD_BF16_ARGS)
FLASH_BWD_FUSED_BF16 = CudaKernel("flash_bwd_bf16", "flash_bwd_fused_bf16_launch",
                                  _BWD_BF16_ARGS)
FLASH_BWD_DKV_BF16 = CudaKernel("flash_bwd_bf16", "flash_bwd_dkv_bf16_launch",
                                _BWD_BF16_ARGS)
FLASH_BWD_DQ_BF16 = CudaKernel("flash_bwd_bf16", "flash_bwd_dq_bf16_launch",
                               _BWD_BF16_ARGS)
# operand dtype -> its kernel forms
_FORMS = {torch.float32: dict(fwd=FLASH_FWD, fused=FLASH_BWD_FUSED, dkv=FLASH_BWD_DKV,
                              dq=FLASH_BWD_DQ),
          torch.bfloat16: dict(fwd=FLASH_FWD_BF16, fused=FLASH_BWD_FUSED_BF16,
                               dkv=FLASH_BWD_DKV_BF16, dq=FLASH_BWD_DQ_BF16)}


def bwd_route(tk: int) -> str:
    """'fused' (one kv-major pass, dQ partials per kv span) up to
    ``FUSE_MAX_TK`` keys, 'two_pass' (dK/dV kv-major, dQ q-major) past it."""
    return "fused" if tk <= FUSE_MAX_TK else "two_pass"


def kv_spans(tk: int) -> Tuple[int, int]:
    """(number of kv spans, kv tiles per span) of the float32 fused
    backward: at most ``MAX_SPANS`` spans, so the dQ partials stay <= 8 x
    |dQ|.  (The bf16 form writes no partials: ``flash_bf16_plan``.)"""
    tiles = -(-tk // KV_TILE)
    per_span = -(-tiles // MAX_SPANS)
    return -(-tiles // per_span), per_span


@functools.lru_cache(maxsize=256)
def flash_bf16_plan(kind: str, batch: int, heads: int, tq: int, tk: int, d: int) -> dict:
    """The launch plan of a bf16 kernel: ``kind`` 'fwd' (the forward),
    'fused' (the fused backward), 'dkv' (its dK / dV form) or 'dq' (its dQ
    form).

    Returns ``dp``, the head dim the kernel sees (``d`` padded to a multiple
    of 8: TMA moves rows of whole 16-byte chunks); ``regions``, its 64-column
    boxes (1 up to 64, 2 up to 128); the grid (CTAs along x, heads, batch
    rows) and its split into ``kv_ctas`` (a 64-key tile each) and
    ``q_ctas`` (a 64-row query tile each; the forward's and the dQ form's
    CTAs are all query tiles); ``query_tile``, the rows of a kv-role query
    tile (64, or 32 at a head dim past 64, where dK and dV take twice the
    registers); ``threads`` a CTA; and ``smem``, its dynamic shared memory
    in bytes (the kernel checks it against its own).  Raises for shapes the
    kernels refuse, before any launch.  Cached: callers read the dict and
    must not change it."""
    if kind not in ("fwd", "fused", "dkv", "dq"):
        raise ValueError(f"flash_bf16_plan: kind {kind!r} is not 'fwd', 'fused', 'dkv' "
                         "or 'dq'")
    if min(batch, heads, tq, tk, d) < 1:
        raise ValueError(f"flash_bf16_plan: empty dimension in ({batch}, {heads}, {tq}, "
                         f"{tk}, {d})")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_bf16_plan: head dim {d} > {MAX_HEAD_DIM} is not supported")
    if batch > 65535 or heads > 65535:
        raise ValueError(f"flash_bf16_plan: {batch} batch rows x {heads} heads: a grid "
                         "dimension takes at most 65535")
    dp = -(-d // 8) * 8
    regions = 1 if dp <= 64 else 2
    tile = BF16_TILE * 128 * regions  # bytes of a 64-row tile, every region
    query_tile = BF16_TILE if regions == 1 else BF16_TILE // 2
    n_q, n_k = -(-tq // BF16_TILE), -(-tk // BF16_TILE)
    if kind == "fwd":
        kv_ctas, q_ctas = 0, n_q
        smem = (1 + 2 * BF16_FWD_STAGES) * tile  # Q, then K and V a stage
    elif kind == "dq":
        kv_ctas, q_ctas = 0, n_q
        smem = (1 + BF16_DQ_STAGES) * 2 * tile  # Q and dO, then K and V a stage
    else:
        kv_ctas, q_ctas = n_k, n_q if kind == "fused" else 0
        # K and V, a stage's Q and dO, and each stage's LSE and Delta
        kv_bytes = (2 * tile + BF16_BWD_STAGES * 2 * query_tile * 128 * regions
                    + BF16_BWD_STAGES * 2 * query_tile * 4)
        q_bytes = 2 * tile + BF16_BWD_STAGES * 2 * tile
        smem = max(kv_bytes, q_bytes if q_ctas else 0)
    smem += 1024  # slack that aligns the first tile to the swizzle's 1024 bytes
    return dict(kind=kind, dp=dp, regions=regions, grid=(kv_ctas + q_ctas, heads, batch),
                kv_ctas=kv_ctas, q_ctas=q_ctas, query_tile=query_tile,
                threads=BF16_THREADS, smem=smem)


def plan_items(plan: dict, tq: int, tk: int):
    """Every CTA of ``plan``'s grid as the kernel reads its block index:
    (role, first row, last row + 1, head, batch row), role 'kv' for a key
    tile, 'q' for a query tile (rows clipped to the sequence)."""
    n, heads, batch = plan["grid"]
    for b in range(batch):
        for h in range(heads):
            for x in range(n):
                if x < plan["kv_ctas"]:
                    r0 = BF16_TILE * x
                    yield "kv", r0, min(r0 + BF16_TILE, tk), h, b
                else:
                    r0 = BF16_TILE * (x - plan["kv_ctas"])
                    yield "q", r0, min(r0 + BF16_TILE, tq), h, b


def _tma_operand(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` (B, H, T, d) bf16 as the kernels' tensor maps take it: the head
    dim padded with zero columns to ``dp``, 16-byte aligned (a copy where
    either is not already so)."""
    if t.shape[-1] != dp:
        return torch.nn.functional.pad(t, (0, dp - t.shape[-1]))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _operand_dtype(name: str, q, k, v, do=None) -> torch.dtype:
    """The one dtype of q, k, v (and dO): float32 or bfloat16; float16,
    any other dtype and mixed operands raise, on every device."""
    dtypes = {t.dtype for t in (q, k, v, do) if t is not None}
    if len(dtypes) != 1:
        raise ValueError(f"{name}: q, k, v and dO must share one dtype, got "
                         f"{sorted(str(t) for t in dtypes)}")
    (dtype,) = dtypes
    if dtype not in _FORMS:
        raise ValueError(f"{name}: operands are {dtype}; the kernels take float32 "
                         "or bfloat16")
    return dtype


def _checked(name: str, q, k, v, bias, seed, rate: float, do=None, **stats):
    """Shape / type / device checks before a launch (q, k, v and dO of one
    dtype, the bias and the row statistics float32); returns the dims and
    the seed pointer (None at rate 0)."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q has shape {tuple(q.shape)}, expected (B, H, Tq, D)")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    shapes = dict(k=(k, (b, h, tk, d)), v=(v, (b, h, tk, d)))
    if bias is not None:
        shapes["bias"] = (bias, (b, tk))
    if do is not None:
        shapes["do"] = (do, (b, h, tq, d))
    for arg, t in stats.items():
        shapes[arg] = (t, (b, h, tq))
    for arg, (t, shape) in shapes.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shape}")
    if min(b, h, tq, tk, d) < 1:
        raise ValueError(f"{name}: empty dimension in q{tuple(q.shape)} / k{tuple(k.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM} is not supported")
    operands = dict(q=q, k=k, v=v)
    if do is not None:
        operands["do"] = do
    check_cuda(name, q.dtype, operands)
    f32 = dict(stats)
    if bias is not None:
        f32["bias"] = bias
    check_cuda(name, torch.float32, f32)
    for arg, t in f32.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, q on {q.device}")
    seed_ptr = None
    if rate > 0.0:
        if (seed.dtype != torch.int64 or seed.numel() != 1
                or seed.device != q.device):
            raise ValueError(f"{name}: the seed must be one int64 on {q.device}")
        seed_ptr = seed.data_ptr()
    return b, h, tq, tk, d, seed_ptr


def _drop_args(rate: float):
    return drop_threshold(rate), 1.0 / (1.0 - rate) if rate > 0.0 else 1.0


def _fwd_launch(q, k, v, bias, seed, rate: float):
    """The CUDA kernel of ``med_torch::flash_fwd``: the float32 form, or
    the bf16 form on bf16 operands."""
    dtype = _operand_dtype("flash_fwd", q, k, v)
    b, h, tq, tk, d, seed_ptr = _checked("flash_fwd", q, k, v, bias, seed, rate)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if dtype == torch.bfloat16:
        plan = flash_bf16_plan("fwd", b, h, tq, tk, d)
        dp = plan["dp"]
        qp, kp, vp = (_tma_operand(t, dp) for t in (q, k, v))
        o = q.new_empty((b, h, tq, dp))
        FLASH_FWD_BF16(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                       bias.data_ptr() if bias is not None else None, seed_ptr,
                       o.data_ptr(), lse.data_ptr(), b, h, tq, tk, dp, plan["grid"][0],
                       plan["smem"], 1.0 / math.sqrt(d), *_drop_args(rate), stream_of(q))
        return _unpad(o, d), lse
    o = torch.empty_like(q)
    _FORMS[dtype]["fwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     bias.data_ptr() if bias is not None else None, seed_ptr,
                     o.data_ptr(), lse.data_ptr(), b, h, tq, tk, d,
                     1.0 / math.sqrt(d), *_drop_args(rate), stream_of(q))
    return o, lse


def _fwd_plain(q, k, v, bias, seed, rate: float):
    _operand_dtype("flash_fwd", q, k, v)
    return flash_fwd_reference(q, k, v, bias, seed, rate)


def _fwd_fake(q, k, v, bias, seed, rate: float):
    _operand_dtype("flash_fwd", q, k, v)
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:3], dtype=torch.float32))


FLASH_FWD_OP = kernel_op(
    "flash_fwd",
    "(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor? seed, float rate) "
    "-> (Tensor, Tensor)",
    cpu=_fwd_plain, cuda=_fwd_launch, fake=_fwd_fake)


def flash_fwd(q, k, v, bias, seed, rate: float):
    """Attention forward -> (O (B, H, Tq, D) in the operands' dtype, LSE
    (B, H, Tq) float32).

    Calls ``med_torch::flash_fwd``: on CUDA tensors it launches
    ``csrc/flash_fwd.cu`` (counted in ``FLASH_FWD.launches``) or, on bf16
    operands, ``csrc/flash_fwd_bf16.cu`` (``FLASH_FWD_BF16.launches``); on
    CPU tensors it runs ``flash_fwd_reference``.
    """
    return FLASH_FWD_OP(q, k, v, bias, seed, float(rate))


def _bwd_launch(form: str, q, k, v, bias, seed, rate, do, lse, delta,
                dq_out, dk, dv, spans_arg):
    b, h, tq, tk, d, seed_ptr = _checked(f"flash_bwd_{form}", q, k, v, bias, seed, rate,
                                         do=do, lse=lse, delta=delta)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    _FORMS[q.dtype][form](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bias), seed_ptr,
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), ptr(dq_out),
        ptr(dk), ptr(dv), b, h, tq, tk, d, spans_arg,
        1.0 / math.sqrt(d), *_drop_args(rate), stream_of(q))


def _bwd_bf16_launch(kind: str, q, k, v, bias, seed, rate, do, lse, delta):
    """The bf16 fused backward ('fused' -> dQ, dK, dV), its dK / dV form
    ('dkv' -> dK, dV) or its dQ form ('dq' -> (dQ,)) on the plan's grid."""
    b, h, tq, tk, d, seed_ptr = _checked(f"flash_bwd_{kind}", q, k, v, bias, seed, rate,
                                         do=do, lse=lse, delta=delta)
    plan = flash_bf16_plan(kind, b, h, tq, tk, d)
    dp = plan["dp"]
    qp, kp, vp, dop = (_tma_operand(t, dp) for t in (q, k, v, do))
    dq = q.new_empty((b, h, tq, dp)) if kind != "dkv" else None
    dk, dv = ((k.new_empty((b, h, tk, dp)), k.new_empty((b, h, tk, dp))) if kind != "dq"
              else (None, None))
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    _FORMS[torch.bfloat16][kind](
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), ptr(bias), seed_ptr, dop.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), ptr(dq), ptr(dk), ptr(dv), b, h, tq, tk, dp,
        plan["kv_ctas"], plan["q_ctas"], plan["smem"], 1.0 / math.sqrt(d),
        *_drop_args(rate), stream_of(q))
    return tuple(_unpad(g, d) for g in (dq, dk, dv) if g is not None)


def flash_bwd_fused(q, k, v, bias, seed, rate: float, do, lse, delta):
    """Fused backward -> (dQ, dK, dV) in the operands' dtype.

    On CUDA tensors this launches ``csrc/flash_bwd_fused.cu``'s kv-major
    kernel (one CTA per kv span, head and batch row; each span's dQ partial
    in its own float32 slot, summed here) and counts it in
    ``FLASH_BWD_FUSED.launches``; on bf16 operands ``csrc/flash_bwd_bf16.cu``
    (a kv role for dK and dV, a q role for dQ, no partials), counted in
    ``FLASH_BWD_FUSED_BF16.launches``; on CPU tensors it runs
    ``flash_bwd_reference``.
    """
    dtype = _operand_dtype("flash_bwd_fused", q, k, v, do)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, bias, seed, rate, do, lse, delta)
    if dtype == torch.bfloat16:
        return _bwd_bf16_launch("fused", q, k, v, bias, seed, rate, do, lse, delta)
    n_spans, per_span = kv_spans(k.shape[2])
    dqp = q.new_empty((n_spans,) + tuple(q.shape), dtype=torch.float32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("fused", q, k, v, bias, seed, rate,
                do, lse, delta, dqp, dk, dv, per_span)
    return dqp.sum(dim=0), dk, dv


def flash_bwd_dkv(q, k, v, bias, seed, rate: float, do, lse, delta):
    """Two-pass backward, first pass -> (dK, dV) in the operands' dtype.

    On CUDA tensors this launches the fused kernel in its dK/dV form (no
    dQ; one CTA per 64-key tile, head and batch row; dK and dV bit for bit
    the fused form's): ``csrc/flash_bwd_fused.cu``'s, counted in
    ``FLASH_BWD_DKV.launches``, or on bf16 operands
    ``csrc/flash_bwd_bf16.cu``'s kv role, counted in
    ``FLASH_BWD_DKV_BF16.launches``; on CPU tensors it runs
    ``flash_bwd_reference``.
    """
    dtype = _operand_dtype("flash_bwd_dkv", q, k, v, do)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, bias, seed, rate, do, lse, delta)[1:]
    if dtype == torch.bfloat16:
        return _bwd_bf16_launch("dkv", q, k, v, bias, seed, rate, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("dkv", q, k, v, bias, seed, rate,
                do, lse, delta, None, dk, dv, 1)
    return dk, dv


def flash_bwd_dq(q, k, v, bias, seed, rate: float, do, lse, delta):
    """Two-pass backward, second pass -> dQ in the operands' dtype.

    On CUDA tensors this launches ``csrc/flash_bwd_dq.cu`` and counts it in
    ``FLASH_BWD_DQ.launches``; on bf16 operands the dQ form of
    ``csrc/flash_bwd_bf16.cu`` (query tiles alone, dQ summed over every key
    on chip), counted in ``FLASH_BWD_DQ_BF16.launches``; on CPU tensors it
    runs ``flash_bwd_reference``.
    """
    dtype = _operand_dtype("flash_bwd_dq", q, k, v, do)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, bias, seed, rate, do, lse, delta)[0]
    if dtype == torch.bfloat16:
        return _bwd_bf16_launch("dq", q, k, v, bias, seed, rate, do, lse, delta)[0]
    dq = torch.empty_like(q)
    _bwd_launch("dq", q, k, v, bias, seed, rate,
                do, lse, delta, dq, None, None, 0)
    return dq


class FlashAttention(torch.autograd.Function):
    """O = dropout(softmax(q k^T / sqrt(D) + bias)) v over the kernels;
    gradients for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate: float):
        o, lse = flash_fwd(q, k, v, bias, seed, rate)
        ctx.save_for_backward(q, k, v, bias, seed, o, lse)
        ctx.rate = rate
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, seed, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # float32 whatever the operands, as the JAX package forms it
        delta = (do.float() * o.float()).sum(dim=-1)
        args = (q, k, v, bias, seed, ctx.rate, do, lse, delta)
        if bwd_route(k.shape[2]) == "fused":
            dq, dk, dv = flash_bwd_fused(*args)
        else:
            dk, dv = flash_bwd_dkv(*args)
            dq = flash_bwd_dq(*args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None, *,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable attention through the flash kernels (the plain
    versions on CPU tensors); q (B, H, Tq, D), k and v (B, H, Tk, D), all
    float32 or all bfloat16 (the kernels' bf16 forms; O and the gradients
    in bf16), bias (B, Tk) additive on the keys, taken in float32;
    ``dropout_seed`` an int64 tensor of one element, required when
    ``dropout_rate > 0``."""
    _operand_dtype("flash_attention", q, k, v)
    batch, heads, tq, d = q.shape
    tk = k.shape[2]
    if min(batch, heads, tq, tk, d) < 1:
        raise ValueError(f"flash_attention: empty dimension in q{tuple(q.shape)} / "
                         f"k{tuple(k.shape)}")
    if bias is not None:
        if tuple(bias.shape) != (batch, tk):
            raise ValueError(f"flash_attention: bias shape {tuple(bias.shape)} != "
                             f"(batch, Tk) = ({batch}, {tk})")
        # a mask, not a parameter: no dbias is computed, so cut the edge
        bias = bias.detach().to(torch.float32).contiguous()
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate {rate} not in [0, 1)")
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    seed = dropout_seed if rate > 0.0 else None
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                bias, seed, rate)
