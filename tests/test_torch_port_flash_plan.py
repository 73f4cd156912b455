"""PyTorch port, the launch plan of the bf16 flash kernels
(``ops/flash_attention.py::flash_bf16_plan``) and the operands it hands
them, on the CPU:

* every (query tile, head, batch row) of the forward and every key tile
  and query tile of the fused backward is one CTA's, exactly once, the
  dK / dV form launches the key tiles alone and the dQ form the query
  tiles alone;
* a CTA's shared memory stays within the H100's 232,448 bytes at every
  head dim, and equals the kernels' own figure; at D <= 64 four forward
  or three backward CTAs fit an SM;
* the grid fits a launch (at most 65535 heads and batch rows);
* the head dim the kernels see is padded to a multiple of 8 with zero
  columns (TMA moves whole 16-byte chunks), and back;
* shapes the kernels refuse (head dim past 128, too many heads or batch
  rows, mixed or float16 operands) raise before any launch.

The kernels themselves run only on the card (``tests/test_torch_port_gpu.py``).
"""

import collections

import pytest
import torch

from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

SHAPES = [
    # batch, heads, tq, tk, d
    (32, 4, 372, 372, 64),   # the encoder's shape
    (1, 1, 1, 1, 64),        # one query, one key
    (2, 3, 45, 150, 13),     # head dim 13: padded to 16
    (1, 2, 50, 300, 128),    # head dim 128: two regions, 32-row kv query tiles
    (2, 2, 65, 65, 96),      # one row past a 64-row tile, head dim 96
    (1, 2, 100, 4096, 64),   # the fused route's last size
    (1, 2, 64, 5000, 32),    # past it: the two-pass route's dK / dV form
]


def _rows_once(items, role, n, heads, batch):
    """Each (head, batch row) has its rows [0, n) covered by the role's
    tiles exactly once, in tiles of at most 64 rows."""
    seen = collections.Counter()
    for r, r0, r1, h, b in items:
        if r != role:
            continue
        assert 0 <= r0 < r1 <= n and r1 - r0 <= fa.BF16_TILE
        for i in range(r0, r1):
            seen[(i, h, b)] += 1
    assert len(seen) == n * heads * batch
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("shape", SHAPES)
def test_every_tile_is_one_ctas_exactly_once(shape):
    batch, heads, tq, tk, d = shape
    fwd = fa.flash_bf16_plan("fwd", *shape)
    assert fwd["kv_ctas"] == 0 and fwd["q_ctas"] == -(-tq // 64)
    items = list(fa.plan_items(fwd, tq, tk))
    assert len(items) == fwd["grid"][0] * heads * batch
    _rows_once(items, "q", tq, heads, batch)

    fused = fa.flash_bf16_plan("fused", *shape)
    items = list(fa.plan_items(fused, tq, tk))
    assert len(items) == fused["grid"][0] * heads * batch
    _rows_once(items, "kv", tk, heads, batch)  # dK, dV: every key once
    _rows_once(items, "q", tq, heads, batch)   # dQ: every query row once

    dkv = fa.flash_bf16_plan("dkv", *shape)
    assert dkv["q_ctas"] == 0 and dkv["kv_ctas"] == fused["kv_ctas"]
    items = list(fa.plan_items(dkv, tq, tk))
    assert {r for r, *_ in items} == {"kv"}
    _rows_once(items, "kv", tk, heads, batch)


@pytest.mark.parametrize("shape", SHAPES)
def test_dq_form_takes_every_query_tile_once(shape):
    # the two-pass form's dQ pass: query tiles alone, each one CTA's exactly
    # once, the grid no larger than its tiles need
    batch, heads, tq, tk, d = shape
    dq = fa.flash_bf16_plan("dq", *shape)
    assert dq["kv_ctas"] == 0 and dq["q_ctas"] == -(-tq // 64)
    assert dq["grid"] == (dq["q_ctas"], heads, batch)
    items = list(fa.plan_items(dq, tq, tk))
    assert {r for r, *_ in items} == {"q"}
    assert len(items) == dq["q_ctas"] * heads * batch
    _rows_once(items, "q", tq, heads, batch)


@pytest.mark.parametrize("kind", ["fwd", "fused", "dkv", "dq"])
def test_shared_memory_fits_a_cta_at_every_head_dim(kind):
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        plan = fa.flash_bf16_plan(kind, 2, 2, 300, 300, d)
        assert plan["smem"] <= fa.SMEM_LIMIT, (d, plan["smem"])
        assert plan["threads"] == fa.BF16_THREADS == 128  # one warpgroup
    # four forward CTAs an SM at D <= 64 and three backward ones (228 KB,
    # 1 KB of it reserved a CTA)
    assert 4 * (fa.flash_bf16_plan("fwd", 32, 4, 372, 372, 64)["smem"] + 1024) <= 228 * 1024
    assert 3 * (fa.flash_bf16_plan("fused", 32, 4, 372, 372, 64)["smem"] + 1024) <= 228 * 1024


def test_shared_memory_is_the_kernels_own_figure():
    # csrc/flash_fwd_bf16.cu::fwd_smem and csrc/flash_bwd_bf16.cu::bwd_smem
    # at head dims 64 and 128, written out: the kernels refuse any other
    want = {("fwd", 64): 41984, ("fwd", 128): 82944, ("fused", 64): 68096,
            ("fused", 128): 132096, ("dkv", 64): 68096, ("dkv", 128): 83712}
    for (kind, d), smem in want.items():
        assert fa.flash_bf16_plan(kind, 1, 1, 8, 8, d)["smem"] == smem, (kind, d)


def test_dq_form_shared_memory_is_the_kernels_own_figure_at_every_head_dim():
    # csrc/flash_bwd_bf16.cu::dq_smem, (1 + DQ_STAGES) x 2 tiles + 1 KB with
    # a ring of three, written out: every head dim takes the figure of the
    # kernel it pads to (64 or 128)
    assert fa.BF16_DQ_STAGES == 3
    want = {64: 66560, 128: 132096}
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        plan = fa.flash_bf16_plan("dq", 2, 4, 5000, 5000, d)
        assert plan["smem"] == want[64 if plan["dp"] <= 64 else 128], d
    # three dQ CTAs an SM at D <= 64 (228 KB, 1 KB of it reserved a CTA)
    assert 3 * (want[64] + 1024) <= 228 * 1024


@pytest.mark.parametrize("shape", SHAPES + [(3, 65535, 2, 2, 4), (65535, 2, 2, 2, 4)])
def test_grid_fits_a_launch(shape):
    batch, heads = shape[:2]
    for kind in ("fwd", "fused", "dkv", "dq"):
        plan = fa.flash_bf16_plan(kind, *shape)
        assert plan["grid"][1:] == (heads, batch) and max(plan["grid"][1:]) <= 65535
        assert plan["grid"][0] == plan["kv_ctas"] + plan["q_ctas"] >= 1


def test_head_dim_padding():
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        plan = fa.flash_bf16_plan("fwd", 1, 1, 4, 4, d)
        dp = plan["dp"]
        assert dp % 8 == 0 and d <= dp < d + 8
        assert plan["regions"] == (1 if dp <= 64 else 2)
        assert plan["query_tile"] == (64 if dp <= 64 else 32)
    x = torch.arange(2 * 3 * 5 * 13, dtype=torch.float32).reshape(2, 3, 5, 13)
    x = x.to(torch.bfloat16)
    padded = fa._tma_operand(x, 16)
    assert padded.shape == (2, 3, 5, 16) and padded.is_contiguous()
    assert torch.equal(padded[..., :13], x) and not padded[..., 13:].any()
    assert torch.equal(fa._unpad(padded, 13), x)
    aligned = torch.zeros(2, 3, 5, 16, dtype=torch.bfloat16)
    assert fa._tma_operand(aligned, 16) is aligned and fa._unpad(aligned, 16) is aligned


def test_refused_shapes_raise_before_a_launch():
    with pytest.raises(ValueError, match="head dim 129"):
        fa.flash_bf16_plan("fwd", 1, 1, 8, 8, 129)
    with pytest.raises(ValueError, match="65535"):
        fa.flash_bf16_plan("fused", 1, 65536, 8, 8, 64)
    with pytest.raises(ValueError, match="65535"):
        fa.flash_bf16_plan("dkv", 65536, 1, 8, 8, 64)
    with pytest.raises(ValueError, match="empty"):
        fa.flash_bf16_plan("fwd", 1, 1, 0, 8, 64)
    with pytest.raises(ValueError, match="kind"):
        fa.flash_bf16_plan("bwd", 1, 1, 8, 8, 64)
    # operands: mixed and float16 raise on every device, before the route
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="share one dtype"):
        fa.flash_fwd(q, q.float(), q, None, None, 0.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_bwd_fused(q.half(), q.half(), q.half(), None, None, 0.0, q.half(),
                           torch.zeros(1, 1, 8), torch.zeros(1, 1, 8))
