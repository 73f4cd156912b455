"""PyTorch port, the one-layer reverse chains' launch plan
(``ops/lstm_kernel.py::chain_plan``, the split ``csrc/rnn_bwd_chain.cuh``
runs and re-checks on the card).

For H = 4 .. 1,056 in steps of 4, both exchanged-row widths (4H for the
LSTM, 3H for the GRU), B in {1, 32, 33, 2,048}, and cards of 132 and 114
SMs whose resident cluster counts are stubbed (the H100 figures that
``scripts/chain_ab.py --probe`` prints, and a card that holds every
cluster), the plan must:

* cover every (batch row, unit, gate column) of a step exactly once, and
  give every (batch row, unit) cell to exactly one CTA of the cluster that
  forms its products;
* pick a cluster size and row-group count whose product divides the grid,
  and a grid the card holds at once;
* fit shared memory (at most 232,448 bytes) and keep one CTA to an SM;
* accept every shape the first design's rule accepted (fewest units per
  CTA of 1, 2, 4, 8 within one CTA per SM, its shared memory within the
  card's).

The products' thread tiling (8 rows x UB units x every KS-th float4 column
per thread, chunks of KC float4 columns) and the warps' shuffle
reduce-scatter are held to the same exactly-once rule for every cluster
width the kernel is built for.  CPU only: nothing here launches a kernel.
"""

import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel as lk

MAX_SMEM = 232_448  # an H100's shared memory per block
HIDDEN = range(4, 1057, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the suite runs several test workers on the same cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _measured(sms):
    """Clusters resident at once at one CTA per SM: an H100 of 132 SMs held
    132, 66, 30 and 15 clusters of 1, 2, 4, 8 (``chain_ab.py --probe``);
    clusters of 4 and 8 lose 12 SMs to the GPC boundaries.  A 114-SM card
    is modelled with the same loss."""
    def active(upc, ncl, rgroups, kc):
        return sms // ncl if ncl <= 2 else (sms - 12) // ncl
    return active


def _every(sms):
    def active(upc, ncl, rgroups, kc):
        return sms // ncl
    return active


def _old_rule_accepts(hidden, width, batch, sms):
    """The first design's launcher: the fewest UPC in 1, 2, 4, 8 with
    H / UPC <= SMs, and its shared memory (the weight slice, the reduced
    products, the carries) within the card's."""
    for upc in (1, 2, 4, 8):
        if hidden % upc == 0 and hidden // upc <= sms:
            smem = 4 * (upc * width * hidden + 32 * upc + batch * upc)
            return smem <= MAX_SMEM
    return False


@pytest.mark.parametrize("stub", ["measured", "every"])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("batch", [1, 32, 33, 2048])
@pytest.mark.parametrize("width", [4, 3])
def test_chain_plan_covers_fits_and_accepts(width, batch, sms, stub):
    active = (_measured if stub == "measured" else _every)(sms)
    accepted = 0
    for hidden in HIDDEN:
        old = _old_rule_accepts(hidden, width, batch, sms)
        try:
            plan = lk.chain_plan(hidden, width, batch, sms, MAX_SMEM, active)
        except ValueError:
            assert not old, f"H={hidden}: refused, but the first design took it"
            continue
        accepted += 1
        grid, ncl, upc, rg = plan.grid, plan.ncl, plan.upc, plan.rgroups
        assert grid * upc == hidden and grid <= sms
        assert upc == next(u for u in (1, 2, 4, 8) if hidden % u == 0 and hidden // u <= sms)
        assert ncl in (1, 2, 4, 8) and rg in (1, 2, 4), plan
        assert grid % (ncl * rg) == 0 and plan.cluster_width <= lk.CHAIN_NU_MAX, plan
        assert active(upc, ncl, rg, plan.kc) * ncl >= grid, plan
        need = 4 * lk.chain_smem_floats(width, hidden, upc, ncl, rg, plan.kc)
        assert need <= plan.smem <= MAX_SMEM, plan
        assert 2 * (plan.smem + 1024) > 233_472, "two CTAs would fit one SM"
        # every (row group, unit, float4 column) once, every (row group,
        # unit) cell once, and the row groups partition the batch
        n4 = width * hidden // 4
        groups = {}
        count = np.zeros((rg, hidden, n4), dtype=np.int32)
        cells = np.zeros((rg, hidden), dtype=np.int32)
        for cta in range(grid):
            g = cta // ncl % rg
            rows = plan.rows(cta, batch)
            assert groups.setdefault(g, rows) == rows
            units, share = plan.cluster_units(cta), plan.share(cta % ncl)
            count[g, units.start:units.stop, share.start:share.stop] += 1
            own = plan.units(cta)
            assert own.start >= units.start and own.stop <= units.stop
            cells[g, own.start:own.stop] += 1
        assert (count == 1).all(), f"H={hidden}: products not covered once"
        assert (cells == 1).all(), f"H={hidden}: cells not covered once"
        covered = np.zeros(batch, dtype=np.int32)
        for rows in groups.values():
            covered[rows.start:rows.stop] += 1
        assert (covered == 1).all()
    assert accepted > 0


@pytest.mark.parametrize("stub,expect", [("measured", (2, 4)), ("every", (8, 2))])
def test_chain_plan_at_the_big_configs_shape(stub, expect):
    """B=32, H=512 on 132 SMs: 4 units per CTA, 128 CTAs; the H100 holds
    128 CTAs only in clusters of 2 at one CTA per SM, and then 4 row groups
    of 8 rows fit (16 units per CTA, 32 a cluster)."""
    active = (_measured if stub == "measured" else _every)(132)
    for width in (4, 3):
        plan = lk.chain_plan(512, width, 32, 132, MAX_SMEM, active)
        assert (plan.upc, plan.grid, (plan.ncl, plan.rgroups)) == (4, 128, expect)


def test_chain_plan_refuses_what_no_card_runs():
    active = _every(132)
    for hidden, batch in ((1060, 32), (6, 32), (512, 0)):
        with pytest.raises(ValueError):
            lk.chain_plan(hidden, 4, batch, 132, MAX_SMEM, active)
    # a card that holds no cluster at all
    with pytest.raises(ValueError):
        lk.chain_plan(512, 4, 32, 132, MAX_SMEM, lambda upc, ncl, rgroups, kc: 0)


@pytest.mark.parametrize("nu", [1, 2, 4, 8, 16, 32, 64])
def test_products_thread_tiling_visits_each_term_once(nu):
    """``chain_kernel``'s tiling: warp w takes units (w % UG) UB + k
    (k < UB) and all 8 rows of the pass; lane l the float4 columns
    l + 32 (w / UG) + KS s of each chunk, UG = NU / UB, KS = 256 / UG."""
    ph = lk.CHAIN_PH
    ub = min(nu, 8)
    ug_n = nu // ub
    kw = 8 // ug_n
    ks_n = 32 * kw
    assert ks_n == lk._column_slices(nu)
    for cs4, kc in ((1, 1), (7, 3), (64, 16), (256, 64), (59, 59), (192, 64)):
        count = np.zeros((ph, nu, cs4), dtype=np.int32)
        for ch in range(-(-cs4 // kc)):
            kn = min(kc, cs4 - ch * kc)
            for tid in range(lk.CHAIN_NT):
                lane, warp = tid % 32, tid // 32
                ug, ks = warp % ug_n, lane + 32 * (warp // ug_n)
                units = [ug * ub + k for k in range(ub)]
                cols = [ch * kc + c for c in range(ks, kn, ks_n)]
                count[np.ix_(range(ph), units, cols)] += 1
        assert (count == 1).all(), (nu, cs4, kc)


@pytest.mark.parametrize("nv", [8, 16, 32, 64])
def test_warp_reduce_scatter_model(nv):
    """``warp_reduce_scatter<NV>``: after the five shuffle levels, for NV
    >= 32 lane L holds the totals of values L (NV / 32) + v; for NV < 32
    lanes whose low 5 - log2(NV) bits are 0 hold value L >> (5 - log2 NV)
    (the lanes that write them)."""
    rng = np.random.RandomState(nv)
    vals = rng.randn(32, nv)
    held = [list(vals[lane]) for lane in range(32)]
    for level in range(5):
        o, n = 16 >> level, nv >> level
        new = []
        for lane in range(32):
            v, peer = held[lane], held[lane ^ o]
            up = bool(lane & o)
            if n >= 2:
                # each lane keeps one half and is sent the partner's copy of it
                half = n // 2
                keep = range(half, n) if up else range(half)
                new.append([v[k] + peer[k] for k in keep])
            else:
                new.append([v[0] + peer[0]] + v[1:])
        held = new
    totals = vals.sum(axis=0)
    if nv >= 32:
        vpl = nv // 32
        for lane in range(32):
            for v in range(vpl):
                assert np.isclose(held[lane][v], totals[lane * vpl + v])
    else:
        shift = 5 - int(np.log2(nv))
        for lane in range(0, 32, 1 << shift):
            assert np.isclose(held[lane][0], totals[lane >> shift])
