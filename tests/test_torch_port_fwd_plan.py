"""PyTorch port, the one-layer forwards' launch plan
(``ops/lstm_kernel.py::chain_plan(forward=True)``, the split
``csrc/rnn_fwd_chain.cuh`` runs and re-checks on the card).

The forward exchanges the H-wide row of h and forms ``width`` gate
columns a unit (4 for the LSTM, 3 for the GRU): the transpose of the
reverse chain's geometry (``tests/test_torch_port_chain_plan.py``).  For
H = 4 .. 1,056 in steps of 4, both widths, B in {1, 32, 33, 2,048}, and
cards of 132 and 114 SMs whose resident cluster counts are stubbed, the
plan must:

* form every (row group, gate column, float4 column of h) of a step
  exactly once, and give every (row group, unit) cell to exactly one CTA
  of the cluster that forms its gate columns;
* pick a cluster size and row-group count whose product divides the grid,
  the fewest passes of 8 rows a group (two groups first where four need
  no fewer), and a grid the card holds at once;
* fit shared memory (at most 232,448 bytes) and keep one CTA to an SM;
* accept every shape the first design's launcher accepted (the fewest
  units per CTA of 1, 2, 4, 8 within one CTA per SM, its shared memory
  within the card's; ``csrc/lstm1_fwd.cu`` / ``gru1_fwd.cu`` before the
  core).

The products' thread tiling (8 rows x 2 units' gate columns x every
TPG-th float4 column per thread) and the shuffle reduce-scatter over
groups of fewer than 32 lanes, with value counts that stop halving (the
GRU's 48 and 24), are held to the same exactly-once rule; a numpy model of
one launch (shares, partials, cluster sums, cells, two-slot eval form)
is held against the plain versions.  CPU only: nothing here launches a
kernel.
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
    132, 66, 30 and 15 clusters of 1, 2, 4, 8 (``chain_ab.py --probe``); a
    114-SM card is modelled with the same loss of 12 SMs to clusters of 4
    and 8."""
    def active(upc, ncl, rgroups, kc):
        return sms // ncl if ncl <= 2 else (sms - 12) // ncl
    return active


def _every(sms):
    def active(upc, ncl, rgroups, kc):
        return sms // ncl
    return active


def _old_fwd_rule_accepts(hidden, width, batch, sms):
    """The first design's launcher: the fewest UPC in 1, 2, 4, 8 with
    H / UPC <= SMs, then the whole h row staged or chunks of 512, 256, 128
    columns, and its shared memory (the weight slice, rows padded to 4
    columns for the GRU, the warps' sums of 32 rows, the tile, the carries
    of every row) within the card's."""
    for upc in (1, 2, 4, 8):
        if hidden % upc == 0 and hidden // upc <= sms:
            g = width * upc
            gp = -(-g // 4) * 4
            for kc in [hidden] + [c for c in (512, 256, 128) if c < hidden]:
                if 4 * (hidden * gp + 8 * g * 32 + 32 * (kc + 1) + batch * upc) <= MAX_SMEM:
                    return True
            return False
    return False


def _passes(batch, rgroups):
    """The passes of ``CHAIN_PH`` rows a row group of the batch takes."""
    return -(-(-(-batch // rgroups)) // lk.CHAIN_PH)


def _fits(plan, width, rgroups, active):
    """Whether ``rgroups`` row groups fit the plan's UPC and cluster size:
    the grid divides, at most 64 units a cluster, shared memory at the
    smallest chunk, and the grid resident."""
    upc, ncl = plan.upc, plan.ncl
    need = 4 * lk.chain_smem_floats(width, plan.hidden, upc, ncl, rgroups, 1, plan.forward)
    return (plan.grid % (ncl * rgroups) == 0
            and ncl * rgroups * upc <= lk.CHAIN_NU_MAX and need <= MAX_SMEM
            and active(upc, ncl, rgroups, 1) * ncl >= plan.grid)


@pytest.mark.parametrize("stub", ["measured", "every"])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("batch", [1, 32, 33, 2048])
@pytest.mark.parametrize("width", [4, 3])
def test_fwd_plan_covers_fits_and_accepts(width, batch, sms, stub):
    active = (_measured if stub == "measured" else _every)(sms)
    accepted = 0
    for hidden in HIDDEN:
        old = _old_fwd_rule_accepts(hidden, width, batch, sms)
        try:
            plan = lk.chain_plan(hidden, width, batch, sms, MAX_SMEM, active, forward=True)
        except ValueError:
            assert not old, f"H={hidden}: refused, but the first design took it"
            continue
        accepted += 1
        grid, ncl, upc, rg = plan.grid, plan.ncl, plan.upc, plan.rgroups
        assert plan.forward and plan.exchanged == hidden
        assert grid * upc == hidden and grid <= sms
        assert upc == next(u for u in (1, 2, 4, 8) if hidden % u == 0 and hidden // u <= sms)
        assert ncl in (1, 2, 4, 8) and rg in (1, 2, 4), plan
        fits = [r for r in (1, 2, 4) if _fits(plan, width, r, active)]
        assert _passes(batch, rg) == min(_passes(batch, r) for r in fits), plan
        assert rg == next(r for r in lk._row_groups_order(batch) if r in fits), plan
        assert grid % (ncl * rg) == 0 and plan.cluster_width <= lk.CHAIN_NU_MAX, plan
        assert plan.outputs == width * plan.cluster_width
        assert active(upc, ncl, rg, plan.kc) * ncl >= grid, plan
        need = 4 * lk.chain_smem_floats(width, hidden, upc, ncl, rg, plan.kc, forward=True)
        assert need <= plan.smem <= MAX_SMEM, plan
        assert 2 * (plan.smem + 1024) > 233_472, "two CTAs would fit one SM"
        # every (row group, gate column, float4 column of h) once, every
        # (row group, unit) cell once, and the row groups partition the batch
        n4 = hidden // 4
        groups = {}
        count = np.zeros((rg, width * hidden, n4), dtype=np.int32)
        cells = np.zeros((rg, hidden), dtype=np.int32)
        for cta in range(grid):
            g = cta // ncl % rg
            rows = plan.rows(cta, batch)
            assert groups.setdefault(g, rows) == rows
            units, share = plan.cluster_units(cta), plan.share(cta % ncl)
            for q in range(width):
                count[g, q * hidden + units.start:q * hidden + units.stop,
                      share.start:share.stop] += 1
            own = plan.units(cta)
            assert own.start >= units.start and own.stop <= units.stop
            cells[g, own.start:own.stop] += 1
        assert (count == 1).all(), f"H={hidden}: gate columns not formed once"
        assert (cells == 1).all(), f"H={hidden}: cells not covered once"
        covered = np.zeros(batch, dtype=np.int32)
        for rows in groups.values():
            covered[rows.start:rows.stop] += 1
        assert (covered == 1).all()
    assert accepted > 0


@pytest.mark.parametrize("stub,expect", [("measured", (2, 4)), ("every", (8, 2))])
def test_fwd_plan_at_the_big_configs_shape(stub, expect):
    """B=32, H=512 on 132 SMs: 4 units per CTA, 128 CTAs; the H100 holds
    128 CTAs only in clusters of 2 at one CTA per SM, and then 4 row groups
    of 8 rows fit (16 cells a CTA, 32 units a cluster: 128 LSTM or 96 GRU
    gate columns over half the h row).  One row (the b1 serving forward)
    takes two row groups, one of them empty."""
    active = (_measured if stub == "measured" else _every)(132)
    for width in (4, 3):
        plan = lk.chain_plan(512, width, 32, 132, MAX_SMEM, active, forward=True)
        assert (plan.upc, plan.grid, (plan.ncl, plan.rgroups)) == (4, 128, expect)
        assert plan.kc == 128 // plan.ncl  # the whole share, one chunk
        assert plan.outputs == width * 4 * plan.ncl * plan.rgroups
        one = lk.chain_plan(512, width, 1, 132, MAX_SMEM, active, forward=True)
        assert one.rgroups == 2 and one.ncl == plan.ncl


def test_row_groups_cap():
    """The order the plan tries row-group counts in: two first up to 16
    rows, where two groups of one pass hold the batch, else four."""
    assert [lk._row_groups_order(b)[0] for b in (1, 2, 8, 9, 16, 17, 24, 25, 32, 33,
                                                 2048)] == [2] * 5 + [4] * 6
    for b in (1, 16, 17, 33, 2048):
        assert sorted(lk._row_groups_order(b)) == [1, 2, 4]
        first = lk._row_groups_order(b)[0]
        assert _passes(b, first) == min(_passes(b, r) for r in (1, 2, 4))


def test_fwd_plan_refuses_what_no_card_runs():
    active = _every(132)
    for hidden, batch in ((1060, 32), (6, 32), (512, 0), (0, 4)):
        with pytest.raises(ValueError):
            lk.chain_plan(hidden, 4, batch, 132, MAX_SMEM, active, forward=True)
    with pytest.raises(ValueError):
        lk.chain_plan(512, 3, 32, 132, MAX_SMEM, lambda upc, ncl, rgroups, kc: 0,
                      forward=True)


def _tiling(nu, width):
    """``fwd_kernel``'s thread tiling: (UB, OB, TPG, L, KW)."""
    ub = min(nu, 2)
    ob = width * ub
    tpg = lk.CHAIN_NT // (nu // ub)
    lanes = min(tpg, 32)
    return ub, ob, tpg, lanes, tpg // lanes


@pytest.mark.parametrize("width", [4, 3])
@pytest.mark.parametrize("nu", [1, 2, 4, 8, 16, 32, 64])
def test_fwd_products_thread_tiling_visits_each_term_once(nu, width):
    """Thread tid takes column group og = tid / TPG (gate columns og OB +
    [0, OB), 2 units' W gates), all 8 rows of the pass and the float4
    columns ks + TPG s of each chunk, ks = tid % TPG; a group's lanes lie
    in one warp (TPG <= 32) or fill KW whole warps."""
    ph = lk.CHAIN_PH
    ub, ob, tpg, lanes, kw = _tiling(nu, width)
    assert tpg == lk._column_slices(nu, forward=True)
    assert lanes * kw == tpg and (nu // ub) * tpg == lk.CHAIN_NT
    assert 32 % lanes == 0
    no = width * nu
    for cs4, kc in ((1, 1), (7, 3), (64, 64), (64, 16), (132, 16), (33, 33)):
        count = np.zeros((ph, no, cs4), dtype=np.int32)
        for ch in range(-(-cs4 // kc)):
            kn = min(kc, cs4 - ch * kc)
            for tid in range(lk.CHAIN_NT):
                og, ks = tid // tpg, tid % tpg
                # the lanes of a group share a warp's aligned lane block
                assert (tid % 32) // lanes == (tid % 32 - ks % lanes) // lanes
                cols = [ch * kc + c for c in range(ks, kn, tpg)]
                count[np.ix_(range(ph), range(og * ob, og * ob + ob), cols)] += 1
        assert (count == 1).all(), (nu, width, cs4, kc)


def _reduce_scatter(vals, lanes):
    """A model of ``warp_reduce_scatter<N0, L>`` on one group of ``lanes``
    lanes: each level O = L/2 .. 1 halves an even count (the lane with
    lane & O keeps the upper half, plus its partner's copy of it) or adds
    all of an odd one."""
    held = [list(v) for v in vals]
    o = lanes // 2
    while o >= 1:
        n = len(held[0])
        new = []
        for lane in range(lanes):
            v, peer = held[lane], held[lane ^ o]
            if n % 2 == 0:
                keep = range(n // 2, n) if lane & o else range(n // 2)
                new.append([v[k] + peer[k] for k in keep])
            else:
                new.append([v[k] + peer[k] for k in range(n)])
        held = new
        o //= 2
    return held


def _scatter_levels(n0, lanes):
    levels = 0
    while lanes > 1 and n0 % 2 == 0:
        levels, n0, lanes = levels + 1, n0 // 2, lanes // 2
    return levels


@pytest.mark.parametrize("nv,lanes", [(64, 32), (32, 32), (8, 32), (48, 32), (24, 32),
                                      (64, 16), (48, 16), (64, 8), (48, 8), (16, 32)])
def test_reduce_scatter_general_model(nv, lanes):
    """After the levels, lane l holds the totals of values NF (l >> (log2 L
    - S)) + [0, NF), S = scatter_levels(N0, L), NF = N0 >> S; the lanes
    with l % (L >> S) == 0 write them, and together they write every value
    once.  For N0 a power of two and L = 32 this is the reverse chain's
    rule (``test_warp_reduce_scatter_model``)."""
    rng = np.random.RandomState(nv * lanes)
    vals = rng.randn(lanes, nv)
    held = _reduce_scatter(vals, lanes)
    s = _scatter_levels(nv, lanes)
    nf, ls = nv >> s, lanes >> s
    totals = vals.sum(axis=0)
    written = np.zeros(nv, dtype=np.int32)
    for lane in range(lanes):
        assert len(held[lane]) == nf
        base = nf * (lane // ls)
        for v in range(nf):
            assert np.isclose(held[lane][v], totals[base + v]), (lane, v)
        if lane % ls == 0:
            written[base:base + nf] += 1
    assert (written == 1).all()


def _model_launch(plan, ih, w_hh, b_hh, cell, want):
    """A numpy model of one ``fwd_kernel`` launch on ``plan``: per step,
    each CTA's partial sums over its share of the previous h for the
    cluster's gate columns (rows u W + q of its weight tile), their sum
    over the cluster's ranks, and the cell of each of its (row, unit),
    which reads only its own carry.  ``want``: "train" (h_prev, and the
    gate columns), "series" or "slots" (two slots used in turn)."""
    t_len, batch, gh = ih.shape
    width, hidden = plan.width, plan.hidden
    nu, ncl = plan.cluster_width, plan.ncl
    carry = np.zeros((batch, hidden))
    h_x = np.zeros((t_len if want != "slots" else 2, batch, hidden))
    recs = np.zeros((t_len, batch, gh))
    for t in range(t_len):
        if want == "train":
            src = h_x[t]
        elif want == "series":
            src = h_x[t - 1] if t else None
        else:
            src = h_x[(t - 1) % 2] if t else None
        new_h = {}
        for cta in range(plan.grid):
            rank = cta % ncl
            units = plan.cluster_units(cta)
            rows = plan.rows(cta, batch)
            own = plan.units(cta)
            rec = np.zeros((len(rows), len(own), width))
            if t > 0:
                for r in range(ncl):
                    share = plan.share(r)
                    k = np.arange(4 * share.start, 4 * share.stop)
                    # the weight tile of rank r: row u W + q = column q H + u
                    cols = [q * hidden + u for u in units for q in range(width)]
                    wl = w_hh[np.ix_(k, cols)].T
                    part = src[rows.start:rows.stop][:, k] @ wl.T  # (rows, NO)
                    for i, j in enumerate(own):
                        oc = (j - units.start) * width
                        rec[:, i] += part[:, oc:oc + width]
            for i, j in enumerate(own):
                for bi, b in enumerate(rows):
                    x = ih[t, b, [q * hidden + j for q in range(width)]]
                    recs[t, b, [q * hidden + j for q in range(width)]] = rec[bi, i]
                    h, carry[b, j] = cell(x, rec[bi, i], b_hh, j, hidden, carry[b, j])
                    new_h[(b, j)] = h
        if want == "train" and t + 1 == t_len:
            break
        dst = t + 1 if want == "train" else (t if want == "series" else t % 2)
        for (b, j), h in new_h.items():
            h_x[dst, b, j] = h
    final = np.array([[new_h[(b, j)] for j in range(hidden)] for b in range(batch)])
    return h_x, recs, final


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def _lstm_cell(x, rec, b_hh, j, hidden, c):
    g = x + rec
    c = _sig(g[1]) * c + _sig(g[0]) * np.tanh(g[2])
    return _sig(g[3]) * np.tanh(c), c


def _gru_cell(x, rec, b_hh, j, hidden, h):
    hh = rec + b_hh[[j, hidden + j, 2 * hidden + j]]
    r, z = _sig(x[0] + hh[0]), _sig(x[1] + hh[1])
    n = np.tanh(x[2] + r * hh[2])
    h = (1.0 - z) * n + z * h
    return h, h


@pytest.mark.parametrize("width", [4, 3])
@pytest.mark.parametrize("batch,t_len,hidden,sms,stub,split", [
    (9, 3, 16, 132, "every", (8, 2)), (17, 3, 32, 8, "every", (8, 1)),
    (3, 3, 28, 40, "measured", (4, 1)), (33, 2, 16, 20, "measured", (2, 4)),
    (5, 3, 48, 28, "measured", (2, 2)), (2, 2, 24, 4, "every", (1, 1)),
    (1, 3, 8, 1, "every", (1, 1)), (1, 3, 16, 132, "every", (8, 2))])
def test_fwd_core_model_matches_plain(width, batch, t_len, hidden, sms, stub, split):
    """The model above, on plans with clusters of 8, 4, 2 and 1, row
    groups of ragged passes (33 rows in 4 groups) and an empty one (1 row
    in 2 groups), against
    ``lstm1_train_fwd_reference`` / ``gru1_train_fwd_reference`` and the
    eval forms' plain versions (float64; 1e-12)."""
    active = (_measured if stub == "measured" else _every)(sms)
    plan = lk.chain_plan(hidden, width, batch, sms, MAX_SMEM, active, forward=True)
    assert (plan.ncl, plan.rgroups) == split
    rng = np.random.RandomState(batch * 100 + hidden + width)
    ih = rng.uniform(-1.0, 1.0, (t_len, batch, width * hidden))
    w_hh = rng.uniform(-0.5, 0.5, (hidden, width * hidden))
    b_hh = rng.uniform(-0.5, 0.5, width * hidden)
    cell = _lstm_cell if width == 4 else _gru_cell
    t = [torch.from_numpy(a) for a in (ih, w_hh, b_hh)]
    if width == 4:
        g, h_prev, _, finals = lk.lstm1_train_fwd_reference(t[0], t[1])
        h_final = finals[:, :hidden]
        pre = g - t[0]
    else:
        gates, h_prev, h_final = lk.gru1_train_fwd_reference(*t)
        pre = None
    h_x, recs, final = _model_launch(plan, ih, w_hh, b_hh, cell, "train")
    np.testing.assert_allclose(h_x, h_prev.numpy(), atol=1e-12)
    np.testing.assert_allclose(final, h_final.numpy(), atol=1e-12)
    if pre is not None:
        np.testing.assert_allclose(recs, pre.numpy(), atol=1e-12)
    series = lk.h_series(h_prev, finals if width == 4 else h_final).numpy()
    h_x, _, _ = _model_launch(plan, ih, w_hh, b_hh, cell, "series")
    np.testing.assert_allclose(h_x, series, atol=1e-12)
    h_x, _, _ = _model_launch(plan, ih, w_hh, b_hh, cell, "slots")
    np.testing.assert_allclose(h_x[(t_len - 1) % 2], h_final.numpy(), atol=1e-12)
