"""PyTorch port, the 2-layer cores' launch plan and step order
(``ops/lstm_kernel.py::chain_plan(layers=2)``, the split that
``csrc/rnn2_bwd_chain.cuh`` (rows 15 and 12, ``gru2_bwd_chain`` /
``lstm2_bwd_chain``) and ``csrc/rnn2_fwd_chain.cuh`` (rows 3 and 2,
``gru2_infer`` / ``lstm2_infer``) run and re-check on the card).

A 2-layer plan launches two sets of H / UPC CTAs: the lead set (the layer
that needs no other: layer 1 of the reverse chain, layer 0 of the forward)
is a one-layer core over its own row; the follow set is one over its own
row and the lead's feed, [own | feed], twice as wide.  For H in {64, 132,
256, 260, 264}, B in {1, 3, 16, 17, 32}, both cores, both cell widths and
cards of 132 SMs whose resident cluster counts are stubbed (the H100's
measured counts, and a card that holds every cluster), the plan must:

* give every (layer, row group, unit) cell to exactly one CTA, and let the
  clusters of each set form every (row group, output, float4 column of
  that set's row) exactly once;
* keep both sets within one CTA per SM, fit shared memory (at most
  232,448 bytes) and the resident-cluster stub;
* take every shape the first design took (2 layers, H % 4 == 0, H <= 2 x
  SMs) and refuse what no card runs.

A numpy model of each core with either cell (clusters of a set stepping
in any order the flag barriers allow, each rank's share cut at the [own |
feed] boundary into pieces, the partials summed per piece over the
cluster, buffers the kernel has not written yet read as NaN; the LSTM's
packed 10H residuals, dc / c carries and dh_final at the lead set's first
step) is held to ``gru2_bwd_chain_reference`` / ``gru2_infer_reference``
and ``lstm2_bwd_chain_reference`` / ``lstm2_infer_reference`` at T = 1, 2
and 5 (1e-6), on plans with clusters of 8, 4, 2 and 1 (an odd grid, where
each CTA of the follow set forms both pieces), row groups of ragged
passes and an empty one; in some cases each CTA's partials come from a
model of its threads (the register tiles, the shuffle reduce-scatter and
the kernel's write rule).  At the JAX kernels' shapes (H 128, B 8) the
model is held to ``gru2_infer_pallas`` / ``gru2_bwd_chain_res_padded`` and
``lstm2_infer_pallas`` / ``lstm2_bwd_chain_padded`` in interpret mode
(1e-5, as ``tests/test_torch_port_gru.py`` and ``_lstm_train.py`` hold the
plain versions).  The flagship's plan (B=32, H=256, width 4) is pinned.
The same models with the legacy cells (rows 5 and 9, 10 and the remat
chain 13) are held to their plain versions and, at the JAX legacy
kernels' test shape, to ``lstm2_train_fwd_pallas`` /
``lstm2_bwd_chain_pallas`` (1e-5 of the largest).
CPU only: nothing here launches a kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.ops.lstm_kernel import (
    gru2_bwd_chain_pallas,
    gru2_bwd_chain_res_padded,
    gru2_infer_pallas,
    gru2_train_fwd_pallas,
    gru2_train_fwd_residuals as jax_train_fwd,
    lstm2_bwd_chain_padded,
    lstm2_bwd_chain_pallas,
    lstm2_bwd_chain_remat as jax_bwd_chain_remat,
    lstm2_infer_pallas,
    lstm2_train_fwd_pallas,
    lstm2_train_fwd_residuals as jax_lstm_train_fwd,
)
from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel as lk

MAX_SMEM = 232_448  # an H100's shared memory per block
PH = lk.CHAIN_PH


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the suite runs several test workers on the same cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _measured(sms):
    """Clusters resident at once at one CTA per SM: an H100 of 132 SMs held
    132, 66, 30 and 15 clusters of 1, 2, 4, 8 (``chain_ab.py --probe``)."""
    def active(upc, ncl, rgroups, kc):
        return sms // ncl if ncl <= 2 else (sms - 12) // ncl
    return active


def _every(sms):
    def active(upc, ncl, rgroups, kc):
        return sms // ncl
    return active


def _layer_of(plan, cta):
    """The layer a CTA of a 2-layer plan steps: the lead set is layer 1 of
    the reverse chain and layer 0 of the forward."""
    follow = cta >= plan.grid
    return int(follow) if plan.forward else int(not follow)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("width", [3, 4])
@pytest.mark.parametrize("stub", ["measured", "every"])
@pytest.mark.parametrize("batch", [1, 3, 16, 17, 32])
def test_pair_plan_owns_covers_and_fits(batch, stub, width, forward):
    active = (_measured if stub == "measured" else _every)(132)
    for hidden in (64, 132, 256, 260, 264):
        plan = lk.chain_plan(hidden, width, batch, 132, MAX_SMEM, active, forward,
                             layers=2)
        grid, ncl, upc, rg = plan.grid, plan.ncl, plan.upc, plan.rgroups
        assert plan.layers == 2 and plan.ctas == 2 * grid <= 132, plan
        assert upc == next(u for u in (1, 2, 4, 8) if hidden % u == 0
                           and 2 * (hidden // u) <= 132)
        assert ncl in (1, 2, 4, 8) and rg in (1, 2, 4), plan
        assert grid % (ncl * rg) == 0 and plan.cluster_width <= lk.CHAIN_NU_MAX, plan
        assert active(upc, ncl, rg, plan.kc) * ncl >= plan.ctas, plan
        need = 4 * lk.chain_smem_floats(width, hidden, upc, ncl, rg, plan.kc, forward,
                                        layers=2)
        assert need <= plan.smem <= MAX_SMEM, plan
        assert 2 * (plan.smem + 1024) > 233_472, "two CTAs would fit one SM"
        # the chunk holds a whole share of the wider row where it fits
        assert plan.kc <= -(-2 * plan.exchanged // 4 // ncl)
        outs = width if forward else 1
        e4 = plan.exchanged // 4
        cells = np.zeros((2, rg, hidden), dtype=np.int32)
        cover = [np.zeros((rg, outs * hidden, e4 * (1 + f)), dtype=np.int32)
                 for f in (0, 1)]
        groups = {}
        for cta in range(plan.ctas):
            follow = cta >= grid
            g = cta % grid // ncl % rg
            rows = plan.rows(cta, batch)
            assert groups.setdefault(g, rows) == rows
            units, share = plan.cluster_units(cta), plan.share(cta % ncl, follow)
            for q in range(outs):
                cover[follow][g, q * hidden + units.start:q * hidden + units.stop,
                              share.start:share.stop] += 1
            own = plan.units(cta)
            assert own.start >= units.start and own.stop <= units.stop
            cells[_layer_of(plan, cta), g, own.start:own.stop] += 1
            # an even cluster's ranks each form one half's sums
            if follow and ncl % 2 == 0:
                assert share.stop <= e4 or share.start >= e4, (plan, cta)
        assert (cells == 1).all(), f"H={hidden}: cells not owned once"
        assert all((c == 1).all() for c in cover), f"H={hidden}: rows not covered once"
        covered = np.zeros(batch, dtype=np.int32)
        for rows in groups.values():
            covered[rows.start:rows.stop] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("forward", [False, True])
def test_pair_plan_takes_every_shape_the_first_design_took(forward):
    """The first design took 2 layers of any H % 4 == 0 up to 2 x SMs (UPC
    1 or 2 units of both layers a CTA), any B (the LSTM's legacy forward,
    row 5, up to the c state its shared memory held, thousands of rows):
    both widths (the LSTM's plans are rows 5 and 9's too) have a plan at B
    1, 33 and 5,000, within the card, whose row groups take the whole
    batch."""
    active = _measured(132)
    for width in (3, 4):
        for hidden in range(4, 265, 4):
            for batch in (1, 33, 5000):
                plan = lk.chain_plan(hidden, width, batch, 132, MAX_SMEM, active, forward,
                                     layers=2)
                assert plan.ctas <= 132 and plan.grid * plan.upc == hidden
                assert plan.smem <= MAX_SMEM
                ends = {plan.rows(c, batch).stop for c in range(0, plan.grid, plan.ncl)}
                assert max(ends) == batch


def test_pair_plan_at_the_gru_configs_shape():
    """B=32, H=256 on the H100: 4 units a CTA, 64 + 64 CTAs in clusters of
    2 (the only size the card holds 128 CTAs in), 4 row groups of one pass,
    32 units a cluster, the whole share in one chunk: the follow set's CTA
    forms 196,608 FMA a step, row 7's at H=512.  One row (the b1 serving
    forward) takes two row groups, one of them empty."""
    active = _measured(132)
    for forward, share in ((False, 2 * 3 * 256 // 4 // 2), (True, 2 * 256 // 4 // 2)):
        plan = lk.chain_plan(256, 3, 32, 132, MAX_SMEM, active, forward, layers=2)
        assert (plan.upc, plan.grid, plan.ctas, plan.ncl, plan.rgroups) == (4, 64, 128, 2, 4)
        assert plan.cluster_width == 32 and plan.kc == share
        assert PH * plan.outputs * 4 * share == 196_608
        one = lk.chain_plan(256, 3, 1, 132, MAX_SMEM, active, forward, layers=2)
        assert (one.ncl, one.rgroups) == (2, 2)


@pytest.mark.parametrize("forward", [False, True])
def test_pair_plan_at_the_flagship_shape(forward):
    """The flagship's LSTM 2x256 at B=32 on the H100 (rows 12 and 11, and
    their legacy twins 9 and 5): 4 units a CTA, 64 + 64
    CTAs in clusters of 2, 4 row groups of one pass, the whole share in one
    chunk (256 float4 columns of the reverse follow set's 8H row, 64 of the
    forward's 2H), 170,624 / 157,824 bytes of shared memory: the follow
    set's CTA forms 262,144 FMA a step, rows 4's and 6e's at H=512.  One
    row (the b1 serving forward) takes two row groups."""
    active = _measured(132)
    plan = lk.chain_plan(256, 4, 32, 132, MAX_SMEM, active, forward, layers=2)
    assert (plan.upc, plan.grid, plan.ctas, plan.ncl, plan.rgroups) == (4, 64, 128, 2, 4)
    assert plan.cluster_width == 32 and plan.kc == (64 if forward else 256)
    assert 4 * lk.chain_smem_floats(4, 256, 4, 2, 4, plan.kc, forward, layers=2) == (
        157_824 if forward else 170_624)
    assert PH * plan.outputs * 4 * plan.kc == 262_144
    one = lk.chain_plan(256, 4, 1, 132, MAX_SMEM, active, forward, layers=2)
    assert (one.ncl, one.rgroups) == (2, 2)


class _PlanLib:
    """The plan entries of a kernel library as ``chain_plan_on`` calls them
    through ctypes: the card (132 SMs, ``MAX_SMEM``) and each plan's
    resident clusters as ``_measured``; records the sources asked."""

    def __init__(self, asked):
        self.asked = asked

    def load(self, source):
        def card(sms, smem):
            sms._obj.value, smem._obj.value = 132, MAX_SMEM
            return 0

        def max_clusters(hidden, upc, ncl, rgroups, kc, count):
            self.asked.append(source)
            count._obj.value = _measured(132)(upc, ncl, rgroups, kc)
            return 0

        return type("Lib", (), {f"{source}_card": staticmethod(card),
                                f"{source}_max_clusters": staticmethod(max_clusters)})()


@pytest.mark.parametrize("legacy,native,width", [
    ("gru2_train_fwd_legacy", "gru2_train_fwd", 3),     # row 8 on row 14's plan
    ("lstm2_train_fwd_legacy", "lstm2_train_fwd", 4)])  # row 5 on row 11's
def test_legacy_forward_plans_are_the_residual_native_ones(monkeypatch, legacy, native,
                                                            width):
    """``chain_plan_on`` for each legacy training forward (the forward core
    with a legacy cell: the same products, buffers and shared memory) asks
    its own library and gets the residual-native form's plan, at every
    (H, B) of the pair's model cases."""
    import contextlib

    asked = []
    monkeypatch.setattr(lk, "load", _PlanLib(asked).load)
    monkeypatch.setattr(lk, "_CHAIN_PLANS", {})
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    dev = torch.device("cuda", 0)
    for hidden in (64, 132, 256, 260, 264):
        for batch in (1, 3, 16, 17, 32, 300):
            plans = [lk.chain_plan_on(src, width, hidden, batch, dev, True, layers=2)
                     for src in (legacy, native)]
            assert plans[0] == plans[1], (hidden, batch)
            assert plans[0] == lk.chain_plan(hidden, width, batch, 132, MAX_SMEM,
                                             _measured(132), True, layers=2)
    assert set(asked) == {legacy, native}


def test_pair_plan_refuses_what_no_card_runs():
    active = _every(132)
    for hidden, batch in ((268, 32), (532, 32), (1056, 1), (6, 32), (256, 0), (0, 4)):
        for forward in (False, True):
            with pytest.raises(ValueError):
                lk.chain_plan(hidden, 3, batch, 132, MAX_SMEM, active, forward, layers=2)
    # one layer takes what two do not
    assert lk.chain_plan(268, 3, 32, 132, MAX_SMEM, active).grid == 67
    with pytest.raises(ValueError):
        lk.chain_plan(256, 3, 32, 132, MAX_SMEM, active, layers=3)
    with pytest.raises(ValueError):
        lk.chain_plan(256, 3, 32, 132, MAX_SMEM, lambda upc, ncl, rgroups, kc: 0,
                      layers=2)


# ---------------------------------------------------------------------------
# A model of both cores
# ---------------------------------------------------------------------------


def _reduce_scatter(vals):
    """``warp_reduce_scatter<N0, L>`` over one group of L lanes, vals (L,
    N0): each level O = L/2 .. 1 halves an even count (the lane with lane &
    O keeps the upper half, plus its partner's copy of it) or adds all of
    an odd one."""
    held = np.array(vals)
    lanes = held.shape[0]
    idx = np.arange(lanes)
    o = lanes // 2
    while o >= 1:
        n = held.shape[1]
        peer = held[idx ^ o]
        if n % 2 == 0:
            up = (idx & o) != 0
            held = np.where(up[:, None], held[:, n // 2:] + peer[:, n // 2:],
                            held[:, :n // 2] + peer[:, :n // 2])
        else:
            held = held + peer
        o //= 2
    return held


def _levels(n0, lanes):
    s = 0
    while lanes > 1 and n0 % 2 == 0:
        s, n0, lanes = s + 1, n0 // 2, lanes // 2
    return s


def _thread_partials(x, w, nu, forward, kc):
    """One CTA's partial sums over one piece as its 256 threads form them:
    x (PH, 4 len) rows of the piece, w (outputs, 4 len) the weight tile
    over it, chunks of ``kc`` float4 columns; the reverse core's tiling
    (8 rows x UB units a thread, KS column slices, a warp's 32 lanes
    reduce-scattered) or the forward's (8 rows x 2 units' gate columns, L
    lanes of a column group, KW warps of it), and the kernel's rule of
    which lane writes which value where."""
    width = w.shape[0] // nu
    outputs, n4 = w.shape[0], x.shape[1] // 4
    chunks = [(c0, min(kc, n4 - c0)) for c0 in range(0, n4, kc)]
    if forward:
        ub = min(nu, 2)
        ob, og_n = width * ub, nu // ub
        tpg = lk.CHAIN_NT // og_n
        lanes, kw_n = min(tpg, 32), max(1, tpg // 32)
        groups = [(og, kw) for og in range(og_n) for kw in range(kw_n)]
        block = ob
    else:
        ub = min(nu, 8)
        ug_n = nu // ub
        kw_n, lanes = 8 // ug_n, 32
        tpg = 32 * kw_n
        groups = [(w_ % ug_n, w_ // ug_n) for w_ in range(8)]
        block = ub
    nv = PH * block
    s = _levels(nv, lanes)
    nf, ls = nv >> s, lanes >> s
    part = np.zeros((kw_n, PH, outputs))
    for og, kw in groups:
        acc = np.zeros((lanes, nv))
        for li in range(lanes):
            ks = li + lanes * kw
            cols = [c0 + c for c0, kn in chunks for c in range(ks, kn, tpg)]
            f = np.concatenate([np.arange(4 * c, 4 * c + 4) for c in cols]) if cols else []
            f = np.asarray(f, dtype=np.int64)
            acc[li] = (x[:, f] @ w[og * block:(og + 1) * block, f].T).reshape(-1)
        held = _reduce_scatter(acc)
        for li in range(lanes):
            if li % ls:
                continue
            for v in range(nf):
                idx = nf * (li // ls) + v  # row idx / block, column idx % block
                part[kw, idx // block, og * block + idx % block] += held[li, v]
    return part.sum(0)


def _pieces(plan, rank, follow):
    """The rank's share of the set's row cut at the [own | feed] boundary:
    [(segment, first, end)] in float4 columns, the nonempty ones."""
    share, e4 = plan.share(rank, follow), plan.exchanged // 4
    if not follow:
        cut = [(0, share.start, share.stop)]
    else:
        cut = [(0, share.start, min(share.stop, e4)), (1, max(share.start, e4), share.stop)]
    return [(seg, a, b) for seg, a, b in cut if a < b]


def _schedule(plan, t_len, rng, cluster_step):
    """Run every cluster of both sets through ``t_len`` steps in a random
    order the flag barriers allow: a cluster starts step s once every
    cluster of its set and row group has done s steps and, in the follow
    set, every lead cluster of its row group s + 1.  The lead set never
    waits for the follow set."""
    per_set = plan.grid // plan.ncl
    done = np.zeros((2, per_set), dtype=np.int64)
    group = np.arange(per_set) % plan.rgroups
    while (done < t_len).any():
        ready = []
        for f in (0, 1):
            for k in range(per_set):
                s, mates = done[f, k], group == group[k]
                if s < t_len and (done[f, mates] >= s).all() and (
                        f == 0 or (done[0, mates] >= s + 1).all()):
                    ready.append((f, k))
        assert ready, "the flag rule deadlocks"
        f, k = ready[rng.randint(len(ready))]
        cluster_step(bool(f), k * plan.ncl, int(done[f, k]))
        done[f, k] += 1


def _cluster_partials(plan, follow, c0, s, rows, source, weight, exact):
    """Each rank's partial sums over its pieces: {(rank, segment): (rows,
    outputs)}; the own segment contributes nothing at step 0."""
    out = {}
    for rank in range(plan.ncl):
        for seg, a, b in _pieces(plan, rank, follow):
            if seg == 0 and s == 0:
                continue
            base = 0 if seg == 0 else plan.exchanged // 4
            x = source(seg, rows)[:, 4 * (a - base):4 * (b - base)]
            w = weight(seg, c0)[:, 4 * (a - base):4 * (b - base)]
            if exact:
                xp = np.zeros((PH, x.shape[1]))
                xp[:len(rows)] = x
                kc = plan.kc
                out[rank, seg] = _thread_partials(xp, w, plan.cluster_width,
                                                  plan.forward, kc)[:len(rows)]
            else:
                out[rank, seg] = x @ w.T
    return out


def _sums(parts, ncl, seg, rows, col):
    total = np.zeros(len(rows))
    for rank in range(ncl):
        if (rank, seg) in parts:
            total += parts[rank, seg][:, col]
    return total


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def _gate_geom(plan, batch, din):
    """``rnn2_bwd::GateGeom``: (n, bgp, m, kin, kp, pieces) of one set's
    gate blocks."""
    n = 4 * plan.upc * plan.rgroups
    bgp = -(-(-(-batch // plan.rgroups)) // PH) * PH
    kin = din + plan.hidden
    kp = -(-(-(-kin // plan.rk)) // 4) * 4
    return n, bgp, plan.rk * bgp, kin, kp, -(-kin // kp)


class _GateBlocks:
    """``rnn2_bwd::GateBlocks`` of one CTA: its cells' gate pre-activations
    [x | h_prev] [w_ih; w_hh], formed ahead of the chain in blocks of
    ``plan.rk`` steps (the whole of block 0 before the first step, piece s
    % rk of block s / rk + 1 in step s), each piece over kp rows of the
    product's depth from the packed weights (``lk.gate_columns``) and the
    input rows staged for it, the bias starting each block's sums; rows the
    kernel does not stage are NaN, and so are the blocks before they are
    formed."""

    def __init__(self, plan, cta, batch, xin, hin, wcat, bias):
        self.plan, self.t_len, self.bias = plan, xin.shape[0], bias
        self.rows = plan.rows(cta, batch)
        self.units = plan.units(cta)
        self.n, self.bgp, self.m, self.kin, self.kp, self.pieces = _gate_geom(
            plan, batch, xin.shape[2])
        assert 4 * (2 * self.m * self.n + self.m * (-(-self.kp // 8) * 8 + 4)
                    + self.kp * self.n + 4) == 4 * lk.remat_gate_floats(
                        plan.hidden, plan.upc, plan.rgroups, batch, xin.shape[2], plan.rk)
        u = plan.upc * plan.rgroups
        blk = self.units.start // u
        self.w = lk.gate_columns(torch.from_numpy(wcat), u)[blk].numpy()
        self.inputs = np.concatenate([xin, hin], axis=2)
        self.buf = [np.full((self.m, self.n), np.nan) for _ in range(2)]

    def live(self, blk):
        return blk * self.plan.rk < self.t_len

    def form(self, p, blk):
        k0 = p * self.kp
        kn = min(self.kp, self.kin - k0)
        if kn <= 0:
            return
        staged = np.full((self.m, kn), np.nan)
        for m in range(self.m):
            s, b = blk * self.plan.rk + m // self.bgp, self.rows.start + m % self.bgp
            if s < self.t_len and b < self.rows.stop:
                staged[m] = self.inputs[self.t_len - 1 - s, b, k0:k0 + kn]
        part = staged @ self.w[k0:k0 + kn].astype(np.float64)
        if p == 0:
            u, h = self.plan.upc * self.plan.rgroups, self.plan.hidden
            cols = [q * h + j for q in range(4) for j in self.units]
            assert len(cols) == self.n and self.units.start % u == 0
            self.buf[blk & 1] = part + self.bias[cols]
        else:
            self.buf[blk & 1] = self.buf[blk & 1] + part

    def step(self, s):
        """Step s's hook: the whole of block 0 first, then its piece."""
        rk = self.plan.rk
        if s == 0:
            for p in range(self.pieces):
                self.form(p, 0)
        if s % rk < self.pieces and self.live(s // rk + 1):
            self.form(s % rk, s // rk + 1)

    def gates(self, s, rows, j):
        rk, u = self.plan.rk, self.plan.upc * self.plan.rgroups
        g = self.buf[(s // rk) & 1][(s % rk) * self.bgp + rows - self.rows.start]
        cu = j - self.units.start
        return [g[:, q * u + cu] for q in range(4)]


def _model_bwd(plan, cell, packed, prev, keep, dh, w_hh0, w_hh1, w_ih1, seed, exact,
               dys=None, remat=None, ring=False):
    """``pair_kernel`` of csrc/rnn2_bwd_chain.cuh with ``cell`` "gru",
    "lstm", "remat" (``LstmRematCell``), "gru_legacy" (``GruLegacyCell``) or
    "lstm_legacy" (``LstmLegacyCell``): the lead set layer 1's chain over
    its own row, the follow set layer 0's over [own | layer 1's dih or dg].
    ``prev``: the GRU's (h0_prev, h1_prev), the legacy GRU's rows (res0,
    res1) (T, B, 5H) = [h_prev | r | z | n | hn]; the LSTM's c_prev is
    inside ``packed`` (the remat cell's (T, B, 2H) = [c0_prev | c1_prev]).
    The legacy GRU writes (T, B, 12H) rows [dih0 | dhh0 | dih1 | dhh1],
    exchanges each layer's dhh lanes and adds ``dys`` to layer 1's dh ->
    ((dih0, dhh0), (dih1, dhh1)); the legacy LSTM writes and exchanges the
    (T, B, 8H) rows [dg0 | dg1] and adds ``dys`` to layer 1's dh.  The
    remat cell's ``remat`` = (x (T, B, D), x1, h0p, h1p, [w_ih0; w_hh0],
    [w_ih1; w_hh1], b0, b1): its gates come from ``_GateBlocks``.  With
    ``ring`` (the bf16 forms' exchange, GRU and LSTM cells) layer 0 reads
    its own row from two slots used in turn, written beside its series."""
    t_len, batch, hidden = keep.shape
    lstm = cell in ("lstm", "remat", "lstm_legacy")
    legacy = cell == "gru_legacy"
    nan = np.full
    # GRU dih (3H) and dhn; LSTM dg (4H), the legacy LSTM's the lanes of
    # its 8H rows; the legacy GRU's 12H rows
    out = [nan((t_len, batch, plan.width * hidden), np.nan) for _ in range(2)]
    if cell == "lstm_legacy":
        rows8 = nan((t_len, batch, 8 * hidden), np.nan)
        out = [rows8[..., :4 * hidden], rows8[..., 4 * hidden:]]
    dhn = [nan((t_len, batch, hidden), np.nan) for _ in range(2)]
    # the bf16 forms' exchange of layer 0: [out | dhn] rows t at t % 2
    ex0 = nan((2, batch, (plan.width + 1) * hidden), np.nan)
    rows12 = nan((t_len, batch, 12 * hidden), np.nan)
    # GRU: the direct part dh z, layer 1's starting as dh_final; LSTM: dc
    carry = [np.zeros((batch, hidden)),
             np.zeros((batch, hidden)) if lstm else dh.astype(np.float64)]
    w_own = (w_hh0, w_hh1)
    blocks = {}
    if cell == "remat":
        x, x1, h0p, h1p, wcat0, wcat1, b0, b1 = remat
        for cta in range(plan.ctas):
            layer = 0 if cta >= plan.grid else 1
            blocks[cta] = _GateBlocks(plan, cta, batch, (x, x1)[layer], (h0p, h1p)[layer],
                                      (wcat0, wcat1)[layer], (b0, b1)[layer])

    def x_row(layer, step, rows):
        if ring and layer == 0:
            row = ex0[step % 2][rows]
            return row[:, :4 * hidden] if lstm else np.concatenate(
                [row[:, :2 * hidden], row[:, 3 * hidden:]], axis=1)
        if lstm:
            return out[layer][step][rows]
        if legacy:
            return rows12[step][rows, 6 * hidden * layer + 3 * hidden:6 * hidden * (layer + 1)]
        return np.concatenate([out[layer][step][rows, :2 * hidden],
                               dhn[layer][step][rows]], axis=1)

    def legacy_cell(layer, t, rows, j, d):
        hp, r, z, n, hn = (prev[layer][t][rows, i * hidden + j] for i in range(5))
        d = carry[layer][rows, j] + d
        if layer == 1 and dys is not None:
            d = d + dys[t][rows, j]
        dn = d * (1 - z) * (1 - n * n)
        base = 6 * hidden * layer + j
        for lane, v in ((0, dn * hn * r * (1 - r)), (1, d * (hp - n) * z * (1 - z)),
                        (2, dn)):
            rows12[t][rows, base + lane * hidden] = v
            if lane < 2:
                rows12[t][rows, base + (3 + lane) * hidden] = v
        rows12[t][rows, base + 5 * hidden] = dn * r
        carry[layer][rows, j] = d * z

    def gru_cell(layer, t, rows, j, d):
        r, z, n, hn = (packed[t][rows, 4 * hidden * layer + i * hidden + j]
                       for i in range(4))
        hp = prev[layer][t][rows, j]
        d = carry[layer][rows, j] + d
        dn = d * (1 - z) * (1 - n * n)
        for lane, v in enumerate((dn * hn * r * (1 - r), d * (hp - n) * z * (1 - z), dn,
                                  dn * r)):
            (dhn[layer][t] if lane == 3 else out[layer][t])[
                rows, (lane % 3) * hidden + j] = v
            if ring and layer == 0:
                ex0[t % 2][rows, lane * hidden + j] = v
        carry[layer][rows, j] = d * z

    def lstm_cell(layer, t, rows, j, d, cta=None):
        if cell == "remat":
            gi, gf, gg, go = blocks[cta].gates(t_len - 1 - t, rows, j)
            cp = packed[t][rows, hidden * layer + j]
        else:
            gi, gf, gg, go = (packed[t][rows, 4 * hidden * layer + i * hidden + j]
                              for i in range(4))
            cp = packed[t][rows, 8 * hidden + hidden * layer + j]
        if layer == 1 and dys is not None:
            d = d + dys[t][rows, j]
        if layer == 1 and t == t_len - 1:
            d = d + dh[rows, j]
        si, sf, so, tg = _sig(gi), _sig(gf), _sig(go), np.tanh(gg)
        tc = np.tanh(sf * cp + si * tg)
        dcs = carry[layer][rows, j] + d * so * (1 - tc * tc)
        for lane, v in enumerate((dcs * tg * si * (1 - si), dcs * cp * sf * (1 - sf),
                                  dcs * si * (1 - tg * tg), d * tc * so * (1 - so))):
            out[layer][t][rows, lane * hidden + j] = v
            if ring and layer == 0:
                ex0[t % 2][rows, lane * hidden + j] = v
        carry[layer][rows, j] = dcs * sf

    def cluster_step(follow, c0, s):
        layer, t = (0 if follow else 1), t_len - 1 - s
        units = plan.cluster_units(c0)
        grows = plan.rows(c0, batch)
        cta0 = c0 + (plan.grid if follow else 0)
        for rank in range(plan.ncl):
            if cta0 + rank in blocks:
                blocks[cta0 + rank].step(s)

        def source(seg, rows):
            if seg == 0:
                return x_row(layer, t + 1, rows)
            return rows12[t][rows, 6 * hidden:9 * hidden] if legacy else out[1][t][rows]

        def weight(seg, c):
            return (w_own[layer] if seg == 0 else w_ih1)[units.start:units.stop]

        for p0 in range(grows.start, grows.stop, PH):
            rows = np.arange(p0, min(p0 + PH, grows.stop))
            parts = _cluster_partials(plan, follow, c0, s, rows, source, weight, exact)
            for rank in range(plan.ncl):
                for j in plan.units(c0 + rank):
                    col = j - units.start
                    own = _sums(parts, plan.ncl, 0, rows, col)
                    feed = _sums(parts, plan.ncl, 1, rows, col)
                    kv = keep[t][rows, j] if layer == 0 else 0.0
                    if lstm:
                        lstm_cell(layer, t, rows, j, own + kv * feed, cta0 + rank)
                    else:
                        (legacy_cell if legacy else gru_cell)(layer, t, rows, j,
                                                              own + kv * feed)

    _schedule(plan, t_len, np.random.RandomState(seed), cluster_step)
    if legacy:
        d = np.split(rows12, 4, axis=2)
        return (d[0], d[1]), (d[2], d[3])
    return (out[0], out[1]) if lstm else (out[0], dhn[0], out[1], dhn[1])


def _model_fwd(plan, cell, ih0, l0, l1, seed, exact, keep=None, store_gates=True,
               ring=False):
    """``pair_kernel`` of csrc/rnn2_fwd_chain.cuh with ``cell`` "gru",
    "lstm" or (training form only) "lstm_legacy" (``LstmLegacyCell``) or
    "gru_legacy" (``GruLegacyCell``): the lead set layer 0 over its own h,
    the follow set layer 1 over [own h | feed]; the carry h (GRU) or c
    (LSTM).

    The eval form (``keep`` None): ih0 (B, T, W H), the feed h0, the lead
    set storing the h0 series, the follow set its h in two slots -> the
    final h1.  The training form: ih0 (T, B, W H), ``keep`` (T, B, H), the
    feed x1 = h0 keep, both sets reading and storing the whole h0p / h1p /
    x1 series and storing the packed rows (the LSTM's without the gates
    unless ``store_gates``) and the finals -> ``(packed, h0p, h1p, x1,
    finals)``.  The legacy LSTM stores the (T, B, 12H) rows [g0 | g1 | h0 |
    h1 | c0 | c1] (the states after each step), the legacy GRU the (T, B,
    10H) rows [r0 | z0 | n0 | hn0 | h0 | r1 | z1 | n1 | hn1 | h1], both
    h0p / h1p / x1 as the exchange only (row 0 of h0p / h1p never written)
    and layer 1's final h alone -> ``(res, h_final)``.  With ``ring`` (the
    bf16 forms' exchange) each layer reads its own h from two slots used in
    turn, written beside its h_prev series.  Every buffer starts NaN, so a
    read before its write shows."""
    train = keep is not None
    t_len, batch = (ih0.shape[0], ih0.shape[1]) if train else (ih0.shape[1], ih0.shape[0])
    hidden, width = l0["w_hh"].shape[0], plan.width
    legacy = cell in ("lstm_legacy", "gru_legacy")
    lstm = cell in ("lstm", "lstm_legacy")
    nan = np.full
    if train:
        pw = (10 if store_gates else 2) * hidden if lstm else 8 * hidden
        if legacy:
            pw = (12 if lstm else 10) * hidden
        packed = nan((t_len, batch, pw), np.nan)
        hp = [nan((t_len, batch, hidden), np.nan) for _ in range(2)]
        x1 = nan((t_len, batch, hidden), np.nan)
        ex = [nan((2, batch, hidden), np.nan) for _ in range(2)]  # ring: row t at t % 2
        finals = nan((1 if legacy else 4 if lstm else 2, batch, hidden), np.nan)
    else:
        h0 = nan((t_len, batch, hidden), np.nan)
        h1 = nan((2, batch, hidden), np.nan)
    carry = [np.zeros((batch, hidden)), np.zeros((batch, hidden))]

    # a cell: (layer, input part x, gate columns, own and fed products,
    # carry before) -> (h, carry after, what the training form stores in
    # the layer's lanes of packed, a lane a row)
    def gru_cell(layer, x, gate, own, fed, cp):
        bh = (l0 if layer == 0 else l1)["b_hh"][gate]
        hn = own[2] + bh[2]
        r = _sig(x[0] + fed[0] + own[0] + bh[0])
        z = _sig(x[1] + fed[1] + own[1] + bh[1])
        n = np.tanh(x[2] + fed[2] + r * hn)
        h = (1 - z) * n + z * cp
        if legacy:
            return h, h, {5 * layer + i: v for i, v in enumerate((r, z, n, hn, h))}
        return h, h, {4 * layer + i: v for i, v in enumerate((r, z, n, hn))}

    def lstm_cell(layer, x, gate, own, fed, cp):
        g = [x[q] + fed[q] + own[q] for q in range(4)]
        c = _sig(g[1]) * cp + _sig(g[0]) * np.tanh(g[2])
        h = _sig(g[3]) * np.tanh(c)
        lanes = {4 * layer + q: g[q] for q in range(4)}
        if legacy:
            lanes.update({8 + layer: h, 10 + layer: c})
        else:
            lanes[8 + layer] = cp
        return h, c, lanes if store_gates or legacy else {layer: cp}

    def cluster_step(follow, c0, t):
        layer = 1 if follow else 0
        units = plan.cluster_units(c0)
        grows = plan.rows(c0, batch)
        cols = [q * hidden + u for u in units for q in range(width)]

        def source(seg, rows):
            if train:
                if seg == 0 and ring:
                    return ex[layer][t % 2][rows]
                return (x1 if seg == 1 else hp[layer])[t][rows]
            if seg == 1 or layer == 0:
                return h0[t if seg == 1 else t - 1][rows]
            return h1[(t - 1) % 2][rows]

        def weight(seg, c):
            w = (l1 if layer == 1 else l0)["w_hh"] if seg == 0 else l1["w_ih"]
            return w[:, cols].T

        for p0 in range(grows.start, grows.stop, PH):
            rows = np.arange(p0, min(p0 + PH, grows.stop))
            parts = _cluster_partials(plan, follow, c0, t, rows, source, weight, exact)
            for rank in range(plan.ncl):
                for j in plan.units(c0 + rank):
                    oc = width * (j - units.start)
                    gate = [q * hidden + j for q in range(width)]
                    own = [_sums(parts, plan.ncl, 0, rows, oc + q) for q in range(width)]
                    fed = [_sums(parts, plan.ncl, 1, rows, oc + q) for q in range(width)]
                    # the input part: layer 0's ih0, or layer 1's bias (b_ih1 / b1)
                    if layer == 1:
                        x = l1["b" if lstm else "b_ih"][gate][:, None]
                    else:
                        x = (ih0[t][rows] if train else ih0[rows, t])[:, gate].T
                    h, carry[layer][rows, j], lanes = (lstm_cell if lstm else gru_cell)(
                        layer, x, gate, own, fed, carry[layer][rows, j])
                    if not train:
                        if layer == 0:
                            h0[t][rows, j] = h
                        else:
                            h1[t % 2][rows, j] = h
                        continue
                    for lane, v in lanes.items():
                        packed[t][rows, lane * hidden + j] = v
                    if layer == 0:
                        x1[t][rows, j] = h * keep[t][rows, j]
                    if t == 0 and not legacy:
                        hp[layer][0][rows, j] = 0.0
                        ex[layer][0][rows, j] = 0.0
                    if t + 1 < t_len:
                        hp[layer][t + 1][rows, j] = h
                        ex[layer][(t + 1) % 2][rows, j] = h
                    elif legacy:
                        if layer == 1:
                            finals[0][rows, j] = h
                    else:
                        fh = 2 * layer if lstm else layer
                        finals[fh][rows, j] = h
                        if lstm:
                            finals[fh + 1][rows, j] = carry[layer][rows, j]

    _schedule(plan, t_len, np.random.RandomState(seed), cluster_step)
    if legacy:
        return packed, finals[0]
    if train:
        return packed, hp[0], hp[1], x1, finals
    return h1[(t_len - 1) % 2]


def _gru_layers(rng, d, h):
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        p = {name: rng.uniform(-k, k, shape).astype(np.float32)
             for name, shape in (("w_ih", (d_in, 3 * h)), ("w_hh", (h, 3 * h)),
                                 ("b_ih", (3 * h,)), ("b_hh", (3 * h,)))}
        p["b_ih"][:h] = rng.uniform(-1.5, -0.5, h)  # r away from 1
        return p

    return layer(d), layer(h)


def _lstm_layers(rng, d, h):
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        return {name: rng.uniform(-k, k, shape).astype(np.float32)
                for name, shape in (("w_ih", (d_in, 4 * h)), ("w_hh", (h, 4 * h)),
                                    ("b", (4 * h,)))}

    return layer(d), layer(h)


def _case(cell, batch, t_len, d, hidden, seed):
    """The same draws for the model and the JAX kernels: layers, x (B, T,
    D), keep (T, B, H), dh_final (B, H)."""
    rng = np.random.RandomState(seed)
    l0, l1 = (_lstm_layers if cell == "lstm" else _gru_layers)(rng, d, hidden)
    x = rng.randn(batch, t_len, d).astype(np.float32)
    keep = ((rng.rand(t_len, batch, hidden) < 0.9) / 0.9).astype(np.float32)
    dh = rng.randn(batch, hidden).astype(np.float32)
    return l0, l1, x, keep, dh


def _check_model(plan, batch, t_len, d, hidden, seed, exact, cell="gru", ring=False):
    l0, l1, x, keep, dh = _case(cell, batch, t_len, d, hidden, seed)
    tl0 = {k: torch.from_numpy(v) for k, v in l0.items()}
    tl1 = {k: torch.from_numpy(v) for k, v in l1.items()}
    xt = torch.from_numpy(x)
    lstm = cell == "lstm"
    if plan.forward:
        ih0 = x.astype(np.float64) @ l0["w_ih"] + l0["b" if lstm else "b_ih"]
        got = _model_fwd(plan, cell, ih0, l0, l1, seed, exact)
        want = (lk.lstm2_infer_reference if lstm else lk.gru2_infer_reference)(
            xt, tl0, tl1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        return got
    fwd = lk.lstm2_train_fwd_reference if lstm else lk.gru2_train_fwd_reference
    packed, h0p, h1p, _, _ = (a.numpy() for a in fwd(
        xt.transpose(0, 1), torch.from_numpy(keep), tl0, tl1))
    w = (l0["w_hh"], l1["w_hh"], l1["w_ih"])
    got = _model_bwd(plan, cell, packed, (h0p, h1p), keep, dh, *w, seed, exact,
                     ring=ring)
    if lstm:
        names = ("dg0", "dg1")
        want = lk.lstm2_bwd_chain_reference(
            *(torch.from_numpy(a) for a in (packed, keep, dh, *w)))
    else:
        names = ("dih0", "dhn0", "dih1", "dhn1")
        want = lk.gru2_bwd_chain_reference(
            *(torch.from_numpy(a) for a in (packed, h0p, h1p, keep, dh, *w)))
    for name, g, w in zip(names, got, want):
        assert not np.isnan(g).any(), f"{name}: a read before the write"
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-6, err_msg=name)
    return got


def _check_remat_model(plan, batch, t_len, d, hidden, seed, exact):
    """The reverse core with the remat cell (row 13) over the no-gates
    forward's residuals, D padded to a multiple of 4 as the wrapper pads
    it, one launch a ``plan.batch_slice`` of the batch where the plan has
    one (each over its slice's rows), against
    ``lstm2_bwd_chain_remat_reference`` of the whole batch (1e-6)."""
    l0, l1, x, keep, dh = _case("lstm", batch, t_len, d, hidden, seed)
    x_tm = np.ascontiguousarray(x.transpose(1, 0, 2))
    tl0 = {k: torch.from_numpy(v) for k, v in l0.items()}
    tl1 = {k: torch.from_numpy(v) for k, v in l1.items()}
    packed, h0p, h1p, x1, _ = (a.numpy() for a in lk.lstm2_train_fwd_reference(
        torch.from_numpy(x_tm), torch.from_numpy(keep), tl0, tl1, store_gates=False))
    d4 = -(-d // 4) * 4
    wcat0 = np.concatenate([np.pad(l0["w_ih"], ((0, d4 - d), (0, 0))), l0["w_hh"]])
    wcat1 = np.concatenate([l1["w_ih"], l1["w_hh"]])
    xp = np.pad(x_tm, ((0, 0), (0, 0), (0, d4 - d)))
    rows = plan.batch_slice or batch
    got = [[], []]
    for r0 in range(0, batch, rows):
        sl = slice(r0, min(batch, r0 + rows))
        remat = (xp[:, sl], x1[:, sl], h0p[:, sl], h1p[:, sl], wcat0, wcat1, l0["b"],
                 l1["b"])
        for i, g in enumerate(_model_bwd(plan, "remat", packed[:, sl], None, keep[:, sl],
                                         dh[sl], l0["w_hh"], l1["w_hh"], l1["w_ih"],
                                         seed + r0, exact, remat=remat)):
            got[i].append(g)
    got = [np.concatenate(g, axis=1) for g in got]
    want = lk.lstm2_bwd_chain_remat_reference(
        *(torch.from_numpy(a) for a in (packed, keep, x_tm, x1, h0p, h1p, dh)), tl0, tl1)
    for name, g, w in zip(("dg0", "dg1"), got, want):
        assert not np.isnan(g).any(), f"{name}: a read before the write"
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-6, err_msg=name)
    return got, (l0, l1, x_tm, keep, dh, packed, h0p, h1p, x1)


def _legacy_rows(x_tm, keep, tl0, tl1):
    """The legacy GRU chain's residuals as the legacy route builds them:
    each layer's (h_prev, r, z, n, hn) series (T, B, H)."""
    _, _, layers = lk.gru2_train_fwd_legacy_reference(
        torch.from_numpy(x_tm), torch.from_numpy(keep), tl0, tl1)
    out = []
    for lay in layers:
        h = lay[4].numpy()
        out.append((np.concatenate([np.zeros_like(h[:1]), h[:-1]]),
                    *(a.numpy() for a in lay[:4])))
    return out


def _check_legacy_model(plan, batch, t_len, d, hidden, seed, exact, with_dys):
    """The reverse core with the legacy GRU cell (row 10) over the legacy
    forward's residuals packed as (T, B, 5H) rows, with or without dys,
    against ``gru2_bwd_chain_legacy_reference`` (1e-6)."""
    l0, l1, x, keep, dh = _case("gru", batch, t_len, d, hidden, seed)
    x_tm = np.ascontiguousarray(x.transpose(1, 0, 2))
    tl0 = {k: torch.from_numpy(v) for k, v in l0.items()}
    tl1 = {k: torch.from_numpy(v) for k, v in l1.items()}
    res0, res1 = _legacy_rows(x_tm, keep, tl0, tl1)
    dys = (np.random.RandomState(seed + 1).randn(t_len, batch, hidden).astype(np.float32)
           if with_dys else None)
    w = (l0["w_hh"], l1["w_hh"], l1["w_ih"])
    got = _model_bwd(plan, "gru_legacy", None, tuple(np.concatenate(r, axis=2)
                                                     for r in (res0, res1)),
                     keep, dh, *w, seed, exact, dys=dys)
    want = lk.gru2_bwd_chain_legacy_reference(
        [torch.from_numpy(a) for a in res0], [torch.from_numpy(a) for a in res1],
        None if dys is None else torch.from_numpy(dys), torch.from_numpy(keep),
        torch.from_numpy(dh), *(torch.from_numpy(a) for a in w))
    for i in range(2):
        for j, name in enumerate(("dih", "dhh")):
            g = got[i][j]
            assert not np.isnan(g).any(), f"{name}{i}: a read before the write"
            np.testing.assert_allclose(g, want[i][j].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{name}{i}")
        np.testing.assert_array_equal(got[i][1][..., :2 * hidden], got[i][0][..., :2 * hidden])
    return got, (l0, l1, keep, dh, res0, res1, dys)


def _shift(a):
    """The series before each step from the series after it."""
    return np.concatenate([np.zeros_like(a[:1]), a[:-1]])


LEGACY_LSTM_NAMES = ("ys", "h_final", "g0", "g1", "h0_new", "c0_new", "c1_new")


def _check_legacy_lstm_fwd_model(plan, batch, t_len, d, hidden, seed, exact):
    """The forward core's training form with the legacy LSTM cell (row 5):
    the 12H rows [g0 | g1 | h0 | h1 | c0 | c1] and h_final, read as the
    wrapper's 7-tuple, against ``lstm2_train_fwd_legacy_reference``
    (1e-6); keep has zeros (p = 0.1)."""
    l0, l1, x, keep, _ = _case("lstm", batch, t_len, d, hidden, seed)
    x_tm = np.ascontiguousarray(x.transpose(1, 0, 2))
    ih0 = x_tm.astype(np.float64) @ l0["w_ih"] + l0["b"]
    res, h_final = _model_fwd(plan, "lstm_legacy", ih0, l0, l1, seed, exact, keep=keep)
    g0, g1, h0, ys, c0, c1 = np.split(res, np.cumsum([4, 4, 1, 1, 1])[:] * hidden, axis=2)
    got = (ys, h_final, g0, g1, h0, c0, c1)
    want = lk.lstm2_train_fwd_legacy_reference(
        torch.from_numpy(x_tm), torch.from_numpy(keep),
        *({k: torch.from_numpy(v) for k, v in layer.items()} for layer in (l0, l1)))
    for name, g, w in zip(LEGACY_LSTM_NAMES, got, want):
        assert not np.isnan(g).any(), f"{name}: a read before the write, or unwritten"
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-6, err_msg=name)
    return got, (l0, l1, x_tm, keep)


LEGACY_GRU_NAMES = ("ys", "h_final") + tuple(
    f"{n}{i}" for i in range(2) for n in ("r", "z", "n", "hn", "h_new"))


def _flat_legacy_gru(out):
    """``(ys, h_final, ((r0, .., h0_new), (r1, .., h1_new)))`` as one tuple
    in ``LEGACY_GRU_NAMES`` order."""
    ys, h_final, layers = out
    return (ys, h_final, *layers[0], *layers[1])


def _check_legacy_gru_fwd_model(plan, batch, t_len, d, hidden, seed, exact):
    """The forward core's training form with the legacy GRU cell (row 8):
    the 10H rows [r0 | z0 | n0 | hn0 | h0 | r1 | z1 | n1 | hn1 | h1] and
    h_final, cut into the wrapper's structure by
    ``gru2_train_fwd_legacy_views``, against
    ``gru2_train_fwd_legacy_reference`` (1e-6); keep has zeros (p = 0.1)."""
    l0, l1, x, keep, _ = _case("gru", batch, t_len, d, hidden, seed)
    x_tm = np.ascontiguousarray(x.transpose(1, 0, 2))
    ih0 = x_tm.astype(np.float64) @ l0["w_ih"] + l0["b_ih"]
    res, h_final = _model_fwd(plan, "gru_legacy", ih0, l0, l1, seed, exact, keep=keep)
    views = lk.gru2_train_fwd_legacy_views(torch.from_numpy(res), torch.from_numpy(h_final))
    got = tuple(v.numpy() for v in _flat_legacy_gru(views))
    want = _flat_legacy_gru(lk.gru2_train_fwd_legacy_reference(
        torch.from_numpy(x_tm), torch.from_numpy(keep),
        *({k: torch.from_numpy(v) for k, v in layer.items()} for layer in (l0, l1))))
    for name, g, w in zip(LEGACY_GRU_NAMES, got, want):
        assert not np.isnan(g).any(), f"{name}: a read before the write, or unwritten"
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-6, err_msg=name)
    return got, (l0, l1, x_tm, keep)


def _check_legacy_lstm_model(plan, batch, t_len, d, hidden, seed, exact, with_dys):
    """The reverse core with the legacy LSTM cell (row 9) over the plain
    legacy forward's gate and shifted c series, packed into (T, B, 10H) as
    the wrapper packs them, the 8H rows [dg0 | dg1] written and exchanged,
    with or without dys, against ``lstm2_bwd_chain_legacy_reference``
    (1e-6)."""
    l0, l1, x, keep, dh = _case("lstm", batch, t_len, d, hidden, seed)
    x_tm = np.ascontiguousarray(x.transpose(1, 0, 2))
    _, _, g0, g1, _, c0, c1 = (a.numpy() for a in lk.lstm2_train_fwd_legacy_reference(
        torch.from_numpy(x_tm), torch.from_numpy(keep),
        *({k: torch.from_numpy(v) for k, v in layer.items()} for layer in (l0, l1))))
    cp0, cp1 = _shift(c0), _shift(c1)
    dys = (np.random.RandomState(seed + 1).randn(t_len, batch, hidden).astype(np.float32)
           if with_dys else None)
    w = (l0["w_hh"], l1["w_hh"], l1["w_ih"])
    packed = np.concatenate([g0, g1, cp0, cp1], axis=2)
    got = _model_bwd(plan, "lstm_legacy", packed, None, keep, dh, *w, seed, exact, dys=dys)
    args = (g0, g1, cp0, cp1, dys, keep, dh, *w)
    want = lk.lstm2_bwd_chain_legacy_reference(
        *(None if a is None else torch.from_numpy(a) for a in args))
    for name, g, v in zip(("dg0", "dg1"), got, want):
        assert not np.isnan(g).any(), f"{name}: a read before the write"
        np.testing.assert_allclose(g, v.numpy(), rtol=0, atol=1e-6, err_msg=name)
    return got, args


TRAIN_NAMES = ("packed", "h0_prev", "h1_prev", "x1", "finals")
# the training forms: the cell and, for the LSTM, whether it stores the gates
TRAIN_FORMS = [("lstm", True), ("lstm", False), ("gru", True)]


def _check_train_model(plan, batch, t_len, d, hidden, seed, exact, cell, store_gates,
                       ring=False):
    """The training form of the forward core's model against
    ``lstm2_train_fwd_reference`` (``store_gates`` either way) or
    ``gru2_train_fwd_reference`` (1e-6); keep has zeros (p = 0.1)."""
    l0, l1, x, keep, _ = _case(cell, batch, t_len, d, hidden, seed)
    lstm = cell == "lstm"
    x_tm = x.transpose(1, 0, 2)
    ih0 = x_tm.astype(np.float64) @ l0["w_ih"] + l0["b" if lstm else "b_ih"]
    got = _model_fwd(plan, cell, ih0, l0, l1, seed, exact, keep=keep,
                     store_gates=store_gates, ring=ring)
    args = [torch.from_numpy(a) for a in (x_tm, keep)] + [
        {k: torch.from_numpy(v) for k, v in layer.items()} for layer in (l0, l1)]
    if lstm:
        want = lk.lstm2_train_fwd_reference(*args, store_gates=store_gates)
    else:
        want = lk.gru2_train_fwd_reference(*args)
    for name, g, w in zip(TRAIN_NAMES, got, want):
        assert not np.isnan(g).any(), f"{name}: a read before the write, or unwritten"
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-6, err_msg=name)
    return got, (l0, l1, x_tm, keep)


# (B, T, H, SMs, stub, (cluster size, row groups)) and whether each CTA's
# partials come from the model of its threads
MODEL_CASES = [
    (3, 5, 16, 132, "every", (8, 2), False),     # clusters of 8, ranks 4..7 the feed
    (17, 2, 8, 132, "measured", (8, 1), False),  # one row group: 3 passes, one ragged
    (17, 2, 64, 132, "measured", (2, 4), False),  # clusters of 2, 4 row groups
    (5, 5, 12, 132, "every", (4, 1), False),     # clusters of 4
    (2, 3, 20, 10, "every", (1, 1), False),      # an odd grid: both pieces in one CTA
    (1, 5, 16, 132, "measured", (8, 2), False),  # one row: an empty row group
    (9, 1, 16, 132, "every", (8, 2), False),     # one step: the feed only
    (3, 2, 16, 132, "every", (8, 2), True),      # the threads' tiles and shuffles
    (10, 2, 12, 6, "every", (1, 1), True),       # the threads, both pieces in a CTA
]


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("batch,t_len,hidden,sms,stub,split,exact", MODEL_CASES)
def test_pair_core_model_matches_plain(forward, batch, t_len, hidden, sms, stub, split,
                                       exact):
    active = (_measured if stub == "measured" else _every)(sms)
    plan = lk.chain_plan(hidden, 3, batch, sms, MAX_SMEM, active, forward, layers=2)
    assert (plan.ncl, plan.rgroups) == split, plan
    _check_model(plan, batch, t_len, 5, hidden, seed=batch * 10 + t_len + hidden, exact=exact)


@pytest.mark.parametrize("forward", [False, True])
def test_pair_core_model_matches_the_jax_kernels(forward):
    """At the JAX kernels' shapes (H % 128 == 0, B >= 8; T 5, not a multiple
    of their chunk): the model on the H100's plan against
    ``gru2_infer_pallas`` / ``gru2_bwd_chain_res_padded`` in interpret
    mode, matmul precision "highest"."""
    batch, t_len, d, hidden, seed = 8, 5, 12, 128, 3
    plan = lk.chain_plan(hidden, 3, batch, 132, MAX_SMEM, _measured(132), forward,
                         layers=2)
    assert (plan.upc, plan.ctas, plan.ncl, plan.rgroups) == (2, 128, 2, 2)
    got = _check_model(plan, batch, t_len, d, hidden, seed, exact=False)
    l0, l1, x, keep, dh = _case("gru", batch, t_len, d, hidden, seed)
    with jax.default_matmul_precision("highest"):
        if forward:
            want = np.asarray(gru2_infer_pallas(jnp.asarray(x), l0, l1, interpret=True))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            return
        packed, h0p, h1p, _, keep_pad, _, _ = jax_train_fwd(
            jnp.asarray(x.transpose(1, 0, 2)), jnp.asarray(keep), l0, l1, interpret=True)
        want = gru2_bwd_chain_res_padded(packed, h0p, h1p, keep_pad, None, jnp.asarray(dh),
                                         l0["w_hh"], l1["w_hh"], l1["w_ih"], t_len,
                                         interpret=True)
    for name, g, w in zip(("dih0", "dhn0", "dih1", "dhn1"), got, want):
        np.testing.assert_allclose(g, np.asarray(w)[:t_len], rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("batch,t_len,hidden,sms,stub,split,exact", MODEL_CASES)
def test_lstm_pair_core_model_matches_plain(forward, batch, t_len, hidden, sms, stub,
                                            split, exact):
    """The cores with the LSTM cell (rows 12 and 2): the carries dc and c,
    the packed 10H residuals, dh_final at the lead set's first step, 4 gate
    sums a unit in the forward, against ``lstm2_bwd_chain_reference`` /
    ``lstm2_infer_reference`` on the GRU cases' plans."""
    active = (_measured if stub == "measured" else _every)(sms)
    plan = lk.chain_plan(hidden, 4, batch, sms, MAX_SMEM, active, forward, layers=2)
    assert (plan.ncl, plan.rgroups) == split, plan
    _check_model(plan, batch, t_len, 5, hidden, seed=batch * 10 + t_len + hidden + 1,
                 exact=exact, cell="lstm")


@pytest.mark.parametrize("forward", [False, True])
def test_lstm_pair_core_model_matches_the_jax_kernels(forward):
    """The LSTM cell at the JAX kernels' shapes (H 128, B 8, T 5): the model
    on the H100's plan against ``lstm2_infer_pallas`` and
    ``lstm2_bwd_chain_padded`` over ``lstm2_train_fwd_residuals``'
    residuals, in interpret mode, matmul precision "highest"."""
    batch, t_len, d, hidden, seed = 8, 5, 12, 128, 4
    plan = lk.chain_plan(hidden, 4, batch, 132, MAX_SMEM, _measured(132), forward,
                         layers=2)
    assert (plan.upc, plan.ctas, plan.ncl, plan.rgroups) == (2, 128, 2, 2)
    got = _check_model(plan, batch, t_len, d, hidden, seed, exact=False, cell="lstm")
    l0, l1, x, keep, dh = _case("lstm", batch, t_len, d, hidden, seed)
    with jax.default_matmul_precision("highest"):
        if forward:
            want = np.asarray(lstm2_infer_pallas(jnp.asarray(x), l0, l1, chunk=8,
                                                 interpret=True))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            return
        packed, _, _, _, keep_pad, _, _ = jax_lstm_train_fwd(
            jnp.asarray(x.transpose(1, 0, 2)), jnp.asarray(keep), l0, l1, interpret=True)
        want = lstm2_bwd_chain_padded(packed, keep_pad, None, jnp.asarray(dh), l0["w_hh"],
                                      l1["w_hh"], l1["w_ih"], t_len, interpret=True)
    for name, g, w in zip(("dg0", "dg1"), got, want):
        np.testing.assert_allclose(g, np.asarray(w)[:t_len], rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("batch,t_len,hidden,sms,stub,split,exact", MODEL_CASES)
def test_pair_core_bf16_exchange_model_matches_plain(forward, cell, batch, t_len, hidden,
                                                     sms, stub, split, exact):
    """The bf16 forms' float32 exchange (rows 11b, 12b, 14b, 15b): each
    layer's own rows in two slots used in turn (the forward's h, the
    chain's layer 0), the hop a whole series; clusters stepping in any
    order the flags allow never read a slot a step too late or too early
    (NaN until written, stale values wrong), against the plain versions.
    Values stay float64 here: the bf16 rounding of the stored series is
    elementwise, and the exchange never reads it."""
    width = 4 if cell == "lstm" else 3
    active = (_measured if stub == "measured" else _every)(sms)
    plan = lk.chain_plan(hidden, width, batch, sms, MAX_SMEM, active, forward, layers=2)
    assert (plan.ncl, plan.rgroups) == split, plan
    seed = batch * 10 + t_len + hidden + 5
    if forward:
        _check_train_model(plan, batch, t_len, 5, hidden, seed, exact, cell,
                           store_gates=True, ring=True)
    else:
        _check_model(plan, batch, t_len, 5, hidden, seed, exact, cell=cell, ring=True)


@pytest.mark.parametrize("cell,store_gates", TRAIN_FORMS)
@pytest.mark.parametrize("batch,t_len,hidden,sms,stub,split,exact", MODEL_CASES)
def test_pair_core_train_model_matches_plain(cell, store_gates, batch, t_len, hidden,
                                             sms, stub, split, exact):
    """The forward core's training form (rows 11, 11n and 14): time-major
    ih0, the feed x1 = h0 keep with keep zeros in it, the whole h0p / h1p /
    x1 series as the exchange (NaN until written), the packed rows and the
    finals of each cell, against ``lstm2_train_fwd_reference`` /
    ``gru2_train_fwd_reference`` on the eval form's plans."""
    width = 4 if cell == "lstm" else 3
    active = (_measured if stub == "measured" else _every)(sms)
    plan = lk.chain_plan(hidden, width, batch, sms, MAX_SMEM, active, True, layers=2)
    assert (plan.ncl, plan.rgroups) == split, plan
    _check_train_model(plan, batch, t_len, 5, hidden,
                       seed=batch * 10 + t_len + hidden + 2 + store_gates, exact=exact,
                       cell=cell, store_gates=store_gates)


@pytest.mark.parametrize("cell,store_gates", TRAIN_FORMS)
def test_pair_core_train_model_matches_the_jax_kernels(cell, store_gates):
    """The training form at the JAX kernels' shapes (H 128, B 8, T 5): the
    model on the H100's plan against ``lstm2_train_fwd_residuals`` (both
    forms) and ``gru2_train_fwd_residuals`` in interpret mode, matmul
    precision "highest", over the first T rows of their padded series."""
    batch, t_len, d, hidden, seed = 8, 5, 12, 128, 5
    width = 4 if cell == "lstm" else 3
    plan = lk.chain_plan(hidden, width, batch, 132, MAX_SMEM, _measured(132), True,
                         layers=2)
    assert (plan.upc, plan.ctas, plan.ncl, plan.rgroups) == (2, 128, 2, 2)
    got, (l0, l1, x_tm, keep) = _check_train_model(
        plan, batch, t_len, d, hidden, seed, exact=False, cell=cell,
        store_gates=store_gates)
    with jax.default_matmul_precision("highest"):
        if cell == "lstm":
            want = jax_lstm_train_fwd(jnp.asarray(x_tm), jnp.asarray(keep), l0, l1,
                                      interpret=True, store_gates=store_gates)
        else:
            want = jax_train_fwd(jnp.asarray(x_tm), jnp.asarray(keep), l0, l1,
                                 interpret=True)
    packed, h0p, h1p, x1, _, finals, _ = want
    for name, g, w in zip(TRAIN_NAMES, got, (packed, h0p, h1p, x1, finals)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w if name == "finals" else w[:t_len], rtol=0,
                                   atol=1e-5, err_msg=name)


# the remat cases: MODEL_CASES' plans, T past a gate block (not a multiple
# of it) and T 1-3, the block's steps rk the plan's or fewer
REMAT_CASES = [
    (3, 13, 16, 132, "every", (8, 2), False, 4),     # 4 blocks, the last of one step
    (17, 2, 8, 132, "measured", (8, 1), False, 8),   # 3 passes; fewer pieces than steps
    (17, 9, 64, 132, "measured", (2, 4), False, 8),  # block 1 of one step
    (5, 7, 12, 132, "every", (4, 1), False, 2),      # clusters of 4, 4 blocks
    (2, 3, 20, 10, "every", (1, 1), False, 8),       # an odd grid, T 3
    (1, 10, 16, 132, "measured", (8, 2), False, 3),  # an empty row group, blocks of 3
    (9, 1, 16, 132, "every", (8, 2), False, 8),      # one step
    (3, 6, 16, 132, "every", (8, 2), True, 2),       # the threads' tiles and shuffles
    (10, 5, 12, 6, "every", (1, 1), True, 4),        # the threads, both pieces in a CTA
]


@pytest.mark.parametrize("batch,t_len,hidden,sms,stub,split,exact,rk", REMAT_CASES)
def test_pair_core_remat_model_matches_plain(batch, t_len, hidden, sms, stub, split, exact,
                                             rk):
    """The reverse core with the remat cell (row 13): gates formed per CTA
    in blocks of rk steps by the kernel's schedule (NaN until formed, rows
    it does not stage NaN), c_prev from the (T, B, 2H) residuals, D = 5
    padded to 8, against ``lstm2_bwd_chain_remat_reference``."""
    active = (_measured if stub == "measured" else _every)(sms)
    plan = lk.chain_plan(hidden, 4, batch, sms, MAX_SMEM, active, layers=2, remat_d=8)
    assert (plan.ncl, plan.rgroups, plan.rk) == (*split, 8), plan
    plan = dataclasses.replace(plan, rk=rk)
    _check_remat_model(plan, batch, t_len, 5, hidden,
                       seed=batch * 10 + t_len + hidden + 7, exact=exact)


@pytest.mark.parametrize("with_dys", [False, True], ids=["no_dys", "dys"])
@pytest.mark.parametrize("batch,t_len,hidden,sms,stub,split,exact", MODEL_CASES)
def test_pair_core_legacy_gru_model_matches_plain(batch, t_len, hidden, sms, stub, split,
                                                  exact, with_dys):
    """The reverse core with the legacy GRU cell (row 10): the [h_prev | r |
    z | n | hn] rows, 12H rows written with the full dhh and its lanes
    exchanged, dys into layer 1's dh, on row 15's plans, against
    ``gru2_bwd_chain_legacy_reference``."""
    active = (_measured if stub == "measured" else _every)(sms)
    plan = lk.chain_plan(hidden, 3, batch, sms, MAX_SMEM, active, layers=2)
    assert (plan.ncl, plan.rgroups) == split, plan
    _check_legacy_model(plan, batch, t_len, 5, hidden,
                        seed=batch * 10 + t_len + hidden + 8 + with_dys, exact=exact,
                        with_dys=with_dys)


@pytest.mark.parametrize("batch,t_len,hidden,sms,stub,split,exact", MODEL_CASES)
def test_pair_core_legacy_lstm_fwd_model_matches_plain(batch, t_len, hidden, sms, stub,
                                                       split, exact):
    """The forward core's training form with the legacy LSTM cell (row 5):
    the legacy 12H rows stored with the states after each step, the h0p /
    h1p / x1 exchange (row 0 of h0p / h1p never written), h_final from layer
    1 alone, on row 11's plans, against
    ``lstm2_train_fwd_legacy_reference``."""
    active = (_measured if stub == "measured" else _every)(sms)
    plan = lk.chain_plan(hidden, 4, batch, sms, MAX_SMEM, active, True, layers=2)
    assert (plan.ncl, plan.rgroups) == split, plan
    _check_legacy_lstm_fwd_model(plan, batch, t_len, 5, hidden,
                                 seed=batch * 10 + t_len + hidden + 9, exact=exact)


@pytest.mark.parametrize("batch,t_len,hidden,sms,stub,split,exact", MODEL_CASES)
def test_pair_core_legacy_gru_fwd_model_matches_plain(batch, t_len, hidden, sms, stub,
                                                      split, exact):
    """The forward core's training form with the legacy GRU cell (row 8):
    the legacy 10H rows stored with the states after each step, the h0p /
    h1p / x1 exchange (row 0 of h0p / h1p never written), h_final from layer
    1 alone, on row 14's plans, cut by the wrapper's lane split, against
    ``gru2_train_fwd_legacy_reference``."""
    active = (_measured if stub == "measured" else _every)(sms)
    plan = lk.chain_plan(hidden, 3, batch, sms, MAX_SMEM, active, True, layers=2)
    assert (plan.ncl, plan.rgroups) == split, plan
    _check_legacy_gru_fwd_model(plan, batch, t_len, 5, hidden,
                                seed=batch * 10 + t_len + hidden + 11, exact=exact)


@pytest.mark.parametrize("with_dys", [False, True], ids=["no_dys", "dys"])
@pytest.mark.parametrize("batch,t_len,hidden,sms,stub,split,exact", MODEL_CASES)
def test_pair_core_legacy_lstm_model_matches_plain(batch, t_len, hidden, sms, stub, split,
                                                   exact, with_dys):
    """The reverse core with the legacy LSTM cell (row 9): the legacy series
    packed into row 12's 10H rows, the 8H rows [dg0 | dg1] written and their
    lanes exchanged, dys into layer 1's dh, on row 12's plans, against
    ``lstm2_bwd_chain_legacy_reference``."""
    active = (_measured if stub == "measured" else _every)(sms)
    plan = lk.chain_plan(hidden, 4, batch, sms, MAX_SMEM, active, layers=2)
    assert (plan.ncl, plan.rgroups) == split, plan
    _check_legacy_lstm_model(plan, batch, t_len, 5, hidden,
                             seed=batch * 10 + t_len + hidden + 10 + with_dys, exact=exact,
                             with_dys=with_dys)


# the JAX legacy kernels' own test shape (tests/test_torch_port_legacy.py)
LEGACY_JAX_SHAPE = dict(batch=8, t_len=21, d=12, hidden=128)


def test_legacy_lstm_fwd_core_model_matches_the_jax_kernel():
    """The legacy LSTM forward cell at the JAX legacy kernel's test shape (B
    8, T 21, D 12, H 128) on the H100's plan against
    ``lstm2_train_fwd_pallas`` in interpret mode, matmul precision
    "highest" (1e-5 of the largest)."""
    plan = lk.chain_plan(128, 4, 8, 132, MAX_SMEM, _measured(132), True, layers=2)
    assert (plan.upc, plan.ctas, plan.ncl, plan.rgroups) == (2, 128, 2, 2)
    got, (l0, l1, x_tm, keep) = _check_legacy_lstm_fwd_model(
        plan, seed=11, exact=False, **LEGACY_JAX_SHAPE)
    with jax.default_matmul_precision("highest"):
        want = lstm2_train_fwd_pallas(jnp.asarray(x_tm), jnp.asarray(keep), l0, l1,
                                      interpret=True)
    for name, g, w in zip(LEGACY_LSTM_NAMES, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def test_legacy_gru_fwd_core_model_matches_the_jax_kernel():
    """The legacy GRU forward cell at the JAX legacy kernels' test shape (B
    8, T 21, D 12, H 128) on the H100's plan (row 14's) against
    ``gru2_train_fwd_pallas`` in interpret mode, matmul precision "highest"
    (1e-5 of the largest)."""
    plan = lk.chain_plan(128, 3, 8, 132, MAX_SMEM, _measured(132), True, layers=2)
    assert (plan.upc, plan.ctas, plan.ncl, plan.rgroups) == (2, 128, 2, 2)
    got, (l0, l1, x_tm, keep) = _check_legacy_gru_fwd_model(
        plan, seed=13, exact=False, **LEGACY_JAX_SHAPE)
    with jax.default_matmul_precision("highest"):
        want = _flat_legacy_gru(gru2_train_fwd_pallas(jnp.asarray(x_tm), jnp.asarray(keep),
                                                      l0, l1, interpret=True))
    for name, g, w in zip(LEGACY_GRU_NAMES, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("with_dys", [False, True], ids=["no_dys", "dys"])
def test_legacy_lstm_core_model_matches_the_jax_kernel(with_dys):
    """The legacy LSTM chain cell at the JAX legacy kernel's test shape (B
    8, T 21, D 12, H 128) on the H100's plan against
    ``lstm2_bwd_chain_pallas`` in interpret mode over the same series,
    with and without dys, matmul precision "highest" (1e-5 of the
    largest)."""
    plan = lk.chain_plan(128, 4, 8, 132, MAX_SMEM, _measured(132), layers=2)
    assert (plan.upc, plan.ctas, plan.ncl, plan.rgroups) == (2, 128, 2, 2)
    got, args = _check_legacy_lstm_model(plan, seed=12, exact=False, with_dys=with_dys,
                                         **LEGACY_JAX_SHAPE)
    with jax.default_matmul_precision("highest"):
        want = lstm2_bwd_chain_pallas(*(None if a is None else jnp.asarray(a) for a in args),
                                      interpret=True)
    for name, g, w in zip(("dg0", "dg1"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def test_remat_core_model_matches_the_jax_kernel():
    """The remat cell at the JAX remat kernel's test shape (B 8, T 21, D
    12, H 128: three gate blocks of 8, the last of 5) on the H100's plan
    against ``lstm2_bwd_chain_remat`` in interpret mode over its own
    no-gates forward, matmul precision "highest" (1e-5 of the largest)."""
    batch, t_len, d, hidden, seed = 8, 21, 12, 128, 6
    plan = lk.chain_plan(hidden, 4, batch, 132, MAX_SMEM, _measured(132), layers=2,
                         remat_d=d)
    assert (plan.upc, plan.ctas, plan.ncl, plan.rgroups, plan.rk) == (2, 128, 2, 2, 8)
    got, (l0, l1, x_tm, keep, dh, *_) = _check_remat_model(
        plan, batch, t_len, d, hidden, seed, exact=False)
    with jax.default_matmul_precision("highest"):
        packed, h0p, h1p, x1, keep_pad, _, t_pad = jax_lstm_train_fwd(
            jnp.asarray(x_tm), jnp.asarray(keep), l0, l1, interpret=True, store_gates=False)
        x_pad = jnp.pad(jnp.asarray(x_tm), ((0, t_pad - t_len), (0, 0), (0, 0)))
        want = jax_bwd_chain_remat(packed, keep_pad, x_pad, x1, h0p, h1p, None,
                                   jnp.asarray(dh), l0, l1, t_len, interpret=True)
    for name, g, w in zip(("dg0", "dg1"), got, want):
        w = np.asarray(w)[:t_len]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("with_dys", [False, True], ids=["no_dys", "dys"])
def test_legacy_gru_core_model_matches_the_jax_kernel(with_dys):
    """The legacy GRU cell at the JAX kernels' shapes (H 128, B 8, T 5) on
    the H100's plan against ``gru2_bwd_chain_pallas`` in interpret mode
    (dys zeros where none), matmul precision "highest" (1e-5)."""
    batch, t_len, d, hidden, seed = 8, 5, 12, 128, 7
    plan = lk.chain_plan(hidden, 3, batch, 132, MAX_SMEM, _measured(132), layers=2)
    got, (l0, l1, keep, dh, res0, res1, dys) = _check_legacy_model(
        plan, batch, t_len, d, hidden, seed, exact=False, with_dys=with_dys)
    jdys = np.zeros((t_len, batch, hidden), np.float32) if dys is None else dys
    with jax.default_matmul_precision("highest"):
        want = gru2_bwd_chain_pallas(
            tuple(map(jnp.asarray, res0)), tuple(map(jnp.asarray, res1)),
            jnp.asarray(jdys), jnp.asarray(keep), jnp.asarray(dh), l0["w_hh"],
            l1["w_hh"], l1["w_ih"], interpret=True)
    for i in range(2):
        for j, name in enumerate(("dih", "dhh")):
            np.testing.assert_allclose(got[i][j], np.asarray(want[i][j]), rtol=0, atol=1e-5,
                                       err_msg=f"{name}{i}")


def test_remat_plan_at_the_flagship_shape():
    """The remat chain at the flagship (B=32, D=64, H=256) on an H100 of 132
    SMs and 232,448 bytes: row 12's plan (UPC 4, 64 + 64 CTAs in clusters
    of 2, 4 row groups, the whole share in one chunk) with gate blocks of 8
    steps: 224,912 bytes, the follow set's (170,624 + layer 0's blocks
    54,288) above the lead set's (its weights over its own half, 105,088,
    + layer 1's 66,576).  A block of 16 steps does not fit; the first of
    REMAT_KS that fits is taken; a batch whose blocks do not fit beside
    that plan is taken in slices."""
    active = _measured(132)
    plan = lk.chain_plan(256, 4, 32, 132, MAX_SMEM, active, layers=2, remat_d=64)
    stored = lk.chain_plan(256, 4, 32, 132, MAX_SMEM, active, layers=2)
    assert (plan.upc, plan.ctas, plan.ncl, plan.rgroups, plan.kc) == (
        stored.upc, stored.ctas, stored.ncl, stored.rgroups, stored.kc) == (4, 128, 2, 4, 256)
    assert plan.rk == 8 and plan.smem == 224_912 <= MAX_SMEM
    assert 4 * lk.remat_gate_floats(256, 4, 4, 32, 64, 8) == 54_288
    assert 4 * lk.remat_gate_floats(256, 4, 4, 32, 256, 8) == 66_576
    assert 4 * lk.chain_smem_floats(4, 256, 4, 2, 4, 256, layers=2,
                                    remat=(32, 64, 8)) == 224_912
    assert 4 * lk.chain_smem_floats(4, 256, 4, 2, 4, 256, layers=2,
                                    remat=(32, 64, 16)) > MAX_SMEM
    # below the blocks of 8, the plan takes 4
    small = lk.chain_plan(256, 4, 32, 132, 224_000, active, layers=2, remat_d=64)
    assert small.rk == 4 and small.smem <= 224_000
    # 33 rows: row 12's plan holds blocks for one pass a group, so two
    # launches of 17 rows
    two = lk.chain_plan(256, 4, 33, 132, MAX_SMEM, active, layers=2, remat_d=64)
    assert (two.kc, two.rk, two.batch_slice) == (256, 8, 17) and two.smem <= MAX_SMEM
    # a batch whose blocks no plan holds is taken in slices (the fewest
    # equal ones that fit), one launch each
    for batch in (128, 512, 2048):
        sliced = lk.chain_plan(256, 4, batch, 132, MAX_SMEM, active, layers=2, remat_d=64)
        assert sliced.batch_slice == 32 and sliced.smem <= MAX_SMEM, sliced
    for kw in (dict(remat_d=6), dict(remat_d=64, forward=True)):
        with pytest.raises(ValueError):
            lk.chain_plan(256, 4, 32, 132, MAX_SMEM, active, layers=2, **kw)
    with pytest.raises(ValueError):
        lk.chain_plan(256, 3, 32, 132, MAX_SMEM, active, layers=2, remat_d=64)


@pytest.mark.parametrize("batch", [32, 33, 64, 100, 128, 512, 2048])
def test_remat_plan_slices_a_batch_its_blocks_outgrow(batch):
    """The remat chain keeps the stored-gates chain's plan and its gate
    blocks grow with a row group's rows: at the flagship's (D=64, H=256)
    on an H100 that plan (4 row groups, the whole share in one chunk)
    holds blocks of 8 steps for up to 32 rows, one pass a group; past that
    the plan takes the fewest equal slices that fit, each on its rows'
    stored-gates plan (the last, of fewer rows, fits it too), and one slice
    fewer would not fit."""
    active = _measured(132)

    def plan_of(rows, remat_d=64):
        return lk.chain_plan(256, 4, rows, 132, MAX_SMEM, active, layers=2,
                             remat_d=remat_d)

    plan = plan_of(batch)
    rows = plan.batch_slice or batch
    stored = plan_of(rows, 0)
    assert (plan.upc, plan.ncl, plan.rgroups, plan.kc) == (
        stored.upc, stored.ncl, stored.rgroups, stored.kc)
    assert plan.rk == 8 and plan.smem <= MAX_SMEM
    if batch <= 32:
        assert plan.batch_slice == 0
        return
    n = -(-batch // rows)
    assert 0 < rows <= 32 and rows == -(-batch // n)
    assert dataclasses.replace(plan_of(rows), batch_slice=rows) == plan
    assert plan_of(-(-batch // (n - 1))).batch_slice > 0
    for last in (rows, batch - (n - 1) * rows):
        need = 4 * lk.chain_smem_floats(4, 256, plan.upc, plan.ncl, plan.rgroups, plan.kc,
                                        layers=2, remat=(last, 64, plan.rk))
        assert need <= plan.smem


# batch, T, H, SMs, shared memory a CTA, the slices, threads' tiles: cards
# too small for the whole batch's gate blocks
# (the first three hold no blocks beside the stored-gates plan even for
# one row, so they take any plan whose blocks fit)
REMAT_SLICE_CASES = [
    (17, 5, 16, 132, 8_000, 9, False),   # two slices, the last of 8 rows
    (24, 3, 16, 132, 8_000, 12, True),   # two equal slices, the threads' tiles
    (13, 9, 12, 6, 10_000, 7, False),    # one cluster a set, blocks past T
    (40, 4, 32, 132, 16_000, 14, False),  # the stored-gates plan of 14 rows
]


@pytest.mark.parametrize("batch,t_len,hidden,sms,smem,rows,exact", REMAT_SLICE_CASES)
def test_pair_core_remat_model_over_batch_slices(batch, t_len, hidden, sms, smem, rows,
                                                 exact):
    """The remat cell where the plan slices the batch: the model of each
    slice's launch, over its rows, against the plain version of the whole
    batch."""
    plan = lk.chain_plan(hidden, 4, batch, sms, smem, _every(sms), layers=2, remat_d=8)
    assert plan.batch_slice == rows, plan
    _check_remat_model(plan, batch, t_len, 5, hidden, seed=batch + t_len + hidden,
                       exact=exact)
