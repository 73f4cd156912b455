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
CPU only: nothing here launches a kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.ops.lstm_kernel import (
    gru2_bwd_chain_res_padded,
    gru2_infer_pallas,
    gru2_train_fwd_residuals as jax_train_fwd,
    lstm2_bwd_chain_padded,
    lstm2_infer_pallas,
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
    1 or 2 units of both layers a CTA), any B."""
    active = _measured(132)
    for hidden in range(4, 265, 4):
        for batch in (1, 33):
            plan = lk.chain_plan(hidden, 3, batch, 132, MAX_SMEM, active, forward,
                                 layers=2)
            assert plan.ctas <= 132 and plan.grid * plan.upc == hidden


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
    """The flagship's LSTM 2x256 at B=32 on the H100: 4 units a CTA, 64 + 64
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


def _model_bwd(plan, cell, packed, prev, keep, dh, w_hh0, w_hh1, w_ih1, seed, exact):
    """``pair_kernel`` of csrc/rnn2_bwd_chain.cuh with ``cell`` "gru" or
    "lstm": the lead set layer 1's chain over its own row, the follow set
    layer 0's over [own | layer 1's dih or dg].  ``prev``: the GRU's
    (h0_prev, h1_prev); the LSTM's c_prev is inside ``packed``."""
    t_len, batch, hidden = keep.shape
    lstm = cell == "lstm"
    nan = np.full
    # GRU dih (3H) and dhn; LSTM dg (4H)
    out = [nan((t_len, batch, plan.width * hidden), np.nan) for _ in range(2)]
    dhn = [nan((t_len, batch, hidden), np.nan) for _ in range(2)]
    # GRU: the direct part dh z, layer 1's starting as dh_final; LSTM: dc
    carry = [np.zeros((batch, hidden)),
             np.zeros((batch, hidden)) if lstm else dh.astype(np.float64)]
    w_own = (w_hh0, w_hh1)

    def x_row(layer, step, rows):
        if lstm:
            return out[layer][step][rows]
        return np.concatenate([out[layer][step][rows, :2 * hidden],
                               dhn[layer][step][rows]], axis=1)

    def gru_cell(layer, t, rows, j, d):
        r, z, n, hn = (packed[t][rows, 4 * hidden * layer + i * hidden + j]
                       for i in range(4))
        hp = prev[layer][t][rows, j]
        d = carry[layer][rows, j] + d
        dn = d * (1 - z) * (1 - n * n)
        out[layer][t][rows, j] = dn * hn * r * (1 - r)
        out[layer][t][rows, hidden + j] = d * (hp - n) * z * (1 - z)
        out[layer][t][rows, 2 * hidden + j] = dn
        dhn[layer][t][rows, j] = dn * r
        carry[layer][rows, j] = d * z

    def lstm_cell(layer, t, rows, j, d):
        gi, gf, gg, go = (packed[t][rows, 4 * hidden * layer + i * hidden + j]
                          for i in range(4))
        cp = packed[t][rows, 8 * hidden + hidden * layer + j]
        if layer == 1 and t == t_len - 1:
            d = d + dh[rows, j]
        si, sf, so, tg = _sig(gi), _sig(gf), _sig(go), np.tanh(gg)
        tc = np.tanh(sf * cp + si * tg)
        dcs = carry[layer][rows, j] + d * so * (1 - tc * tc)
        out[layer][t][rows, j] = dcs * tg * si * (1 - si)
        out[layer][t][rows, hidden + j] = dcs * cp * sf * (1 - sf)
        out[layer][t][rows, 2 * hidden + j] = dcs * si * (1 - tg * tg)
        out[layer][t][rows, 3 * hidden + j] = d * tc * so * (1 - so)
        carry[layer][rows, j] = dcs * sf

    def cluster_step(follow, c0, s):
        layer, t = (0 if follow else 1), t_len - 1 - s
        units = plan.cluster_units(c0)
        grows = plan.rows(c0, batch)

        def source(seg, rows):
            return x_row(layer, t + 1, rows) if seg == 0 else out[1][t][rows]

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
                    (lstm_cell if lstm else gru_cell)(layer, t, rows, j, own + kv * feed)

    _schedule(plan, t_len, np.random.RandomState(seed), cluster_step)
    return (out[0], out[1]) if lstm else (out[0], dhn[0], out[1], dhn[1])


def _model_fwd(plan, cell, ih0, l0, l1, seed, exact, keep=None, store_gates=True):
    """``pair_kernel`` of csrc/rnn2_fwd_chain.cuh with ``cell`` "gru" or
    "lstm": the lead set layer 0 over its own h, the follow set layer 1
    over [own h | feed]; the carry h (GRU) or c (LSTM).

    The eval form (``keep`` None): ih0 (B, T, W H), the feed h0, the lead
    set storing the h0 series, the follow set its h in two slots -> the
    final h1.  The training form: ih0 (T, B, W H), ``keep`` (T, B, H), the
    feed x1 = h0 keep, both sets reading and storing the whole h0p / h1p /
    x1 series and storing the packed rows (the LSTM's without the gates
    unless ``store_gates``) and the finals -> ``(packed, h0p, h1p, x1,
    finals)``.  Every buffer starts NaN, so a read before its write shows."""
    train = keep is not None
    t_len, batch = (ih0.shape[0], ih0.shape[1]) if train else (ih0.shape[1], ih0.shape[0])
    hidden, width = l0["w_hh"].shape[0], plan.width
    lstm = cell == "lstm"
    nan = np.full
    if train:
        pw = (10 if store_gates else 2) * hidden if lstm else 8 * hidden
        packed = nan((t_len, batch, pw), np.nan)
        hp = [nan((t_len, batch, hidden), np.nan) for _ in range(2)]
        x1 = nan((t_len, batch, hidden), np.nan)
        finals = nan((4 if lstm else 2, batch, hidden), np.nan)
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
        return h, h, {4 * layer + i: v for i, v in enumerate((r, z, n, hn))}

    def lstm_cell(layer, x, gate, own, fed, cp):
        g = [x[q] + fed[q] + own[q] for q in range(4)]
        c = _sig(g[1]) * cp + _sig(g[0]) * np.tanh(g[2])
        lanes = {4 * layer + q: g[q] for q in range(4)}
        lanes[8 + layer] = cp
        return _sig(g[3]) * np.tanh(c), c, lanes if store_gates else {layer: cp}

    def cluster_step(follow, c0, t):
        layer = 1 if follow else 0
        units = plan.cluster_units(c0)
        grows = plan.rows(c0, batch)
        cols = [q * hidden + u for u in units for q in range(width)]

        def source(seg, rows):
            if train:
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
                    if t == 0:
                        hp[layer][0][rows, j] = 0.0
                    if t + 1 < t_len:
                        hp[layer][t + 1][rows, j] = h
                    else:
                        fh = 2 * layer if lstm else layer
                        finals[fh][rows, j] = h
                        if lstm:
                            finals[fh + 1][rows, j] = carry[layer][rows, j]

    _schedule(plan, t_len, np.random.RandomState(seed), cluster_step)
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


def _check_model(plan, batch, t_len, d, hidden, seed, exact, cell="gru"):
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
    got = _model_bwd(plan, cell, packed, (h0p, h1p), keep, dh, *w, seed, exact)
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


TRAIN_NAMES = ("packed", "h0_prev", "h1_prev", "x1", "finals")
# the training forms: the cell and, for the LSTM, whether it stores the gates
TRAIN_FORMS = [("lstm", True), ("lstm", False), ("gru", True)]


def _check_train_model(plan, batch, t_len, d, hidden, seed, exact, cell, store_gates):
    """The training form of the forward core's model against
    ``lstm2_train_fwd_reference`` (``store_gates`` either way) or
    ``gru2_train_fwd_reference`` (1e-6); keep has zeros (p = 0.1)."""
    l0, l1, x, keep, _ = _case(cell, batch, t_len, d, hidden, seed)
    lstm = cell == "lstm"
    x_tm = x.transpose(1, 0, 2)
    ih0 = x_tm.astype(np.float64) @ l0["w_ih"] + l0["b" if lstm else "b_ih"]
    got = _model_fwd(plan, cell, ih0, l0, l1, seed, exact, keep=keep,
                     store_gates=store_gates)
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
