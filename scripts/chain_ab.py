"""Time the PyTorch port's recurrent kernels of two trees on one card.

    python3 scripts/chain_ab.py --parent DIR [--steps] [--timers] [--timers-parent TDIR]
                                [--rows REGEX]
    python3 scripts/chain_ab.py --probe | --sweep

Runs the timing child on DIR, on this checkout, on this checkout again and
on DIR (parent, change, change, parent), each in its own process that
imports ``multimodal_emotion_detection_tpu_torch`` from its tree and builds
that tree's kernels into its own ``build/torch_kernels/``.  Each child
prints one JSON line of median device times (CUDA events around each call,
L2 flushed before each, 20 calls after 3 warm-ups), on ``chip_smoke.py``'s
inputs:

* ``lstm_bwd_chain`` (row 4) at (B, T, H) = (32, 372, 512) with and
  without ``dh_series``, and cuDNN's backward of ``h_n`` on the same layer;
* ``gru_bwd_chain`` (row 7) there, and at (32, 372, 256), the layered
  legacy GRU backward's width, and cuDNN's backward of ``h_n``;
* rows 4 and 7 (with ``dh_series``) and the eval forms (final h) at B =
  1, 4, 16 and 24, T 372, H 512, where the plan's row groups differ from
  B=32's or their passes hold fewer rows;
* the one-layer forwards at (32, 372, 512), with cuDNN's same function
  beside each: ``lstm1_train_fwd`` (row 6) and ``gru1_train_fwd`` (row
  7f), their eval forms ``lstm1_infer`` (6e) and ``gru1_infer`` (7e) with
  the h series out and with the final h only (two slots), and the eval
  forms at B=1 (the b1 serving forward's shape);
* the flagship's 2-layer kernels (LSTM 2x256, ``chip_smoke.py``'s
  ``[lstm2_bwd_chain]`` / ``[lstm2_infer]`` inputs): ``lstm2_bwd_chain``
  (row 12) at (32, 372, 256) over the flagship's own residuals, beside
  cuDNN's backward of ``h_n``; ``lstm2_infer`` (row 2, the input
  projection included) at B = 32, 24, 16, 4 and 1, beside cuDNN's 2-layer
  LSTM inference forward at B 32 and 1; and the training forward
  ``lstm2_train_fwd_residuals`` with the gates (row 11) and without them
  (11n), the input projection included, keep at p = 0.1, at B = 32, 17
  and 1, beside cuDNN's 2-layer LSTM training forward (keep = 1); the
  gate-rematerialising chain ``lstm2_bwd_chain_remat`` (row 13) at (32,
  372, 256) over the no-gates forward's residuals (D = 64), and at B 128
  and 512, past the rows whose gate blocks fit one launch; and the legacy
  pair (``chip_smoke.py``'s ``[lstm2_train_fwd_legacy]`` inputs): the
  training forward ``lstm2_train_fwd_legacy`` (row 5) at B = 32, 17 and 1,
  and the chain ``lstm2_bwd_chain_legacy`` (row 9) at B 32 and 1 over the
  legacy forward's own series (the gate series views of one 12H row, as
  the route passes them), with and without ``dys``;
* the GRU config's 2-layer kernels (GRU 2x256, ``chip_smoke.py``'s
  ``[gru2_bwd_chain]`` / ``[gru2_infer]`` inputs): ``gru2_bwd_chain``
  (row 15) at (32, 372, 256) over the config's own residuals, beside the
  two-chain route over the same residuals (two ``gru_bwd_chain``
  launches and the hop, ``ops/lstm_vjp.py::gru_bwd_layered_legacy``, the
  layout's copies included) and cuDNN's backward of ``h_n``;
  ``gru2_infer`` (row 3, the input projection included) at B = 32, 24,
  16, 4 and 1, beside cuDNN's 2-layer GRU inference forward at B 32 and 1;
  ``gru2_train_fwd_residuals`` (row 14) at B = 32, 17 and 1 beside
  cuDNN's 2-layer GRU training forward (keep = 1), with the legacy-layout
  forward ``gru2_train_fwd_legacy`` (row 8) on the same inputs beside it;
  and the legacy-layout chain ``gru2_bwd_chain_legacy`` (row 10) over the
  same residuals with and without ``dys`` (its gate series views of one
  tensor, as the legacy forward's are).

``--rows REGEX`` keeps only the cases (and ``--timers`` kernels, and
``--steps`` tags) whose names match.

``--timers`` then builds rows 4, 7, 6, 7f, 12, 13, 2, 11, 15, 10, 3, 14, 5, 9
and 8 of both trees with ``-DRNN_CHAIN_TIMERS=1`` (``csrc/rnn_timers.cuh``) and
prints, for each at (32, 372, 512) (the chains with ``dh_series``; the
2-layer rows at (32, 372, 256), one block per CTA set), each
phase's share of the
warps' ``clock64()`` time and the cycles per step and warp, with the
launch plan where the tree has one.  A tree whose sources
predate the timers has no timed build: ``--timers-parent TDIR`` names a
copy of the parent with the timer marks added, used for its timed run
only.  ``--probe`` builds ``scripts/chain_probe.cu`` and prints the card's
grid-barrier costs, shared-L2 and distributed-shared-memory read rates and
resident cluster counts, and the exchange alone (write, barrier, read);
``--sweep`` times rows 4, 7, 6 and 7f of this checkout on variants of the
launch plan (chunk, cluster size, row groups; and at B 1..24 each row-group
count), rows 12, 9, 11 and 5 at B=1 on every 2-layer plan the card may
hold (UPC, cluster size, row groups), and row 13 at B 48, 64, 96, 128 and
512 on slices of the batch of 16 to 64 rows and in one launch beside the
plan's.  ``--steps`` (with ``--parent``)
adds ``[train]`` / ``[train_remat]`` / ``[train_legacy]`` (``set_res2_mode("off")``)
/ ``[train_big]`` / ``[train_big_gru]`` / ``[train_gru]`` / ``[train_gru_legacy]``
(``set_res2_mode("off")`` with ``GRU_BWD2_ENABLED`` set) / ``[train_tf]``'s b32
train-step p50 / p90 and ``[serve]`` / ``[serve_big]`` /
``[serve_big_gru]`` / ``[serve_gru]`` / ``[serve_tf]``'s b32 and b1 forward p50 / p90 with
each tree's package, parent / change / change / parent.  ``--child ROOT``, ``--timers-of
ROOT``, ``--steps-of ROOT``, ``--probe`` and ``--sweep`` alone run one
part.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
BUCKETS = ["barrier", "exchange", "products", "reduce", "cell", "cluster", "sync"]
# batches below the big configs' 32, timed for rows 4, 7 and the eval forms
SMALL_B = (1, 4, 16, 24)


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def _card():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chain_ab: torch sees no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def _smoke():
    """This checkout's chip_smoke.py, for its inputs, flush and timing."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(root: Path):
    sys.path.insert(0, str(root))
    from multimodal_emotion_detection_tpu_torch.ops import _build, lstm_kernel

    return _build, lstm_kernel


# batches at which rows 2 and 3 (the 2-layer eval forwards) are timed
GRU2_INFER_B = (32, 24, 16, 4, 1)
# and rows 11, 11n and 14 (the 2-layer training forwards)
TRAIN2_B = (32, 17, 1)
# and row 13 past the rows its gate blocks hold in one launch
REMAT_WIDE_B = (128, 512)
# the 2-layer kernels' sources: two CTA sets, T + 1 phases
PAIR_SOURCES = ("lstm2_bwd_chain", "lstm2_infer", "lstm2_train_fwd", "gru2_bwd_chain",
                "gru2_infer", "gru2_train_fwd", "lstm2_bwd_chain_remat",
                "gru2_bwd_chain_legacy", "lstm2_train_fwd_legacy", "lstm2_bwd_chain_legacy",
                "gru2_train_fwd_legacy")
# batches at which row 9 (the legacy LSTM chain) is timed
LEGACY_CHAIN_B = (32, 1)


def _keep(name: str) -> bool:
    """Whether ``--rows`` (passed to the children as CHAIN_AB_ROWS) keeps
    a case, a timed kernel or a step tag."""
    return re.search(os.environ.get("CHAIN_AB_ROWS", ""), name) is not None


def _lstm2_cases(torch, smoke, lk):
    """Rows 12, 2, 11, 11n, 13, 5 and 9 on the flagship's inputs
    (``chip_smoke.py``'s ``[lstm2_bwd_chain]``, ``[lstm2_infer]``,
    ``[lstm2_train_fwd]``, ``[lstm2_bwd_chain_remat]`` and
    ``[lstm2_train_fwd_legacy]``): name -> (run, the chain with ``dys`` or
    None, cuDNN's same function or None)."""
    import numpy as np

    cases = {}
    x_tm, keep, l0, l1 = smoke._lstm_train_inputs(3)
    t, b, _ = x_tm.shape
    h = l0["w_hh"].shape[0]
    packed = lk.lstm2_train_fwd_reference(x_tm, keep, l0, l1)[0]
    dh = torch.from_numpy(np.random.RandomState(4).randn(b, h).astype(np.float32)).cuda()
    args = (packed, keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    lib = smoke._cudnn_lstm(l0, l1)
    x = x_tm.transpose(0, 1).contiguous()
    cases["lstm2_bwd_chain_h256"] = (lambda: lk.lstm2_bwd_chain(*args), None,
                                     _lib_bwd(torch, lib, lib(x)[1][0][-1], dh))
    for rows in GRU2_INFER_B:
        xr = x[:rows].contiguous()
        cases[f"lstm2_infer_b{rows}_h256"] = (
            lambda xr=xr: lk.lstm2_infer(xr, l0, l1), None,
            _no_grad(torch, lambda xr=xr: lib(xr)) if rows in (32, 1) else None)
    for rows in TRAIN2_B:
        a = (x_tm[:, :rows].contiguous(), keep[:, :rows].contiguous(), l0, l1)
        # cuDNN's training forward saves what its backward needs
        xr = x[:rows].contiguous()
        cases[f"lstm2_train_fwd_b{rows}_h256"] = (
            lambda a=a: lk.lstm2_train_fwd_residuals(*a), None, lambda xr=xr: lib(xr))
        cases[f"lstm2_train_fwd_nogates_b{rows}_h256"] = (
            lambda a=a: lk.lstm2_train_fwd_residuals(*a, store_gates=False), None, None)
    # row 13 over the no-gates forward's residuals (chip_smoke.py's
    # [lstm2_bwd_chain_remat] inputs)
    cases["lstm2_bwd_chain_remat_h256"] = (_remat_run(torch, smoke, lk, 32), None, None)
    # and past the rows whose gate blocks fit one launch, which the change
    # takes in slices of the batch
    for rows in REMAT_WIDE_B:
        cases[f"lstm2_bwd_chain_remat_b{rows}_h256"] = (
            _remat_run(torch, smoke, lk, rows), None, None)
    # rows 5 and 9, the legacy pair; the chain over the plain legacy
    # forward's series laid out as the route passes them: the gate series
    # views of one (T, B, 12H) row, the shifted c series contiguous
    lx, lkeep, m0, m1 = smoke._lstm_train_inputs(12)
    for rows in TRAIN2_B:
        a = (lx[:, :rows].contiguous(), lkeep[:, :rows].contiguous(), m0, m1)
        cases[f"lstm2_train_fwd_legacy_b{rows}_h256"] = (
            lambda a=a: lk.lstm2_train_fwd_legacy(*a), None, None)
    ys, _, g0, g1, h0, c0, c1 = lk.lstm2_train_fwd_legacy_reference(lx, lkeep, m0, m1)
    res = torch.cat([g0, g1, h0, ys, c0, c1], dim=-1)
    rng = np.random.RandomState(13)
    ldh = torch.from_numpy(rng.randn(b, h).astype(np.float32)).cuda()
    ldys = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).cuda()
    # row 12 at B=1 beside row 9's
    pk1 = packed[:, :1].contiguous()
    args1 = (pk1, keep[:, :1].contiguous(), dh[:1].contiguous(), *args[3:])
    cases["lstm2_bwd_chain_b1_h256"] = (lambda: lk.lstm2_bwd_chain(*args1), None, None)
    for rows in LEGACY_CHAIN_B:
        r = res[:, :rows].contiguous()
        gates = (r[..., :4 * h], r[..., 4 * h:8 * h])
        cps = tuple(smoke._shifted(r[..., k * h:(k + 1) * h]) for k in (10, 11))
        tail = (lkeep[:, :rows].contiguous(), ldh[:rows].contiguous(), m0["w_hh"],
                m1["w_hh"], m1["w_ih"])
        dys = ldys[:, :rows].contiguous()
        cases[f"lstm2_bwd_chain_legacy_b{rows}_h256"] = (
            lambda a=(*gates, *cps, None, *tail): lk.lstm2_bwd_chain_legacy(*a),
            lambda a=(*gates, *cps, dys, *tail): lk.lstm2_bwd_chain_legacy(*a), None)
    return cases


def _remat_run(torch, smoke, lk, rows):
    """Row 13 at (rows, 372, 64, 256) over the no-gates forward's residuals
    (``chip_smoke.py``'s ``[lstm2_bwd_chain_remat]`` inputs at B=32)."""
    import numpy as np

    rx, rkeep, r0, r1 = smoke._lstm_train_inputs(8, b=rows)
    pk, h0p, h1p, x1, _ = lk.lstm2_train_fwd_reference(rx, rkeep, r0, r1, store_gates=False)
    h = r0["w_hh"].shape[0]
    rdh = torch.from_numpy(np.random.RandomState(9).randn(rows, h).astype(np.float32)).cuda()
    rargs = (pk, rkeep, rx, x1, h0p, h1p, rdh, r0, r1)
    return lambda: lk.lstm2_bwd_chain_remat(*rargs)


def _gru2_cases(torch, smoke, lk):
    """Rows 15, 3, 14, 8 and 10 on the GRU config's inputs
    (``chip_smoke.py``'s ``[gru2_bwd_chain]``, ``[gru2_infer]`` and
    ``[gru2_train_fwd]``): name
    -> (run, None, cuDNN's same function or None).  ``gru2_two_chains_h256`` is the yardstick
    row 15 must beat: the legacy route's backward over the same residuals
    (layer 1's ``gru_bwd_chain``, the hop as one matmul, layer 0's)."""
    import numpy as np

    from multimodal_emotion_detection_tpu_torch.ops import lstm_vjp

    cases = {}
    x_tm, keep, l0, l1 = smoke._gru_inputs(8)
    t, b, _ = x_tm.shape
    h = l0["w_hh"].shape[0]
    packed, h0p, h1p, _, _ = lk.gru2_train_fwd_reference(x_tm, keep, l0, l1)
    dh = torch.from_numpy(np.random.RandomState(9).randn(b, h).astype(np.float32)).cuda()
    w = (l0["w_hh"], l1["w_hh"], l1["w_ih"])
    args = (packed, h0p, h1p, keep, dh, *w)
    lanes = packed.split(h, dim=-1)
    res0, res1 = (h0p, *lanes[:4]), (h1p, *lanes[4:])
    lib = smoke._cudnn_gru(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()
    cases["gru2_bwd_chain_h256"] = (lambda: lk.gru2_bwd_chain(*args), None,
                                    _lib_bwd(torch, lib, lib(x_bt)[1][-1], dh))
    cases["gru2_two_chains_h256"] = (
        lambda: lstm_vjp.gru_bwd_layered_legacy(res0, res1, None, keep, dh, *w),
        None, None)
    # row 10 over the same residuals (the gate series views of one packed
    # tensor, as the legacy forward's are), with and without dys
    dys = torch.from_numpy(np.random.RandomState(10).randn(t, b, h).astype(np.float32)).cuda()
    cases["gru2_bwd_chain_legacy_h256"] = (
        lambda: lk.gru2_bwd_chain_legacy(res0, res1, None, keep, dh, *w),
        lambda: lk.gru2_bwd_chain_legacy(res0, res1, dys, keep, dh, *w), None)
    x7, _, i0, i1 = smoke._gru_inputs(7)
    x = x7.transpose(0, 1).contiguous()
    ilib = smoke._cudnn_gru(i0, i1)
    for rows in GRU2_INFER_B:
        xr = x[:rows].contiguous()
        cases[f"gru2_infer_b{rows}_h256"] = (
            lambda xr=xr: lk.gru2_infer(xr, i0, i1), None,
            _no_grad(torch, lambda xr=xr: ilib(xr)) if rows in (32, 1) else None)
    for rows in TRAIN2_B:
        a = (x_tm[:, :rows].contiguous(), keep[:, :rows].contiguous(), l0, l1)
        xr = x_bt[:rows].contiguous()
        cases[f"gru2_train_fwd_b{rows}_h256"] = (
            lambda a=a: lk.gru2_train_fwd_residuals(*a), None, lambda xr=xr: lib(xr))
        # row 8, the legacy layout's forward, on the same inputs
        cases[f"gru2_train_fwd_legacy_b{rows}_h256"] = (
            lambda a=a: lk.gru2_train_fwd_legacy(*a), None, None)
    return cases


def _cases(torch, smoke, lk):
    """Rows 4, 7 (H 512 and 256), 6, 6e, 7f and 7e with their inputs: name
    -> (run with dh_series or the forward, run without dh_series or None,
    cuDNN's backward of h_n or its same forward)."""
    import numpy as np

    cases = {}
    inputs, w_hh = smoke._big_layer_inputs(5)
    x, w_ih, bias = inputs["D=512"]
    ih = torch.matmul(x, w_ih) + bias
    g, _, c_prev, _ = lk.lstm1_train_fwd_reference(ih, w_hh)
    t, b, h = c_prev.shape
    rng = np.random.RandomState(6)
    dhf = torch.from_numpy(rng.randn(b, h).astype(np.float32)).cuda()
    dhs = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).cuda()
    lib = smoke._cudnn_lstm({"w_ih": w_ih, "w_hh": w_hh, "b": bias}, batch_first=False)
    cases["lstm_bwd_chain_h512"] = (
        lambda: lk.lstm_bwd_chain(g, c_prev, dhs, dhf, w_hh),
        lambda: lk.lstm_bwd_chain(g, c_prev, None, dhf, w_hh),
        _lib_bwd(torch, lib, lib(x)[1][0][-1], dhf))
    # below B=32 the plan may take another row-group count (``chain_plan``)
    for rows in SMALL_B:
        a = tuple(v[:, :rows].contiguous() for v in (g, c_prev, dhs)) + (
            dhf[:rows].contiguous(), w_hh)
        cases[f"lstm_bwd_chain_b{rows}_h512"] = (
            lambda a=a: lk.lstm_bwd_chain(*a), None, None)
    ih1, lx1 = ih[:, :1].contiguous(), x[:, :1].contiguous()
    cases["lstm1_train_fwd_h512"] = (lambda: lk.lstm1_train_fwd(ih, w_hh), None,
                                     lambda: lib(x))
    cases["lstm1_infer_series_h512"] = (lambda: lk.lstm1_infer(ih, w_hh, True), None,
                                        _no_grad(torch, lambda: lib(x)))
    cases["lstm1_infer_final_h512"] = (lambda: lk.lstm1_infer(ih, w_hh, False), None, None)
    cases["lstm1_infer_b1_h512"] = (lambda: lk.lstm1_infer(ih1, w_hh, False), None,
                                    _no_grad(torch, lambda: lib(lx1)))
    for rows in SMALL_B[1:]:
        a = ih[:, :rows].contiguous()
        cases[f"lstm1_infer_b{rows}_h512"] = (
            lambda a=a: lk.lstm1_infer(a, w_hh, False), None, None)

    for h_dim, seed in ((512, 11), (256, 21)):
        rng = np.random.RandomState(seed)
        k = 1.0 / np.sqrt(h_dim)

        def u(*shape, lim=k):
            return torch.from_numpy(rng.uniform(-lim, lim, shape).astype(np.float32)).cuda()

        if h_dim == 512:
            gin, gw_hh = smoke._big_layer_inputs(11, gates=3)
            gx, gw_ih, gb_ih = gin["D=512"]
            gb_hh = torch.from_numpy(np.random.RandomState(12).uniform(
                -k, k, 3 * h_dim).astype(np.float32)).cuda()
        else:
            gx = u(t, b, h_dim, lim=1.0)
            gw_ih, gw_hh, gb_ih, gb_hh = (u(h_dim, 3 * h_dim), u(h_dim, 3 * h_dim),
                                         u(3 * h_dim), u(3 * h_dim))
        gates, h_prev, _ = lk.gru1_train_fwd_reference(
            torch.matmul(gx, gw_ih) + gb_ih, gw_hh, gb_hh)
        rng = np.random.RandomState(seed + 2)
        gdhf = torch.from_numpy(rng.randn(b, h_dim).astype(np.float32)).cuda()
        gdhs = torch.from_numpy(rng.randn(t, b, h_dim).astype(np.float32)).cuda()
        glib = smoke._cudnn_gru({"w_ih": gw_ih, "w_hh": gw_hh, "b_ih": gb_ih,
                                 "b_hh": gb_hh}, batch_first=False)
        cases[f"gru_bwd_chain_h{h_dim}"] = (
            (lambda a=(gates, h_prev, gdhs, gdhf, gw_hh): lk.gru_bwd_chain(*a)),
            (lambda a=(gates, h_prev, None, gdhf, gw_hh): lk.gru_bwd_chain(*a)),
            _lib_bwd(torch, glib, glib(gx)[1][-1], gdhf))
        if h_dim == 512:
            for rows in SMALL_B:
                a = tuple(v[:, :rows].contiguous() for v in (gates, h_prev, gdhs)) + (
                    gdhf[:rows].contiguous(), gw_hh)
                cases[f"gru_bwd_chain_b{rows}_h512"] = (
                    lambda a=a: lk.gru_bwd_chain(*a), None, None)
            # bound now: the next pass of the loop rebinds the names
            a = (torch.matmul(gx, gw_ih) + gb_ih, gw_hh, gb_hh)
            a1 = (a[0][:, :1].contiguous(), gw_hh, gb_hh)
            x1, glib512 = gx[:, :1].contiguous(), glib
            cases["gru1_train_fwd_h512"] = (
                lambda a=a: lk.gru1_train_fwd(*a), None, lambda x=gx: glib512(x))
            cases["gru1_infer_series_h512"] = (
                lambda a=a: lk.gru1_infer(*a, True), None,
                _no_grad(torch, lambda x=gx: glib512(x)))
            cases["gru1_infer_final_h512"] = (
                lambda a=a: lk.gru1_infer(*a, False), None, None)
            cases["gru1_infer_b1_h512"] = (
                lambda a=a1: lk.gru1_infer(*a, False), None,
                _no_grad(torch, lambda x=x1: glib512(x)))
            for rows in SMALL_B[1:]:
                ar = (a[0][:, :rows].contiguous(), gw_hh, gb_hh)
                cases[f"gru1_infer_b{rows}_h512"] = (
                    lambda a=ar: lk.gru1_infer(*a, False), None, None)
    return cases


def _no_grad(torch, fn):
    def run():
        with torch.no_grad():
            fn()
    return run


def _lib_bwd(torch, lib, h_n, dh):
    params = list(lib.parameters())
    return lambda: torch.autograd.grad(h_n, params, dh, retain_graph=True)


def child(root: Path) -> dict:
    torch = _card()
    smoke = _smoke()
    _, lk = _port(root)
    flush = smoke.L2Flush()
    res = {"root": str(root), "card": _smi()}
    cases = {**_cases(torch, smoke, lk), **_lstm2_cases(torch, smoke, lk),
             **_gru2_cases(torch, smoke, lk)}
    for name, (with_series, without, lib) in cases.items():
        if not _keep(name):
            continue
        res[f"{name}_ms"] = smoke.device_ms(with_series, flush)
        if without is not None:
            res[f"{name}_top_ms"] = smoke.device_ms(without, flush)
        if lib is not None:
            res[f"{name}_cudnn_ms"] = smoke.device_ms(lib, flush)
    return res


def _forward_latency(torch, smoke, cfg, overrides, root, raw, video, res, tag):
    """``[serve_*]``'s b32 and b1 forward (raw waveform in, log-mel on the
    card; seeded weights): p50 / p90 of the host clock around synchronize."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )
    from multimodal_emotion_detection_tpu_torch.training.steps import forward

    cfg = load_config(str(root / "configs" / "base.yaml"),
                      [*overrides, "model.frontend.cache=false"])
    model = init_weights(classifier_from_config(cfg),
                         torch.Generator().manual_seed(0)).to(raw.device).eval()
    b32 = {"audio": raw[:32], "video": video[:32]}
    b1 = {k: v[:1].contiguous() for k, v in b32.items()}
    for label, batch in (("b32", b32), ("b1", b1)):
        res[f"{tag}_{label}_p50_ms"], res[f"{tag}_{label}_p90_ms"] = smoke.host_ms(
            lambda: forward(model, batch))


def steps_of(root: Path) -> dict:
    """``[train]`` / ``[train_big]`` / ``[train_big_gru]`` / ``[train_gru]`` /
    ``[train_tf]``'s (and the legacy and remat forms')
    train-step latency with ``root``'s package: b32 p50 and p90 of 60 steps
    (host clock around ``synchronize``), ``chip_smoke.py``'s configuration
    and measurement on synthetic 32-clip splits (log-mel cached where the
    configuration caches it; the flagship runs it inside every step); and
    the matching ``[serve*]`` b32 and b1 forward."""
    torch = _card()
    smoke = _smoke()
    _build, _ = _port(root)
    import numpy as np

    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.data.loader import create_dataloaders
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
        logmel_params_from_config,
    )
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise
    from multimodal_emotion_detection_tpu_torch.ops import logmel
    from multimodal_emotion_detection_tpu_torch.training.optim import build_optimizer
    from multimodal_emotion_detection_tpu_torch.training.steps import train_step

    from multimodal_emotion_detection_tpu_torch.ops import lstm_vjp

    # every kernel source of the tree (an older tree lacks the newer ones)
    _build.build(sorted(src.stem for src in _build.CSRC.glob("*.cu")))
    data = root / "build" / "chain_ab" / "data"
    for seed, split in enumerate(("train", "val", "test")):
        if not (data / split / "labels.npy").exists():
            smoke._write_split(data, split, 32, 10 + seed)
    dev = torch.device("cuda")
    res = {"root": str(root), "card": _smi()}
    for tag, overrides in (("train", ["model.frontend.audio=logmel"]),
                           ("train_remat", ["model.frontend.audio=logmel",
                                            "runtime.lstm_remat_gates=true"]),
                           ("train_legacy", ["model.frontend.audio=logmel"]),
                           ("train_big", smoke.BIG), ("train_big_gru", smoke.BIG_GRU),
                           ("train_gru", smoke.GRU), ("train_gru_legacy", smoke.GRU),
                           ("train_tf", smoke.TRANSFORMER)):
        if not _keep(tag):
            continue
        # [train_legacy] / [train_gru_legacy]: the legacy layout, the GRU's
        # with its 2-layer chain on (the switches live as long as this
        # process: restored below)
        legacy = tag.endswith("_legacy")
        prev = lstm_vjp.set_res2_mode("off" if legacy else "auto")
        prev_bwd2 = lstm_vjp.GRU_BWD2_ENABLED
        lstm_vjp.GRU_BWD2_ENABLED = tag == "train_gru_legacy"
        cfg = load_config(str(root / "configs" / "base.yaml"),
                          [*overrides, f"dataset.data_dir={data}"])
        model = init_weights(classifier_from_config(cfg),
                             torch.Generator().manual_seed(0)).to(dev)
        loader = create_dataloaders(cfg.dataset.name, cfg.dataset.data_dir,
                                    cfg.dataset.modalities, batch_size=32,
                                    seed=cfg.seed, device=dev)[0]
        raw = torch.from_numpy(loader.arrays.features["audio"]).to(dev)
        video = torch.from_numpy(loader.arrays.features["video"]).to(dev)
        # [serve]'s forward: the flags are inert at eval
        if tag not in ("train_remat", "train_legacy", "train_gru_legacy"):
            _forward_latency(torch, smoke, cfg, [*overrides, f"dataset.data_dir={data}"],
                             root, raw, video, res, tag.replace("train", "serve"))
        if cfg.model.frontend.cache:
            with torch.inference_mode():
                feats = logmel.logmel_cuda(raw, logmel_params_from_config(cfg.model.frontend))
            loader.replace_features("audio", feats.cpu().numpy())
        feats, labels = loader.device_arrays()
        opt, _ = build_optimizer(cfg.training, model.parameters(), len(loader))
        idx = torch.from_numpy(loader.epoch_batch_indices(0).astype(np.int64)).to(dev)
        valid = torch.from_numpy(loader.epoch_batch_valid()[0]).to(dev)
        gen = torch.Generator(device=dev)
        kw = dict(lr=cfg.training.learning_rate, clip_norm=cfg.training.gradient_clip_norm,
                  modality_dropout=cfg.training.augmentation.modality_dropout)
        state = {"step": 0}

        def one_step():
            s = state["step"]
            gen.manual_seed(s)
            train_step(model, opt, feats, labels, idx[s % idx.shape[0]], valid,
                       noise=Noise(gen), **kw)
            state["step"] = s + 1

        res[f"{tag}_p50_ms"], res[f"{tag}_p90_ms"] = smoke.host_ms(one_step, reps=60)
        lstm_vjp.set_res2_mode(prev)
        lstm_vjp.GRU_BWD2_ENABLED = prev_bwd2
    return res


def timers_of(root: Path) -> None:
    """Rows 4, 7, 6, 7f, 12, 13, 2, 11, 15, 10, 3, 14, 5, 9 and 8 of ``root`` built
    with -DRNN_CHAIN_TIMERS=1: each bucket's share of the warps' clock time
    at (32, 372, 512) (the 2-layer rows at (32, 372, 256)), per CTA set of
    the 2-layer cores."""
    torch = _card()
    smoke = _smoke()
    _build, lk = _port(root)
    csrc = root / "multimodal_emotion_detection_tpu_torch" / "csrc"
    kernels = {"lstm_bwd_chain_h512": ("lstm_bwd_chain", lk.LSTM_BWD_CHAIN),
               "gru_bwd_chain_h512": ("gru_bwd_chain", lk.GRU_BWD_CHAIN),
               "gru_bwd_chain_h256": ("gru_bwd_chain", lk.GRU_BWD_CHAIN),
               "lstm1_train_fwd_h512": ("lstm1_fwd", lk.LSTM1_TRAIN_FWD),
               "gru1_train_fwd_h512": ("gru1_fwd", lk.GRU1_TRAIN_FWD),
               "lstm2_bwd_chain_h256": ("lstm2_bwd_chain", lk.LSTM2_BWD_CHAIN),
               "lstm2_infer_b32_h256": ("lstm2_infer", lk.LSTM2_INFER),
               "lstm2_train_fwd_b32_h256": ("lstm2_train_fwd", lk.LSTM2_TRAIN_FWD),
               "gru2_bwd_chain_h256": ("gru2_bwd_chain", lk.GRU2_BWD_CHAIN),
               "gru2_infer_b32_h256": ("gru2_infer", lk.GRU2_INFER),
               "gru2_train_fwd_b32_h256": ("gru2_train_fwd", lk.GRU2_TRAIN_FWD),
               "lstm2_bwd_chain_remat_h256": ("lstm2_bwd_chain_remat",
                                              lk.LSTM2_BWD_CHAIN_REMAT),
               "gru2_bwd_chain_legacy_h256": ("gru2_bwd_chain_legacy",
                                              lk.GRU2_BWD_CHAIN_LEGACY),
               "lstm2_train_fwd_legacy_b32_h256": ("lstm2_train_fwd_legacy",
                                                   lk.LSTM2_TRAIN_FWD_LEGACY),
               "lstm2_bwd_chain_legacy_b32_h256": ("lstm2_bwd_chain_legacy",
                                                   lk.LSTM2_BWD_CHAIN_LEGACY),
               "gru2_train_fwd_legacy_b32_h256": ("gru2_train_fwd_legacy",
                                                  lk.GRU2_TRAIN_FWD_LEGACY)}
    kernels = {k: v for k, v in kernels.items() if _keep(k)}
    libs = {}
    for source in {s for s, _ in kernels.values()}:
        out = root / "build" / "chain_ab" / f"lib{source}_timers.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DRNN_CHAIN_TIMERS=1", "-o",
               str(out), str(csrc / f"{source}.cu")]
        log = subprocess.run(cmd, capture_output=True, text=True)
        if log.returncode != 0:
            sys.exit(f"chain_ab: nvcc failed for {source}:\n{log.stdout}{log.stderr}")
        for line in (log.stdout + log.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[timers:{source}] {line.strip()}")
        libs[source] = ctypes.CDLL(str(out))
    cases = {**_cases(torch, smoke, lk), **_lstm2_cases(torch, smoke, lk),
             **_gru2_cases(torch, smoke, lk)}
    # two blocks (a 2-layer core's lead and follow sets); a tree whose
    # timers predate them fills the first
    buf = (ctypes.c_ulonglong * (2 * (len(BUCKETS) + 1)))()
    for name, (source, kern) in kernels.items():
        lib = libs[source]
        if not hasattr(lib, f"{source}_timers"):
            print(f"[timers] {root}: {source} has no timer marks")
            continue
        kern._fn = getattr(lib, kern.symbol)
        kern._fn.argtypes, kern._fn.restype = kern.argtypes, ctypes.c_int
        kern._err_str = getattr(lib, f"{source}_error_string")
        kern._err_str.argtypes, kern._err_str.restype = [ctypes.c_int], ctypes.c_char_p
        read = getattr(lib, f"{source}_timers")
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        run = cases[name][0]
        run()
        if read(ctypes.addressof(buf), 1) != 0:
            sys.exit(f"chain_ab: {source}_timers failed")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        if read(ctypes.addressof(buf), 1) != 0:
            sys.exit(f"chain_ab: {source}_timers failed")
        plan = _plan_of(lk, source, int(name[-3:]), torch.device("cuda"))
        if plan is not None:
            print(f"[timers] {name} plan: UPC {plan.upc}, clusters of {plan.ncl}, "
                  f"{plan.rgroups} row groups, {getattr(plan, 'ctas', plan.grid)} CTAs, "
                  f"{plan.smem} bytes, "
                  f"chunks of {plan.kc}"
                  + (f", gate blocks of {plan.rk} steps" if getattr(plan, "rk", 0) else ""))
        # the 2-layer kernels' T + 1 phases
        pair = source in PAIR_SOURCES
        steps = 373 if pair else 372
        ms = start.elapsed_time(end)
        n = len(BUCKETS) + 1
        for k, label in enumerate(("", " follow set") if pair else ("",)):
            block = buf[k * n:(k + 1) * n]
            total, warps = sum(block[:-1]), block[-1]
            if not warps:
                continue
            if k == 0 and pair:
                label = " lead set"
            cyc = total / warps / steps
            print(f"[timers] {root.name or root}: {name}{label} {ms:.4f} ms "
                  f"({1e3 * ms / steps:.3f} us per phase), {warps} warps, {cyc:.0f} cycles "
                  f"per phase and warp ({cyc / (1e6 * ms / steps):.3f} GHz implied): "
                  + ", ".join(f"{b} {100 * x / total:.1f}%" for b, x in zip(BUCKETS, block)))


def _plan_of(lk, source, h, device):
    """The launch plan of ``source`` at B=32 in a tree that has one (an
    older tree may predate the chains', the forwards' or the 2-layer
    cores' plan)."""
    width = 4 if source.startswith("lstm") else 3
    if not hasattr(lk, "chain_plan_on"):
        return None
    if source in ("lstm2_bwd_chain_remat", "gru2_bwd_chain_legacy"):
        if not hasattr(lk, "REMAT_KS"):
            return None  # the first design: no plan
        return lk.chain_plan_on(source, width, h, 32, device, layers=2,
                                remat_d=64 if source.endswith("remat") else 0)
    if source in PAIR_SOURCES:
        if not hasattr(lk, "_pair_launch"):
            return None
        return lk.chain_plan_on(source, width, h, 32, device, "bwd" not in source,
                                layers=2)
    if source.endswith("_fwd"):
        if not hasattr(lk, "_fwd_launch"):
            return None
        return lk.chain_plan_on(source, width, h, 32, device, forward=True)
    return lk.chain_plan_on(source, width, h, 32, device)


def probe() -> None:
    torch = _card()
    _build, _ = _port(HERE)
    out = HERE / "build" / "chain_ab" / "libchain_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
           str(HERE / "scripts" / "chain_probe.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode != 0:
        sys.exit(f"chain_ab: nvcc failed for chain_probe.cu:\n{log.stdout}{log.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.chain_probe_error_string.argtypes = [I]
    lib.chain_probe_error_string.restype = ctypes.c_char_p
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def check(err, what):
        if err != 0:
            sys.exit(f"chain_ab: {what}: {lib.chain_probe_error_string(err).decode()}")

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[probe] {torch.cuda.get_device_name(0)}, {sms} SMs, clocks {smi.stdout.strip()}")
    lib.chain_probe_grid_sync.argtypes = [I, I, P]
    lib.chain_probe_counter_sync.argtypes = [P, I, I, P]
    iters = 4000
    for ctas in (128, 132):
        ms = timed(lambda: check(lib.chain_probe_grid_sync(ctas, iters, stream), "grid"))
        ctr = torch.zeros(1, dtype=torch.int32, device="cuda")

        def counter():
            ctr.zero_()
            check(lib.chain_probe_counter_sync(ctr.data_ptr(), ctas, iters, stream), "ctr")

        cms = timed(counter)
        print(f"[probe] {ctas} CTAs of 256 threads: grid.sync() {1e3 * ms / iters:.3f} us, "
              f"release/acquire counter barrier {1e3 * cms / iters:.3f} us per barrier")
    lib.chain_probe_l2_read.argtypes = [P, I, I, I, P, P]
    sink = torch.zeros(1024, device="cuda")
    for kib in (32, 256):
        n4 = kib * 1024 // 16
        src = torch.ones(n4 * 4, device="cuda")
        reps = 40
        ms = timed(lambda: check(lib.chain_probe_l2_read(
            src.data_ptr(), n4, 128, reps, sink.data_ptr(), stream), "l2"))
        per_sm = kib * 1024 * reps / (ms * 1e-3)
        print(f"[probe] 128 CTAs each reading the same {kib} KiB from L2 x{reps}: "
              f"{per_sm / 1e9:.1f} GB/s per SM, {128 * per_sm / 1e12:.2f} TB/s in all")
    lib.chain_probe_dsmem_read.argtypes = [I, I, I, I, P, P]
    lib.chain_probe_max_clusters.argtypes = [I, I, P]
    for cluster in (2, 4, 8, 16):
        for smem in (64 * 1024, 160 * 1024, 227 * 1024):
            count = ctypes.c_int(0)
            err = lib.chain_probe_max_clusters(cluster, smem, ctypes.byref(count))
            what = (f"{count.value} ({count.value * cluster} CTAs)" if err == 0
                    else lib.chain_probe_error_string(err).decode())
            print(f"[probe] clusters of {cluster} x 256 threads x {smem // 1024} KiB "
                  f"resident at once: {what}")
    for cluster in (2, 4, 8):
        n4 = 32 * 1024 // 16
        reps = 20
        ctas = 128
        err_box = []

        def run():
            err_box.append(lib.chain_probe_dsmem_read(cluster, ctas, n4, reps,
                                                      sink.data_ptr(), stream))

        ms = timed(run)
        check(max(err_box, key=abs), f"dsmem {cluster}")
        per_sm = (cluster - 1) * 32 * 1024 * reps / (ms * 1e-3)
        print(f"[probe] clusters of {cluster}, 128 CTAs, each reading its {cluster - 1} "
              f"peers' 32 KiB x{reps}: {per_sm / 1e9:.1f} GB/s per SM")
    lib.chain_probe_coop_cluster.argtypes = [I, I, P]
    for cluster in (2, 4, 8):
        err = lib.chain_probe_coop_cluster(cluster, 128, stream)
        torch.cuda.synchronize()
        print(f"[probe] cooperative launch with a cluster dimension of {cluster}, 128 "
              f"CTAs: {'taken' if err == 0 else lib.chain_probe_error_string(err).decode()}")


def sweep() -> None:
    """Rows 4, 7, 6 and 7f of this checkout at (32, 372, 512) on variants
    of the launch plan: the chunk, the cluster size, the row groups (every
    variant still re-checked by the launcher); then rows 4, 7, 6, 7f, 6e
    and 7e at B 1..24 on 1, 2 and 4 row groups."""
    import dataclasses

    torch = _card()
    smoke = _smoke()
    _, lk = _port(HERE)
    flush = smoke.L2Flush()
    cases = _cases(torch, smoke, lk)
    for name, source, width, forward in (
            ("lstm_bwd_chain_h512", "lstm_bwd_chain", 4, False),
            ("gru_bwd_chain_h512", "gru_bwd_chain", 3, False),
            ("lstm1_train_fwd_h512", "lstm1_fwd", 4, True),
            ("gru1_train_fwd_h512", "gru1_fwd", 3, True)):
        if not _keep(name):
            continue
        base = lk.chain_plan_on(source, width, 512, 32, torch.device("cuda"), forward)
        key = next(k for k in lk._CHAIN_PLANS if k[1] == source and k[2] == 512)
        variants = [base]
        for ncl, rgroups in ((2, 4), (1, 4), (2, 2), (1, 2)):
            cs4 = -(-((1 if forward else width) * 512 // 4) // ncl)
            for chunks in (1, 2, 4, 8):
                kc = -(-cs4 // chunks)
                need = 4 * lk.chain_smem_floats(width, 512, base.upc, ncl, rgroups, kc,
                                                forward)
                if need > 232_448:
                    continue
                v = dataclasses.replace(base, ncl=ncl, rgroups=rgroups, kc=kc,
                                        smem=max(need, 232_448 // 2 + 2048))
                if v not in variants:
                    variants.append(v)
        for v in variants:
            lk._CHAIN_PLANS[key] = v
            ms = smoke.device_ms(cases[name][0], flush)
            print(f"[sweep] {name}: clusters of {v.ncl}, {v.rgroups} row groups, "
                  f"chunks of {v.kc} float4 columns: {ms:.4f} ms")
        lk._CHAIN_PLANS[key] = base
    # the row groups below B=32: the plan's count against the others
    for rows in (1, 2, 4, 8, 12, 16, 24):
        for name, (source, width, forward, run) in _row_runs(torch, smoke, lk,
                                                              rows).items():
            if not _keep(name):
                continue
            base = lk.chain_plan_on(source, width, 512, rows, torch.device("cuda"),
                                    forward)
            key = next(k for k, v in lk._CHAIN_PLANS.items() if v is base)
            for rgroups in (1, 2, 4):
                need = 4 * lk.chain_smem_floats(width, 512, base.upc, base.ncl, rgroups,
                                                base.kc, forward)
                if need > 232_448:
                    continue
                lk._CHAIN_PLANS[key] = dataclasses.replace(
                    base, rgroups=rgroups, smem=max(need, 232_448 // 2 + 2048))
                ms = smoke.device_ms(run, flush)
                mark = " (the plan)" if rgroups == base.rgroups else ""
                print(f"[sweep] {name} B={rows}: {rgroups} row groups{mark}: {ms:.4f} ms")
            lk._CHAIN_PLANS[key] = base
    # the 2-layer LSTM kernels at B=1 (rows 12, 9, 11 and 5) on every plan
    # the card may hold
    dev = torch.device("cuda")
    pair = _lstm2_cases(torch, smoke, lk)
    for name, source, forward in (
            ("lstm2_bwd_chain_b1_h256", "lstm2_bwd_chain", False),
            ("lstm2_bwd_chain_legacy_b1_h256", "lstm2_bwd_chain_legacy", False),
            ("lstm2_train_fwd_b1_h256", "lstm2_train_fwd", True),
            ("lstm2_train_fwd_legacy_b1_h256", "lstm2_train_fwd_legacy", True)):
        if not _keep(name):
            continue
        base = lk.chain_plan_on(source, 4, 256, 1, dev, forward, layers=2)
        key = next(k for k, v in lk._CHAIN_PLANS.items() if v is base)
        for v in _pair_variants(lk, base):
            lk._CHAIN_PLANS[key] = v
            mark = " (the plan)" if v == base else ""
            what = (f"[sweep] {name}: UPC {v.upc}, clusters of {v.ncl}, {v.rgroups} row "
                    f"groups, chunks of {v.kc}{mark}")
            try:
                print(f"{what}: {smoke.device_ms(pair[name][0], flush):.4f} ms")
            except RuntimeError as err:  # the launcher's refusal, e.g. not resident
                print(f"{what}: refused ({err})")
        lk._CHAIN_PLANS[key] = base
    # row 13 on slices of the batch: the plan's (the stored-gates chain's
    # plan, the batch in slices where the gate blocks do not fit beside
    # it) beside launches of 16..64 rows and of the whole batch, each on
    # its rows' plan or, where the blocks do not fit beside that, on the
    # first plan whose blocks fit (a second pass, a ring of chunks)
    for batch in (48, 64, 96, *REMAT_WIDE_B):
        name = f"lstm2_bwd_chain_remat_b{batch}_h256"
        if not _keep(name):
            continue
        run = _remat_run(torch, smoke, lk, batch)
        base = lk.chain_plan_on("lstm2_bwd_chain_remat", 4, 256, batch, dev, layers=2,
                                remat_d=64)
        key = next(k for k, v in lk._CHAIN_PLANS.items() if v is base)
        variants = [base]
        for rows in (16, 32, 48, 64, batch):
            plan = lk.chain_plan_on("lstm2_bwd_chain_remat", 4, 256, rows, dev, layers=2,
                                    remat_d=64)
            if plan.batch_slice:
                plan = _remat_fit(lk, plan, rows)
            if plan is not None and rows <= batch:
                plan = dataclasses.replace(plan, batch_slice=rows if rows < batch else 0)
                if plan not in variants:
                    variants.append(plan)
        for plan in variants:
            lk._CHAIN_PLANS[key] = plan
            ms = smoke.device_ms(run, flush)
            n = -(-batch // (plan.batch_slice or batch))
            mark = " (the plan)" if plan is base else ""
            print(f"[sweep] {name}: {n} launches of {plan.batch_slice or batch} rows, "
                  f"{plan.rgroups} row groups, chunks of {plan.kc}, gate blocks of "
                  f"{plan.rk} steps{mark}: {ms:.4f} ms")
        lk._CHAIN_PLANS[key] = base


def _pair_variants(lk, base, hidden=256):
    """The 2-layer plans of ``base``'s kernel at ``hidden`` an H100 may
    hold: UPC 4 or 8, clusters of 1, 2, 4 or 8, 1, 2 or 4 row groups, the
    whole share in one chunk where it fits 232,448 bytes (the launcher
    re-checks each and refuses one whose clusters are not all resident);
    the plan first."""
    import dataclasses

    out = [base]
    for upc in (4, 8):
        grid = hidden // upc
        for ncl in (1, 2, 4, 8):
            for rgroups in (1, 2, 4):
                if grid % (ncl * rgroups) or upc * ncl * rgroups > lk.CHAIN_NU_MAX:
                    continue
                kc = -(-2 * base.exchanged // 4 // ncl)
                need = 4 * lk.chain_smem_floats(base.width, hidden, upc, ncl, rgroups, kc,
                                                base.forward, layers=2)
                v = dataclasses.replace(base, upc=upc, ncl=ncl, rgroups=rgroups, kc=kc,
                                        smem=max(need, 232_448 // 2 + 2048))
                if need <= 232_448 and v not in out:
                    out.append(v)
    return out


def _remat_fit(lk, plan, rows):
    """Row 13's first plan for ``rows`` (the flagship's geometry: clusters
    of 2) whose gate blocks fit an H100's 232,448 bytes: 4 then 2 row
    groups, the whole share in one chunk then rings of two, blocks of 8,
    4, 2 steps; None where none does."""
    import dataclasses

    for rgroups in (4, 2):
        for kc in (256, *(-(-256 // m) for m in range(9, 257))):
            for rk in lk.REMAT_KS:
                need = 4 * lk.chain_smem_floats(4, 256, plan.upc, plan.ncl, rgroups, kc,
                                                layers=2, remat=(rows, 64, rk))
                if need <= 232_448:
                    return dataclasses.replace(plan, rgroups=rgroups, kc=kc, rk=rk,
                                               smem=max(need, 232_448 // 2 + 2048),
                                               batch_slice=0)
    return None


def _row_runs(torch, smoke, lk, rows):
    """Rows 4, 7, 6, 7f and the eval forms 6e / 7e (final h) at (rows,
    372, 512) on ``chip_smoke.py``'s inputs: name -> (source, width,
    forward, run)."""
    import numpy as np

    inputs, w_hh = smoke._big_layer_inputs(5)
    x, w_ih, bias = inputs["D=512"]
    ih = (torch.matmul(x, w_ih) + bias)[:, :rows].contiguous()
    g, _, c_prev, _ = lk.lstm1_train_fwd(ih, w_hh)
    gin, gw_hh = smoke._big_layer_inputs(11, gates=3)
    gx, gw_ih, gb_ih = gin["D=512"]
    rng = np.random.RandomState(12)
    gb_hh = torch.from_numpy(rng.uniform(-512 ** -0.5, 512 ** -0.5, 3 * 512)
                             .astype(np.float32)).cuda()
    gih = (torch.matmul(gx, gw_ih) + gb_ih)[:, :rows].contiguous()
    gates, h_prev, _ = lk.gru1_train_fwd(gih, gw_hh, gb_hh)
    dhs = torch.from_numpy(rng.randn(*h_prev.shape).astype(np.float32)).cuda()
    dhf = dhs[-1].contiguous()
    return {
        "lstm_bwd_chain": ("lstm_bwd_chain", 4, False,
                           lambda: lk.lstm_bwd_chain(g, c_prev, dhs, dhf, w_hh)),
        "gru_bwd_chain": ("gru_bwd_chain", 3, False,
                          lambda: lk.gru_bwd_chain(gates, h_prev, dhs, dhf, gw_hh)),
        "lstm1_train_fwd": ("lstm1_fwd", 4, True, lambda: lk.lstm1_train_fwd(ih, w_hh)),
        "lstm1_infer": ("lstm1_fwd", 4, True, lambda: lk.lstm1_infer(ih, w_hh, False)),
        "gru1_train_fwd": ("gru1_fwd", 3, True,
                           lambda: lk.gru1_train_fwd(gih, gw_hh, gb_hh)),
        "gru1_infer": ("gru1_fwd", 3, True,
                       lambda: lk.gru1_infer(gih, gw_hh, gb_hh, False)),
    }


def exchange_probe() -> None:
    """The exchange alone on 128 CTAs: write 2 KiB each, barrier, read
    32 KiB (as row 4's plan at (32, 372, 512)), and its parts."""
    import ctypes as C

    torch = _card()
    _build, _ = _port(HERE)
    out = HERE / "build" / "chain_ab" / "libchain_probe.so"
    lib = C.CDLL(str(out))
    fn = lib.chain_probe_exchange
    fn.argtypes = [C.c_void_p, C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_int,
                   C.c_int, C.c_void_p, C.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    blk = torch.zeros(128 * 128 * 4, device="cuda")
    sink = torch.zeros(1024, device="cuda")
    steps = 1000
    for write, read_kib in ((1, 32), (0, 32), (1, 0), (0, 0), (1, 8), (1, 128)):
        ctr = torch.zeros(1, dtype=torch.int32, device="cuda")

        def run():
            ctr.zero_()
            if fn(blk.data_ptr(), ctr.data_ptr(), 128, steps, 128, read_kib * 64, write,
                  sink.data_ptr(), stream) != 0:
                sys.exit("chain_ab: chain_probe_exchange failed")

        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        print(f"[probe] exchange step on 128 CTAs: write 2 KiB {bool(write)}, barrier, "
              f"read {read_kib} KiB: {1e3 * start.elapsed_time(end) / steps:.3f} us")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--child", type=Path, help="time this tree alone")
    ap.add_argument("--timers", action="store_true", help="phase shares of both trees")
    ap.add_argument("--timers-parent", type=Path,
                    help="the parent with timer marks, for its timed run")
    ap.add_argument("--timers-of", type=Path, help="phase shares of this tree alone")
    ap.add_argument("--probe", action="store_true", help="barrier / L2 / cluster probes")
    ap.add_argument("--sweep", action="store_true", help="rows 4 / 7 on plan variants")
    ap.add_argument("--steps", action="store_true",
                    help="[train*] step and [serve*] forward p50s of both trees")
    ap.add_argument("--steps-of", type=Path, help="their step p50 with this tree")
    ap.add_argument("--rows", default="", help="only the cases, timed kernels and step "
                    "tags whose names match this regular expression")
    opts = ap.parse_args()
    if opts.rows:
        os.environ["CHAIN_AB_ROWS"] = opts.rows
    _card()
    if opts.child is None and opts.timers_of is None:
        print(f"[chain_ab] card: {_smi()}", flush=True)
    if opts.child is not None:
        print(json.dumps(child(opts.child.resolve())))
        return
    if opts.timers_of is not None:
        timers_of(opts.timers_of.resolve())
        return
    if opts.steps_of is not None:
        print(json.dumps(steps_of(opts.steps_of.resolve())))
        return
    if opts.parent is not None:
        parent = opts.parent.resolve()
        runs = []
        for tag, root in (("parent", parent), ("change", HERE), ("change", HERE),
                          ("parent", parent)):
            out = subprocess.run([sys.executable, __file__, "--child", str(root)],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                sys.exit(f"chain_ab: the {tag} child failed:\n{out.stdout}{out.stderr}")
            line = out.stdout.strip().splitlines()[-1]
            runs.append((tag, json.loads(line)))
            print(f"[chain_ab] {tag}: {line}", flush=True)
        keys = dict.fromkeys(k for _, r in runs for k in r if k.endswith("_ms"))
        for key in keys:
            print(f"[chain_ab] {key}: " + ", ".join(
                f"{tag} {r[key]:.4f}" if key in r else f"{tag} -" for tag, r in runs))
        if opts.steps:
            steps = []
            for tag, root in (("parent", parent), ("change", HERE), ("change", HERE),
                              ("parent", parent)):
                out = subprocess.run([sys.executable, __file__, "--steps-of", str(root)],
                                     capture_output=True, text=True)
                if out.returncode != 0:
                    sys.exit(f"chain_ab: the {tag} step child failed:\n{out.stdout}{out.stderr}")
                steps.append((tag, json.loads(out.stdout.strip().splitlines()[-1])))
            for key in [k for k in steps[0][1] if k.endswith("_ms")]:
                print(f"[chain_ab] {key}: " + ", ".join(
                    f"{tag} {r[key]:.4f}" for tag, r in steps))
        if opts.timers:
            tparent = (opts.timers_parent or opts.parent).resolve()
            for root in (tparent, HERE):
                subprocess.run([sys.executable, __file__, "--timers-of", str(root)],
                               check=True)
    if opts.probe:
        probe()
        exchange_probe()
    if opts.sweep:
        sweep()
    if opts.parent is None and not (opts.probe or opts.sweep):
        ap.error("give --parent, --child, --timers-of, --probe or --sweep")


if __name__ == "__main__":
    main()
