"""Time the PyTorch port's flash-attention kernels of two trees on one card.

    python3 scripts/flash_ab.py --parent DIR   # DIR: another checkout

Runs the timing child on DIR, on this checkout, on this checkout again and
on DIR (parent, change, change, parent), each in its own process that
imports ``multimodal_emotion_detection_tpu_torch`` from its tree and builds
that tree's kernels into its own ``build/torch_kernels/``.  Each child
prints one JSON line of median device times (CUDA events around each call,
L2 flushed before each, 20 calls after 3 warm-ups):

* ``flash_fwd`` at the transformer encoder's (32, 4, 372, 64), rates 0 and
  0.1, and SDPA's forward on the same inputs (no dropout);
* ``flash_bwd_fused`` there at rates 0.1 and 0, and SDPA's backward;
* ``flash_bwd_dkv`` and ``flash_bwd_dq`` at (2, 4, 5000, 64) with a key
  bias at rate 0.1, and SDPA's backward there; ``flash_bwd_dkv`` also with
  the first 4,224 keys only (66 key tiles x 8 = 528 CTAs, two whole waves
  at two CTAs an SM, against 632 in 2.4 waves), which shows what the last
  wave's tail costs;
* the bf16 forms: ``flash_fwd`` and ``flash_bwd_fused`` at (32, 4, 372, 64)
  at rates 0 and 0.1, each beside SDPA in bf16 at the same ``dropout_p``
  (forward, and backward by ``autograd.grad``), and ``flash_bwd_dkv`` /
  ``flash_bwd_dq`` at (2, 4, 5000, 64) with a key bias at rates 0 and 0.1,
  beside SDPA's bf16 backward at the same ``dropout_p`` (``bf16_long_*``),
  and ``flash_bwd_dq`` over the first 3,136 query rows (one wave of CTAs).

The inputs are ``chip_smoke.py``'s.  ``--child ROOT`` runs one child.
After the four children, two measurements of this checkout alone:

* ``--mma-rate`` (also run after the children): the card's mma.sync TF32
  rate, from ``scripts/mma_rate.cu``, independent m16n8k8 MMAs from
  registers at 1 to 8 CTAs of 4 warps per SM;
* ``--dq-timers`` (also run after the children): ``flash_bwd_dq`` built
  with ``-DFLASH_DQ_TIMERS=1`` at (2, 4, 5000, 64), rates 0.1 and 0: each
  phase's share of the warps' clock64() time in the key walk;
* ``--fused-timers`` (also run after the children): ``flash_bwd_fused``
  built with ``-DFLASH_BWD_TIMERS=1`` at (32, 4, 372, 64), rates 0.1 and
  0: each phase's share of the warps' clock64() time in the query walk
  (the products, P / mask / dS, the dS transpose, dQ), and the cycles a
  warp spends per query tile; then its dK / dV form (``flash_bwd_dkv``,
  the same build) at (2, 4, 5000, 64) with a key bias, rates 0.1 and 0;
* ``--fwd-timers`` (also run after the children): the bf16 forward built
  with ``-DFLASH_FWD_TIMERS=1`` at (32, 4, 372, 64), rates 0.1 and 0: each
  phase's share of the consumer threads' clock64() time;
* ``--bf16-fused-timers`` (also run after the children): the bf16 fused
  backward built with ``-DFLASH_BWD_TIMERS=1`` there, rates 0.1 and 0: the
  phases of its kv role and of its q role;
* ``--bf16-dq-timers`` (also run after the children): the bf16 dQ form
  (``flash_bwd_dq`` on bf16 operands) from the same build at (2, 4, 5000,
  64) with a key bias, rates 0.1 and 0: its phases' shares and the
  thread-cycles a key tile.

A timer build names its phases (``<source>_timer_names``).  Needs a CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def _timed(fn, flush, reps=20, warmup=3):
    """Median device time of ``fn`` in ms, the L2 cache flushed before each
    call; a ~0.5 ms spin of the card after the flush lets the host enqueue
    the start event and the call before the card reaches them, so the
    wrapper's own host time is not counted."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def child(root: Path, bf16_only: bool = False) -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_ab: torch sees no CUDA card")
    sys.path.insert(0, str(root))
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    flush = buf.zero_

    def inputs(b, h, t, d, seed, valid=None):
        rng = np.random.RandomState(seed)
        q, k, v = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(dev)
                   for _ in range(3))
        do = torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(dev)
        bias = None if valid is None else torch.from_numpy(
            np.where(valid, 0.0, -1e9).astype(np.float32)).to(dev)
        return q, k, v, bias, do

    def sdpa_bwd(q, k, v, bias, do, rate=0.0):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        mask = None if bias is None else bias[:, None, None, :]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                               dropout_p=rate)
        return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)

    res = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    if bf16_only:
        res.update(_bf16_times(fa, inputs, sdpa_bwd, flush))
        return res
    seed = torch.tensor([0x5EED_0F_F1A5], dtype=torch.int64, device=dev)
    q, k, v, _, do = inputs(32, 4, 372, 64, 5)
    o, lse = fa.flash_fwd_reference(q, k, v, None, seed, 0.1)
    args = (q, k, v, None, seed, 0.1, do, lse, (do * o).sum(-1))
    res["flash_fwd_rate0_ms"] = _timed(lambda: fa.flash_fwd(q, k, v, None, seed, 0.0), flush)
    res["flash_fwd_rate01_ms"] = _timed(lambda: fa.flash_fwd(q, k, v, None, seed, 0.1), flush)
    res["sdpa_fwd_ms"] = _timed(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), flush)
    res["flash_bwd_fused_ms"] = _timed(lambda: fa.flash_bwd_fused(*args), flush)
    args0 = (q, k, v, None, seed, 0.0, do, lse, (do * o).sum(-1))
    res["flash_bwd_fused_rate0_ms"] = _timed(lambda: fa.flash_bwd_fused(*args0), flush)
    res["sdpa_bwd_ms"] = _timed(sdpa_bwd(q, k, v, None, do), flush)

    rng = np.random.RandomState(31)
    valid = rng.rand(2, 5000) > 0.1
    valid[:, 0] = True
    q, k, v, bias, do = inputs(2, 4, 5000, 64, 32, valid)
    seed = torch.tensor([0xA77E5710], dtype=torch.int64, device=dev)
    o, lse = fa.flash_fwd_reference(q, k, v, bias, seed, 0.1)
    args = (q, k, v, bias, seed, 0.1, do, lse, (do * o).sum(-1))
    res["long_flash_fwd_ms"] = _timed(lambda: fa.flash_fwd(q, k, v, bias, seed, 0.1), flush)
    res["long_dkv_ms"] = _timed(lambda: fa.flash_bwd_dkv(*args), flush)
    kv = 66 * 64  # whole waves: 66 key tiles x 8 (head, batch) = 528 CTAs
    args_kv = (q, k[:, :, :kv].contiguous(), v[:, :, :kv].contiguous(),
               bias[:, :kv].contiguous(), seed, 0.1, do, lse, (do * o).sum(-1))
    res["long_dkv_tk4224_ms"] = _timed(lambda: fa.flash_bwd_dkv(*args_kv), flush)
    res["long_dq_ms"] = _timed(lambda: fa.flash_bwd_dq(*args), flush)
    res["long_sdpa_bwd_ms"] = _timed(sdpa_bwd(q, k, v, bias, do), flush)
    res.update(_bf16_times(fa, inputs, sdpa_bwd, flush))
    return res


def _host_us(fn, reps=20) -> float:
    """Median host time of one call of ``fn`` in µs, with the card kept
    busy so that no call waits on it."""
    import time

    import torch

    times = []
    for _ in range(reps):
        torch.cuda._sleep(500_000)
        t0 = time.perf_counter()
        fn()
        times.append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def _bf16_times(fa, inputs, sdpa_bwd, flush) -> dict:
    """The bf16 forms (rows 16b, 17b at the encoder's shape, 18b and 19b at
    (2, 4, 5000, 64)) beside SDPA in bf16, each at dropout rates 0 and 0.1
    (SDPA's ``dropout_p``, its training mode); the host time of a forward
    and a fused backward call."""
    import numpy as np
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    dev = torch.device("cuda")
    res = {}
    seed = torch.tensor([0x5EED_0F_F1A5], dtype=torch.int64, device=dev)
    q, k, v, _, do = (x if x is None else x.to(bf16) for x in inputs(32, 4, 372, 64, 5))
    for rate, tag in ((0.0, "rate0"), (0.1, "rate01")):
        o, lse = fa.flash_fwd_reference(q, k, v, None, seed, rate)
        args = (q, k, v, None, seed, rate, do, lse, (do.float() * o.float()).sum(-1))
        res[f"bf16_fwd_{tag}_ms"] = _timed(
            lambda: fa.flash_fwd(q, k, v, None, seed, rate), flush)
        res[f"bf16_sdpa_fwd_{tag}_ms"] = _timed(
            lambda: sdpa(q, k, v, dropout_p=rate), flush)
        res[f"bf16_bwd_fused_{tag}_ms"] = _timed(lambda: fa.flash_bwd_fused(*args), flush)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = sdpa(*leaves, dropout_p=rate)
        res[f"bf16_sdpa_bwd_{tag}_ms"] = _timed(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), flush)
        if rate > 0.0:
            res["bf16_fwd_host_us"] = _host_us(lambda: fa.flash_fwd(q, k, v, None, seed, rate))
            res["bf16_bwd_fused_host_us"] = _host_us(lambda: fa.flash_bwd_fused(*args))

    rng = np.random.RandomState(31)
    valid = rng.rand(2, 5000) > 0.1
    valid[:, 0] = True
    q, k, v, bias, do = inputs(2, 4, 5000, 64, 32, valid)
    q, k, v, do = (x.to(bf16) for x in (q, k, v, do))
    seed = torch.tensor([0xA77E5710], dtype=torch.int64, device=dev)
    for rate, tag in ((0.0, "rate0"), (0.1, "rate01")):
        o, lse = fa.flash_fwd_reference(q, k, v, bias, seed, rate)
        args = (q, k, v, bias, seed, rate, do, lse, (do.float() * o.float()).sum(-1))
        res[f"bf16_long_dkv_{tag}_ms"] = _timed(lambda: fa.flash_bwd_dkv(*args), flush)
        res[f"bf16_long_dq_{tag}_ms"] = _timed(lambda: fa.flash_bwd_dq(*args), flush)
        res[f"bf16_long_sdpa_bwd_{tag}_ms"] = _timed(
            sdpa_bwd(q, k, v, bias.to(bf16), do, rate), flush)
    # the dQ form over the first 3,136 query rows: 49 query tiles x 8 (head,
    # batch row) = 392 CTAs, one wave at 3 CTAs an SM on 132 SMs, against
    # 632 in 1.6 waves: a query tile's time in each shows the tail's cost
    rows = 49 * 64
    q_w, do_w, lse_w, delta_w = (x[:, :, :rows].contiguous() for x in (q, do, lse, args[8]))
    args_w = (q_w, k, v, bias, seed, 0.1, do_w, lse_w, delta_w)
    res["bf16_long_dq_tq3136_rate01_ms"] = _timed(lambda: fa.flash_bwd_dq(*args_w), flush)
    return res


def _nvcc_lib(root: Path, src: Path, name: str, flags) -> Path:
    sys.path.insert(0, str(root))
    from multimodal_emotion_detection_tpu_torch.ops import _build

    out = root / "build" / "flash_ab" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out), str(src)]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode != 0:
        sys.exit(f"flash_ab: nvcc failed for {src}:\n{log.stdout}{log.stderr}")
    return out


def mma_rate(root: Path) -> None:
    import ctypes

    import torch

    csrc = root / "multimodal_emotion_detection_tpu_torch" / "csrc"
    lib = ctypes.CDLL(str(_nvcc_lib(root, root / "scripts" / "mma_rate.cu",
                                    "mma_rate", ["-I", str(csrc)])))
    fn = lib.mma_rate_launch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    out = torch.zeros(1024, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2000
    for per_sm in (1, 2, 3, 4, 8):
        for chain in (1, 3):
            blocks = per_sm * sms
            fn(blocks, 128, iters, chain, out.data_ptr(), stream)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if fn(blocks, 128, iters, chain, out.data_ptr(), stream) != 0:
                sys.exit("flash_ab: mma_rate_launch failed")
            end.record()
            end.synchronize()
            flops = blocks * 4 * iters * 8 * chain * 2 * 16 * 8 * 8
            print(f"[mma_rate] {per_sm} CTAs of 4 warps per SM, chain {chain}: "
                  f"{flops / start.elapsed_time(end) / 1e9:.1f} TFLOP/s of "
                  "m16n8k8 TF32 mma.sync")


def dq_timers(root: Path) -> None:
    import ctypes

    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    lib = _timed_lib(root, "flash_bwd_dq", "-DFLASH_DQ_TIMERS=1", fa.FLASH_BWD_DQ)
    timers = lib.flash_bwd_dq_timers
    timers.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda")
    rng = np.random.RandomState(32)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 4, 5000, 64).astype(np.float32)).to(dev)
                   for _ in range(4))
    valid = rng.rand(2, 5000) > 0.1
    valid[:, 0] = True
    bias = torch.from_numpy(np.where(valid, 0.0, -1e9).astype(np.float32)).to(dev)
    seed = torch.tensor([0xA77E5710], dtype=torch.int64, device=dev)
    names = ["wait", "split + barrier", "S = Q K^T and dP = dO V^T", "dS (P, mask)",
             "dQ += dS K", "barrier", "next tile's copies"]
    buf = (ctypes.c_ulonglong * 7)()
    for rate in (0.1, 0.0):
        o, lse = fa.flash_fwd_reference(q, k, v, bias, seed, rate)
        args = (q, k, v, bias, seed, rate, do, lse, (do * o).sum(-1))
        fa.flash_bwd_dq(*args)
        torch.cuda.synchronize()
        timers(ctypes.addressof(buf), 1)
        fa.flash_bwd_dq(*args)
        torch.cuda.synchronize()
        timers(ctypes.addressof(buf), 1)
        total = sum(buf)
        print(f"[dq_timers] (2, 4, 5000, 64) rate {rate}: " + ", ".join(
            f"{n} {100 * x / total:.1f}%" for n, x in zip(names, buf)))


def _timed_lib(root: Path, src: str, flag: str, *kerns):
    """``src`` built with ``flag`` into its own library and bound to each
    of ``kerns`` (``CudaKernel``s of that source) in place of the default
    build; returns the library."""
    import ctypes

    csrc = root / "multimodal_emotion_detection_tpu_torch" / "csrc"
    lib = ctypes.CDLL(str(_nvcc_lib(root, csrc / f"{src}.cu", f"{src}_timers", [flag])))
    for kern in kerns:
        kern._fn = getattr(lib, kern.symbol)
        kern._fn.argtypes, kern._fn.restype = kern.argtypes, ctypes.c_int
        kern._err_str = getattr(lib, f"{src}_error_string")
        kern._err_str.argtypes, kern._err_str.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def fused_timers(root: Path) -> None:
    import ctypes

    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    lib = _timed_lib(root, "flash_bwd_fused", "-DFLASH_BWD_TIMERS=1", fa.FLASH_BWD_FUSED,
                     fa.FLASH_BWD_DKV)
    timers = lib.flash_bwd_fused_timers
    timers.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda")
    rng = np.random.RandomState(5)
    b, h, t, d = 32, 4, 372, 64
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(dev)
                   for _ in range(4))
    seed = torch.tensor([0x5EED_0F_F1A5], dtype=torch.int64, device=dev)
    names = ["wait", "split + barrier", "S^T = K Q^T and dP^T = V dO^T",
             "P, mask, dS", "dV += (P M)^T dO and dK += dS^T Q",
             "dS transpose + barrier", "dQ = dS K"]
    buf = (ctypes.c_ulonglong * len(names))()
    n_spans, per_span = fa.kv_spans(t)
    # every thread adds its clock: threads x query tiles of 32 walked by
    # every CTA (each span's key tiles), 32 a warp
    walks = n_spans * per_span * h * b * 128 * -(-t // 32)
    for rate in (0.1, 0.0):
        o, lse = fa.flash_fwd_reference(q, k, v, None, seed, rate)
        args = (q, k, v, None, seed, rate, do, lse, (do * o).sum(-1))
        fa.flash_bwd_fused(*args)
        torch.cuda.synchronize()
        timers(ctypes.addressof(buf), 1)
        fa.flash_bwd_fused(*args)
        torch.cuda.synchronize()
        timers(ctypes.addressof(buf), 1)
        total = sum(buf)
        print(f"[fused_timers] ({b}, {h}, {t}, {d}) rate {rate}: "
              f"{total / walks:.0f} cycles a warp and query tile; " + ", ".join(
                  f"{n} {100 * x / total:.1f}%" for n, x in zip(names, buf)))
    # the dK / dV form at the long sequence: one key tile a CTA, no dQ phases
    b, t = 2, 5000
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(dev)
                   for _ in range(4))
    valid = rng.rand(b, t) > 0.1
    valid[:, 0] = True
    bias = torch.from_numpy(np.where(valid, 0.0, -1e9).astype(np.float32)).to(dev)
    walks = -(-t // 64) * h * b * 128 * -(-t // 32)
    for rate in (0.1, 0.0):
        o, lse = fa.flash_fwd_reference(q, k, v, bias, seed, rate)
        args = (q, k, v, bias, seed, rate, do, lse, (do * o).sum(-1))
        fa.flash_bwd_dkv(*args)
        torch.cuda.synchronize()
        timers(ctypes.addressof(buf), 1)
        fa.flash_bwd_dkv(*args)
        torch.cuda.synchronize()
        timers(ctypes.addressof(buf), 1)
        total = sum(buf)
        print(f"[dkv_timers] ({b}, {h}, {t}, {d}) rate {rate}: "
              f"{total / walks:.0f} cycles a warp and query tile; " + ", ".join(
                  f"{n} {100 * x / total:.1f}%" for n, x in zip(names[:5], buf)))


def _phase_report(tag: str, names, buf) -> None:
    """Each phase's share of the thread-cycles; phases of a timer build that
    the kernel run does not have (no cycles) are left out."""
    total = sum(buf)
    print(f"{tag}: {total / 1e9:.3f} G thread-cycles in all; " + ", ".join(
        f"{n} {100 * x / total:.1f}%" for n, x in zip(names, buf) if x))


def _run_timed(timers, buf, fn) -> None:
    """``fn`` once to warm, then once with the timers zeroed before."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    timers(ctypes.addressof(buf), 1)
    fn()
    torch.cuda.synchronize()
    timers(ctypes.addressof(buf), 1)


def fwd_timers(root: Path) -> None:
    """The bf16 forward (row 16b) built with -DFLASH_FWD_TIMERS=1 at the
    encoder's (32, 4, 372, 64), rates 0.1 and 0: each phase's share of the
    threads' clock64() time."""
    import ctypes

    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    src = fa.FLASH_FWD_BF16.source
    lib = _timed_lib(root, src, "-DFLASH_FWD_TIMERS=1", fa.FLASH_FWD_BF16)
    timers = getattr(lib, f"{src}_timers")
    timers.argtypes = [ctypes.c_void_p, ctypes.c_int]
    names = _timer_names(lib, src)
    buf = (ctypes.c_ulonglong * len(names))()
    dev = torch.device("cuda")
    rng = np.random.RandomState(5)
    b, h, t, d = 32, 4, 372, 64
    q, k, v = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(dev)
               .to(torch.bfloat16) for _ in range(3))
    seed = torch.tensor([0x5EED_0F_F1A5], dtype=torch.int64, device=dev)
    for rate in (0.1, 0.0):
        _run_timed(timers, buf, lambda: fa.flash_fwd(q, k, v, None, seed, rate))
        _phase_report(f"[fwd_timers] bf16 ({b}, {h}, {t}, {d}) rate {rate}", names, buf)


def _timer_names(lib, src: str):
    """The phase names a timer build reports (``<src>_timer_names``, a
    comma-separated string)."""
    import ctypes

    fn = getattr(lib, f"{src}_timer_names")
    fn.restype = ctypes.c_char_p
    return fn().decode().split(",")


def bf16_fused_timers(root: Path) -> None:
    """The bf16 fused backward (row 17b) built with -DFLASH_BWD_TIMERS=1 at
    (32, 4, 372, 64), rates 0.1 and 0; and the time of the sum the first
    design's wrapper made of its float32 dQ partials (one a kv span of the
    float32 form's ``kv_spans``) and its rounding to bf16, which this
    design does not make."""
    import ctypes

    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    src = fa.FLASH_BWD_FUSED_BF16.source
    lib = _timed_lib(root, src, "-DFLASH_BWD_TIMERS=1", fa.FLASH_BWD_FUSED_BF16,
                     fa.FLASH_BWD_DKV_BF16)
    timers = getattr(lib, f"{src}_timers")
    timers.argtypes = [ctypes.c_void_p, ctypes.c_int]
    names = _timer_names(lib, src)
    buf = (ctypes.c_ulonglong * len(names))()
    dev = torch.device("cuda")
    rng = np.random.RandomState(5)
    b, h, t, d = 32, 4, 372, 64
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(dev)
                   .to(torch.bfloat16) for _ in range(4))
    seed = torch.tensor([0x5EED_0F_F1A5], dtype=torch.int64, device=dev)
    for rate in (0.1, 0.0):
        o, lse = fa.flash_fwd_reference(q, k, v, None, seed, rate)
        args = (q, k, v, None, seed, rate, do, lse, (do.float() * o.float()).sum(-1))
        _run_timed(timers, buf, lambda: fa.flash_bwd_fused(*args))
        _phase_report(f"[fused_timers] bf16 ({b}, {h}, {t}, {d}) rate {rate}", names, buf)
    n_spans = fa.kv_spans(t)[0]
    parts = torch.randn((n_spans, b, h, t, d), device=dev)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev).zero_
    ms = _timed(lambda: parts.sum(dim=0).to(torch.bfloat16), flush)
    print(f"[fused_timers] the first design's wrapper sum of {n_spans} float32 dQ "
          f"partials and its rounding to bf16 (not made here): {ms:.4f} ms")


def bf16_dq_timers(root: Path) -> None:
    """The bf16 dQ form (row 19b) built with -DFLASH_BWD_TIMERS=1 at (2, 4,
    5000, 64) with a key bias, rates 0.1 and 0: each of its phases' share of
    the threads' clock64() time, and the thread-cycles a query tile's
    thread spends on a key tile."""
    import ctypes

    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    src = fa.FLASH_BWD_DQ_BF16.source
    lib = _timed_lib(root, src, "-DFLASH_BWD_TIMERS=1", fa.FLASH_BWD_DQ_BF16)
    timers = getattr(lib, f"{src}_timers")
    timers.argtypes = [ctypes.c_void_p, ctypes.c_int]
    names = _timer_names(lib, src)
    buf = (ctypes.c_ulonglong * len(names))()
    dev = torch.device("cuda")
    rng = np.random.RandomState(32)
    b, h, t, d = 2, 4, 5000, 64
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(dev)
                   .to(torch.bfloat16) for _ in range(4))
    valid = rng.rand(b, t) > 0.1
    valid[:, 0] = True
    bias = torch.from_numpy(np.where(valid, 0.0, -1e9).astype(np.float32)).to(dev)
    seed = torch.tensor([0xA77E5710], dtype=torch.int64, device=dev)
    plan = fa.flash_bf16_plan("dq", b, h, t, t, d)
    # every thread of every query tile walks every key tile
    walks = plan["q_ctas"] * h * b * fa.BF16_THREADS * -(-t // 64)
    for rate in (0.1, 0.0):
        o, lse = fa.flash_fwd_reference(q, k, v, bias, seed, rate)
        args = (q, k, v, bias, seed, rate, do, lse, (do.float() * o.float()).sum(-1))
        _run_timed(timers, buf, lambda: fa.flash_bwd_dq(*args))
        print(f"[dq_timers] bf16 ({b}, {h}, {t}, {d}) rate {rate}: "
              f"{sum(buf) / walks:.0f} cycles a thread and key tile")
        _phase_report(f"[dq_timers] bf16 ({b}, {h}, {t}, {d}) rate {rate}", names, buf)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--parent", type=Path, help="the other checkout")
    group.add_argument("--child", type=Path, help="time this tree alone")
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 forms alone, and only their phase timers")
    group.add_argument("--mma-rate", action="store_true", help="mma.sync TF32 rate")
    group.add_argument("--dq-timers", action="store_true", help="dq phase shares")
    group.add_argument("--fused-timers", action="store_true",
                       help="the fused backward's phase shares")
    group.add_argument("--fwd-timers", action="store_true",
                       help="the bf16 forward's phase shares")
    group.add_argument("--bf16-fused-timers", action="store_true",
                       help="the bf16 fused backward's phase shares")
    group.add_argument("--bf16-dq-timers", action="store_true",
                       help="the bf16 dQ form's phase shares")
    opts = ap.parse_args()
    here = Path(__file__).resolve().parents[1]
    if opts.child is not None:
        print(json.dumps(child(opts.child.resolve(), opts.bf16)))
        return
    modes = {"mma_rate": mma_rate, "dq_timers": dq_timers, "fused_timers": fused_timers,
             "fwd_timers": fwd_timers, "bf16_fused_timers": bf16_fused_timers,
             "bf16_dq_timers": bf16_dq_timers}
    for mode, fn in modes.items():
        if getattr(opts, mode):
            fn(here)
            return
    parent = opts.parent.resolve()
    runs = []
    for tag, root in (("parent", parent), ("change", here), ("change", here),
                      ("parent", parent)):
        out = subprocess.run([sys.executable, __file__, "--child", str(root)]
                             + (["--bf16"] if opts.bf16 else []),
                             capture_output=True, text=True, check=True)
        runs.append((tag, json.loads(out.stdout.strip().splitlines()[-1])))
        print(f"[flash_ab] {tag}: {out.stdout.strip().splitlines()[-1]}")
    keys = [k for k in runs[0][1] if k.endswith(("_ms", "_us"))]
    for key in keys:
        print(f"[flash_ab] {key}: " + ", ".join(
            f"{tag} {r[key]:.4f}" for tag, r in runs))
    flags = ("--mma-rate", "--dq-timers", "--fused-timers", "--fwd-timers",
             "--bf16-fused-timers", "--bf16-dq-timers")
    for flag in flags[3:] if opts.bf16 else flags:
        subprocess.run([sys.executable, __file__, flag], check=True)


if __name__ == "__main__":
    main()
