"""Time the PyTorch port's log-mel kernel of two trees on one card.

    python3 scripts/logmel_ab.py --parent DIR   # DIR: another checkout

Runs the timing child on DIR, on this checkout, on this checkout again and
on DIR (parent, change, change, parent), each in its own process that
imports ``multimodal_emotion_detection_tpu_torch`` from its tree and builds
that tree's kernel into its own ``build/torch_kernels/``.  Each child holds
``logmel_cuda`` against ``logmel_frames`` (1e-4 abs + 1e-4 rel) and prints
one JSON line:

* median device times (CUDA events around each call, L2 flushed before
  each, 50 calls after 5 warm-ups) of ``logmel_cuda`` on ``chip_smoke.py``'s
  (32, 48000) randn clips and on the first of them alone, at hops 128 and
  160 (n_fft 512, 400-sample window, 64 mels);
* the same "held": a spin of 10^6 clock cycles enqueued between the flush
  and the call keeps the card busy until the host has enqueued the call,
  so the wrapper's host time (as long as the new kernel) stays out of the
  events and the time is the card's alone;
* the largest error against the plain version, and at B=32, hop 128 the
  largest error of the kernel and of the plain version against a float64
  log-mel on the card (frames times the window, ``torch.fft.rfft`` in
  float64, the dense filterbank: a yardstick no path of the port calls).

``--child ROOT`` runs one child.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def _timed(fn, flush, reps=50, warmup=5, spin=0):
    """Median device time of ``fn`` in ms; ``spin`` > 0 enqueues a spin of
    that many clock cycles after the flush, so the host has enqueued the
    call before the card reaches it and its Python time stays out."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        if spin:
            torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def child(root: Path) -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("logmel_ab: torch sees no CUDA card")
    sys.path.insert(0, str(root))
    from multimodal_emotion_detection_tpu_torch.ops import logmel

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev).zero_
    wave = torch.from_numpy(
        np.random.RandomState(0).randn(32, 48000).astype(np.float32)).to(dev)
    res = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    err = 0.0
    for hop in (128, 160):
        p = logmel.LogMelParams(hop_length=hop)
        for tag, x in (("b32", wave), ("b1", wave[:1].contiguous())):
            out = logmel.logmel_cuda(x, p)
            ref = logmel.logmel_frames(x, p)
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
            err = max(err, float((out - ref).abs().max()))
            res[f"{tag}_hop{hop}_ms"] = _timed(lambda: logmel.logmel_cuda(x, p), flush)
            res[f"{tag}_hop{hop}_held_ms"] = _timed(lambda: logmel.logmel_cuda(x, p), flush,
                                                     spin=1_000_000)
    res["max_abs_err"] = err
    p = logmel.LogMelParams()
    n = np.arange(p.win_length)
    window = np.zeros(p.n_fft)
    left = (p.n_fft - p.win_length) // 2
    window[left:left + p.win_length] = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / p.win_length))
    frames = wave.double().unfold(1, p.n_fft, p.hop_length)
    spec = torch.fft.rfft(frames * torch.from_numpy(window).to(dev), dim=-1).abs() ** 2
    mel = torch.from_numpy(logmel.mel_filterbank(p).astype(np.float64)).to(dev)
    truth = torch.log(spec @ mel + p.log_epsilon)
    for tag, fn in (("kernel", logmel.logmel_cuda), ("plain", logmel.logmel_frames)):
        res[f"{tag}_err_vs_float64"] = float((fn(wave, p).double() - truth).abs().max())
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--parent", type=Path, help="the other checkout")
    group.add_argument("--child", type=Path, help="time this tree alone")
    opts = ap.parse_args()
    if opts.child is not None:
        print(json.dumps(child(opts.child.resolve())))
        return
    here = Path(__file__).resolve().parents[1]
    parent = opts.parent.resolve()
    runs = []
    for tag, root in (("parent", parent), ("change", here), ("change", here),
                      ("parent", parent)):
        out = subprocess.run([sys.executable, __file__, "--child", str(root)],
                             capture_output=True, text=True, check=True)
        line = out.stdout.strip().splitlines()[-1]
        runs.append((tag, json.loads(line)))
        print(f"[logmel_ab] {tag}: {line}")
    for key in [k for k in runs[0][1] if k.endswith("_ms")]:
        print(f"[logmel_ab] {key}: " + ", ".join(f"{tag} {r[key]:.4f}" for tag, r in runs))


if __name__ == "__main__":
    main()
