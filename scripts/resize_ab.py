"""The video frontend's BGR -> gray step on the card, formulated several
ways, and the whole frontend (gray, area resize, / 255) around each.

    python3 scripts/resize_ab.py [--reps 10]

At the raw RAVDESS batch ``chip_smoke.py``'s ``[serve_resize]`` serves,
(32, 24, 720, 1280, 3) uint8 BGR frames (2.1 GB, made on the card), in one
process and in turns (each formulation twice, in the order listed, then
in reverse), this prints each formulation's device time (CUDA events,
median of ``--reps``; the frames exceed the 50 MB L2 forty times over),
its largest difference from the float32 ``torch.matmul`` by the luma
vector (the JAX package's formulation), and the least time the card could
take (each uint8 byte read once, the float32 gray frames written once, at
the datasheet 3.35 TB/s).  TF32 is off.  Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPE = (32, 24, 720, 1280, 3)
HBM_BYTES = 3.35e12  # H100 SXM datasheet, bytes/s
LUMA = np.array([0.114, 0.587, 0.299], dtype=np.float32)  # BGR, cv2's weights


def device_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("resize_ab: torch sees no CUDA card")
    from multimodal_emotion_detection_tpu_torch.ops import resize

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    frames = torch.randint(0, 256, SHAPE, dtype=torch.uint8, device=dev, generator=gen)
    w = torch.from_numpy(LUMA).to(dev)
    b, g, r = (float(v) for v in LUMA)
    ways = {
        "matmul (x.float() @ w, a gemv)": lambda: frames.to(torch.float32) @ w,
        "matmul n=1 (x.float() @ w[:, None])":
            lambda: (frames.to(torch.float32) @ w[:, None])[..., 0],
        "mul + sum (x.float() * w).sum(-1)": lambda: (frames.to(torch.float32) * w).sum(-1),
        "channels (x[..., c] * w_c, uint8 promoted)":
            lambda: frames[..., 0] * b + frames[..., 1] * g + frames[..., 2] * r,
        "ops/resize.py::bgr_to_gray (x[..., 0] * w_0, then two in-place adds)":
            lambda: resize.bgr_to_gray(frames),
    }
    ref = ways["matmul (x.float() @ w, a gemv)"]()
    errs = {name: float((fn() - ref).abs().max()) for name, fn in ways.items()}
    del ref
    times = {name: [] for name in ways}
    for order in (list(ways), list(reversed(ways))):
        for name in order:
            times[name].append(device_ms(ways[name], args.reps))
    gray_bytes = frames.numel() + frames.numel() // 3 * 4
    print(f"[resize_ab] gray of {SHAPE} uint8 ({frames.numel() / 1e9:.3f} GB); bound "
          f"{1e3 * gray_bytes / HBM_BYTES:.4f} ms (bytes {gray_bytes / 1e9:.3f} GB at "
          f"{HBM_BYTES / 1e12:.2f} TB/s)")
    for name in ways:
        print(f"[resize_ab]   {name}: " + " / ".join(f"{t:.4f}" for t in times[name])
              + f" ms; max abs diff from the matmul {errs[name]:.3e}")

    def frontend():
        return resize.area_resize(resize.bgr_to_gray(frames), 64, 64) / 255.0

    out_bytes = SHAPE[0] * SHAPE[1] * 64 * 64 * 4
    t = [device_ms(frontend, args.reps) for _ in range(2)]
    print(f"[resize_ab] the whole frontend (ops/resize.py: gray, area resize to 64x64, "
          f"/255): {t[0]:.4f} / {t[1]:.4f} ms; bound "
          f"{1e3 * (frames.numel() + out_bytes) / HBM_BYTES:.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[resize_ab] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}")


if __name__ == "__main__":
    main()
