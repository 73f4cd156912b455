"""Drive the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (name, count, nvidia-smi name and power limit).
2. Builds every CUDA kernel of the path from ``csrc/`` (one nvcc per
   source, all at once) and prints ptxas's register / shared-memory /
   spill report.
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and times kernel, plain version and,
   where one exists, the one PyTorch call computing the same function.
4. Serves: writes a 64-clip synthetic test split, builds the flagship
   (configs/base.yaml + model.frontend.audio=logmel) with seeded weights,
   saves a checkpoint and runs the port's predict CLI on it at batch 32.
   The kernels' launch counts are zeroed just before and read just after:
   each kernel must have run once per batch.  The logits are checked
   against the model's own forward on the CPU, where every kernel wrapper
   runs its plain version.  Then the
   forward's latency at batch 32 and 1 (host clock) and, under
   torch.profiler, its device time by kernel and the device's busy share.
5. Prints one JSON line describing every kernel, nvidia-smi's name and
   power limit of the card, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no ok
line.  Without a CUDA card it exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM published peaks (NVIDIA data sheet), at its 700 W power limit
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES = 3.35e12  # bytes/s


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


class L2Flush:
    """Writes 128 MB, over twice the 50 MB L2, so a timed call starts with
    its inputs in device memory as a fresh request's would be."""

    def __init__(self):
        self.buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")

    def __call__(self):
        self.buf.zero_()


def device_ms(fn, flush: L2Flush, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call,
    the L2 flushed before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 110, warmup: int = 5):
    """Median and 90th percentile (11 samples beyond it at 110 reps) of
    the host-clock time of ``fn`` + synchronize, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    times.sort()
    return statistics.median(times), times[int(0.9 * reps)]


def max_errs(out: torch.Tensor, ref: torch.Tensor):
    diff = (out - ref).abs()
    return float(diff.max()), float((diff / ref.abs().clamp(min=1e-3)).max())


def phase_logmel(logmel, flush):
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    wave = torch.from_numpy(rng.randn(32, 48000).astype(np.float32)).to(dev)
    p = logmel.LogMelParams()
    out = logmel.logmel_cuda(wave, p)
    torch.cuda.synchronize()
    ref = logmel.logmel_frames(wave, p)
    abs_err, rel_err = max_errs(out, ref)
    print(f"[logmel] (32, 48000) hop 128 -> {tuple(out.shape)}: "
          f"max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
          "(bound 1e-4 abs + 1e-4 rel)")
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    p160 = logmel.LogMelParams(hop_length=160)
    out160 = logmel.logmel_cuda(wave, p160)
    ref160 = logmel.logmel_frames(wave, p160)
    a160, r160 = max_errs(out160, ref160)
    print(f"[logmel] (32, 48000) hop 160 -> {tuple(out160.shape)}: "
          f"max abs err {a160:.3e}, max rel err {r160:.3e}")
    torch.testing.assert_close(out160, ref160, rtol=1e-4, atol=1e-4)

    ms = device_ms(lambda: logmel.logmel_cuda(wave, p), flush)
    plain_ms = device_ms(lambda: logmel.logmel_frames(wave, p), flush)
    b, t = wave.shape
    f, nb, nm = out.shape[1], p.n_bins, p.n_mels
    # the function as the reference defines it: products with the
    # window-folded DFT basis, whose rows outside the window are zero
    lo, hi = logmel.nonzero_taps(p.n_fft, p.win_length)
    taps = hi - lo
    flops = b * f * (4 * taps * nb + 2 * nb * nm)
    nbytes = 4 * (b * t + b * f * nm + 2 * taps * nb + nb * nm)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[logmel] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP over the "
          f"{taps} non-zero taps, {nbytes / 1e6:.2f} MB); no single PyTorch "
          "call computes it")
    # an FFT computes the same spectrum in other roundings: a real n_fft-point
    # FFT at 2.5 n log2 n flops, the power, and the filterbank's non-zeros
    mel_nnz = int(np.count_nonzero(logmel.mel_filterbank(p)))
    fft_flops = b * f * (2.5 * p.n_fft * np.log2(p.n_fft) + 3 * nb + 2 * mel_nnz)
    fft_ms, fft_by = bound(fft_flops, nbytes)
    print(f"[logmel] an FFT + sparse filterbank formulation would need "
          f"{fft_flops / 1e9:.3f} GFLOP ({mel_nnz} filterbank non-zeros): "
          f"floor {fft_ms:.4f} ms ({fft_by})")
    return {"name": "logmel", "route": "cuda",
            "source": "multimodal_emotion_detection_tpu_torch/csrc/logmel.cu",
            "replaces": "multimodal_emotion_detection_tpu/ops/logmel.py:160",
            "max_abs_err": max(abs_err, a160), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_lstm(lstm_kernel, flush):
    dev = torch.device("cuda")
    b, t, d, h = 32, 372, 64, 256
    rng = np.random.RandomState(1)
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        return {name: torch.from_numpy(
            rng.uniform(-k, k, shape).astype(np.float32)).to(dev)
            for name, shape in (("w_ih", (d_in, 4 * h)),
                                ("w_hh", (h, 4 * h)), ("b", (4 * h,)))}

    l0, l1 = layer(d), layer(h)
    x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32)).to(dev)
    out = lstm_kernel.lstm2_infer(x, l0, l1)
    torch.cuda.synchronize()
    ref = lstm_kernel.lstm2_infer_reference(x, l0, l1)
    abs_err, rel_err = max_errs(out, ref)
    print(f"[lstm2_infer] B={b} T={t} D={d} H={h}: max abs err {abs_err:.3e}, "
          f"max rel err {rel_err:.3e} (bound 1e-4 abs on h1)")
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    out1 = lstm_kernel.lstm2_infer(x[:1], l0, l1)
    ref1 = lstm_kernel.lstm2_infer_reference(x[:1], l0, l1)
    a1, _ = max_errs(out1, ref1)
    print(f"[lstm2_infer] B=1: max abs err {a1:.3e}")
    torch.testing.assert_close(out1, ref1, rtol=0, atol=1e-4)

    # yardstick only, never called by the port: cuDNN's LSTM with the
    # same weights (torch keeps (4H, D) matrices and two biases)
    lib = torch.nn.LSTM(d, h, num_layers=2, batch_first=True).to(dev)
    with torch.no_grad():
        for i, p in enumerate((l0, l1)):
            getattr(lib, f"weight_ih_l{i}").copy_(p["w_ih"].T)
            getattr(lib, f"weight_hh_l{i}").copy_(p["w_hh"].T)
            getattr(lib, f"bias_ih_l{i}").copy_(p["b"])
            getattr(lib, f"bias_hh_l{i}").zero_()
        lib_out = lib(x)[1][0][-1]
    lib_err, _ = max_errs(lib_out, ref)
    print(f"[lstm2_infer] torch.nn.LSTM (cuDNN) vs plain: max abs err {lib_err:.3e}")

    def run_lib():
        with torch.no_grad():
            lib(x)

    ms = device_ms(lambda: lstm_kernel.lstm2_infer(x, l0, l1), flush)
    plain_ms = device_ms(
        lambda: lstm_kernel.lstm2_infer_reference(x, l0, l1), flush, reps=5)
    library_ms = device_ms(run_lib, flush)
    x1 = x[:1].contiguous()
    ms_b1 = device_ms(lambda: lstm_kernel.lstm2_infer(x1, l0, l1), flush)
    flops = 2 * b * t * (d * 4 * h + 3 * h * 4 * h)
    nbytes = 4 * (b * t * d + d * 4 * h + 3 * h * 4 * h + 2 * 4 * h + b * h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[lstm2_infer] kernel {ms:.4f} ms (input projection + one "
          f"cooperative launch, {t + 1} grid barriers), plain {plain_ms:.4f} ms, "
          f"cuDNN {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; serial chain of "
          f"{2 * t} layer-steps)")
    print(f"[lstm2_infer] B=1 kernel {ms_b1:.4f} ms ({1e3 * ms_b1 / (t + 1):.3f} us "
          "per barrier phase: the serial chain's floor)")
    return {"name": "lstm2_infer", "route": "cuda",
            "source": "multimodal_emotion_detection_tpu_torch/csrc/lstm2_infer.cu",
            "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:40",
            "max_abs_err": max(abs_err, a1), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_serve(kernels):
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )
    from multimodal_emotion_detection_tpu_torch.ops import logmel, lstm_kernel
    from multimodal_emotion_detection_tpu_torch.tools import predict
    from multimodal_emotion_detection_tpu_torch.training.checkpoints import (
        save_checkpoint,
    )
    from multimodal_emotion_detection_tpu_torch.training.steps import forward

    n = 64
    data = WORK / "data"
    split = data / "test"
    split.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(2)
    audio = rng.randn(n, 48000, 1).astype(np.float32)
    video = rng.rand(n, 24, 4096).astype(np.float32)
    np.save(split / "audio.npy", audio)
    np.save(split / "video.npy", video)
    np.save(split / "labels.npy", rng.randint(0, 8, n).astype(np.int32))

    config_path = str(ROOT / "configs" / "base.yaml")
    overrides = ["model.frontend.audio=logmel", f"dataset.data_dir={data}"]
    cfg = load_config(config_path, overrides)
    model = init_weights(classifier_from_config(cfg),
                         torch.Generator().manual_seed(0))
    ckpt = WORK / "flagship_seed0.pt"
    save_checkpoint(ckpt, model.state_dict(), {"seed": 0})
    out_dir = WORK / "predictions"

    counters = {"logmel": logmel.LOGMEL, "lstm2_infer": lstm_kernel.LSTM2_INFER}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    metrics = predict.main(["--checkpoint", str(ckpt), "--config", config_path,
                            "--split", "test", "--out", str(out_dir), *overrides])
    predict_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    print(f"[serve] predict over {n} clips at batch {cfg.dataset.batch_size}: "
          f"{predict_s:.3f} s wall (first call, data load included); "
          f"launches {launches}")
    for name, count in launches.items():
        if count != n // cfg.dataset.batch_size:
            raise RuntimeError(f"{name} launched {count} times on the serving "
                               f"path, expected {n // cfg.dataset.batch_size}")
        kernels[name]["launches"] = count

    logits = np.load(out_dir / "logits.npy")
    if logits.shape != (n, 8) or not np.isfinite(logits).all():
        raise RuntimeError(f"bad logits: shape {logits.shape}")
    if not (out_dir / "metrics.json").exists():
        raise RuntimeError("metrics.json was not written")
    print(f"[serve] metrics {json.dumps(metrics)}")

    # the model's own forward on the CPU, where every kernel wrapper runs
    # its plain version (each kernel was held against it on the card above)
    ref = torch.cat([
        forward(model, {"audio": torch.from_numpy(audio[i:i + 32]),
                        "video": torch.from_numpy(video[i:i + 32])})
        for i in range(0, n, 32)]).numpy()
    err = float(np.abs(logits - ref).max())
    agree = int((logits.argmax(-1) == ref.argmax(-1)).sum())
    print(f"[serve] logits vs the plain-version forward on the CPU: max abs "
          f"err {err:.3e} (bound 1e-3), argmax agreement {agree}/{n}")
    if err > 1e-3 or agree != n:
        raise RuntimeError("served logits disagree with the plain forward")

    dev = torch.device("cuda")
    model = model.to(dev).eval()

    b32 = {"audio": torch.from_numpy(audio[:32]).to(dev),
           "video": torch.from_numpy(video[:32]).to(dev)}
    b1 = {k: v[:1].contiguous() for k, v in b32.items()}
    for label, batch in (("b32", b32), ("b1", b1)):
        p50, p90 = host_ms(lambda: forward(model, batch))
        print(f"[serve] forward latency {label} (host clock around "
              f"synchronize, 110 requests, inputs on the card): "
              f"p50 {p50:.4f} ms, p90 {p90:.4f} ms")
        profile_forward(label, lambda: forward(model, batch))


def profile_forward(label: str, fn, reps: int = 20) -> None:
    """Where a forward's time goes: device time by kernel over ``reps``
    back-to-back forwards under torch.profiler, and the device's busy share
    of the host-clock window they took."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if not busy_us:
        print(f"[profile] {label}: device time not measured (the profiler "
              "recorded no device activity)")
        return
    print(f"[profile] {label}: {reps} forwards in {window_us / 1e3:.4f} ms "
          f"(host clock, profiler on); device busy {busy_us / 1e3:.4f} ms = "
          f"{100 * busy_us / window_us:.1f}% of it, idle "
          f"{100 * (1 - busy_us / window_us):.1f}%")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile] {label}:   {us / reps:9.2f} us/forward "
              f"{100 * us / busy_us:5.1f}%  {name[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA card")
    sys.path.insert(0, str(ROOT))
    from multimodal_emotion_detection_tpu_torch.ops import _build, logmel, lstm_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {name}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")

    t0 = time.perf_counter()
    reports = _build.build(["logmel", "lstm2_infer"])
    print(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'nothing (cached)'}")
    for src, log in reports.items():
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"[build:{src}] {line.strip()}")

    flush = L2Flush()
    kernels = {"logmel": phase_logmel(logmel, flush),
               "lstm2_infer": phase_lstm(lstm_kernel, flush)}
    phase_serve(kernels)

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: kern[k] for k in order}
                                  for kern in kernels.values()]}))
    print(nvidia_smi())  # the card's name and power limit, as nvidia-smi says
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
