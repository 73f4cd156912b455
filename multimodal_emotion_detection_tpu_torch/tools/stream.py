"""Streaming / sliding-window inference CLI, on the card.

    python -m multimodal_emotion_detection_tpu_torch.tools.stream \
        --checkpoint outputs/<run>/best.ckpt --config <snapshot.yaml> \
        --input audio=long_audio.npy --input video=long_video.npy \
        [--window audio=48000 --window video=24] \
        [--hop audio=16000 --hop video=8] \
        [--smooth 0.6] [--microbatch 32] [--out stream_out] [overrides...]

The JAX package's streaming monitor: each modality's stream (one long
``(T_total, ...)`` array, e.g. a minutes-long 16 kHz waveform) is cut into
the model's clip-sized windows at a fixed hop; the windows, padded with
the last one to a whole number of microbatches, run through
``make_batched_forward_fn`` (one deterministic forward per microbatch,
the frontend inside it: ``frontend.cache`` is forced off); per-window
probabilities are optionally EMA-smoothed (``p_t = a*p_t +
(1-a)*p_{t-1}``) and written out in the JAX package's formats:

* ``timeline.csv``: window index, start / end sample per modality on its
  own clock, predicted label, per-class probabilities;
* ``probs.npy`` / ``predictions.npy``: the full (W, C) matrix and labels;
* ``summary.json``: windows, window and hop per modality, smoothing,
  label changes.

Window and hop default to the model's native clip length (48,000 samples /
24 frames for RAVDESS audio / video; ``dataset.sequence_length`` for
synthetic-format models) and a third of it.  It runs on the CUDA card;
``runtime.platform=cpu`` runs it on the CPU, where every kernel wrapper
runs its plain version.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def sliding_windows(arr: np.ndarray, window: int, hop: int) -> np.ndarray:
    """(T_total, ...) -> (W, window, ...); zero-pads a too-short stream
    to one full window."""
    if arr.shape[0] < window:
        pad = [(0, window - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        arr = np.pad(arr, pad)
    n = 1 + (arr.shape[0] - window) // hop
    idx = np.arange(window)[None, :] + hop * np.arange(n)[:, None]
    return arr[idx]


def ema_smooth(probs: np.ndarray, alpha: float) -> np.ndarray:
    """Exponential smoothing along the window axis (alpha=1 -> identity)."""
    if alpha >= 1.0:
        return probs
    out = np.empty_like(probs)
    out[0] = probs[0]
    for i in range(1, len(probs)):
        out[i] = alpha * probs[i] + (1.0 - alpha) * out[i - 1]
    return out


def _parse_kv(pairs, cast):
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        if not _:
            raise SystemExit(f"--input/--window/--hop need name=value: {p}")
        if k in out:
            raise SystemExit(f"duplicate key {k!r} in {p!r}")
        out[k] = cast(v)
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Sliding-window streaming "
                                                 "inference")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", default=None)
    parser.add_argument("--input", action="append", required=True,
                        metavar="MODALITY=FILE.npy",
                        help="one long (T_total, ...) stream per modality")
    parser.add_argument("--window", action="append", metavar="MODALITY=N",
                        help="window length per modality (defaults: the "
                             "model's native clip length)")
    parser.add_argument("--hop", action="append", metavar="MODALITY=N",
                        help="hop per modality (default window//3)")
    parser.add_argument("--smooth", type=float, default=1.0,
                        help="EMA alpha in (0,1]; 1 = no smoothing")
    parser.add_argument("--microbatch", type=int, default=32)
    parser.add_argument("--out", default="./stream_out")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


# native clip lengths of the RAVDESS pipeline: 3 s of 16 kHz audio / 24
# sampled frames
_NATIVE_WINDOW = {"audio": 48000, "video": 24}


def main(argv=None):
    args = parse_args(argv)

    import torch

    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.tools._restore import (
        restore_model,
    )
    from multimodal_emotion_detection_tpu_torch.training.steps import (
        make_batched_forward_fn,
    )
    from multimodal_emotion_detection_tpu_torch.utils.runtime import (
        device_from_config,
    )

    config = load_config(args.config, args.overrides)
    config.model.frontend.cache = False  # raw features into the forward
    device = device_from_config(config)

    if not 0.0 < args.smooth <= 1.0:
        raise SystemExit(f"--smooth must be in (0, 1], got {args.smooth}")
    streams = {m: np.load(f) for m, f in
               _parse_kv(args.input, str).items()}
    expected = set(config.dataset.modalities)
    if set(streams) != expected:
        raise SystemExit(
            f"--input modalities {sorted(streams)} must match the model's "
            f"configured modalities {sorted(expected)}")
    windows = _parse_kv(args.window, int)
    hops = _parse_kv(args.hop, int)
    for name, kv in (("--window", windows), ("--hop", hops)):
        unknown = set(kv) - set(streams)
        if unknown:
            raise SystemExit(f"{name} names {sorted(unknown)} have no "
                             f"matching --input stream")
    # default window: the model's native clip length.  Synthetic-format
    # models use dataset.sequence_length for every modality; RAVDESS-
    # format data uses the pipeline's clip constants per modality name.
    synthetic = config.dataset.name == "synthetic"
    for m in streams:
        windows.setdefault(
            m, config.dataset.sequence_length if synthetic
            else _NATIVE_WINDOW.get(m, config.dataset.sequence_length))
        hops.setdefault(m, max(1, windows[m] // 3))
        if windows[m] <= 0 or hops[m] <= 0:
            raise SystemExit(
                f"window/hop for {m!r} must be positive "
                f"(got window={windows[m]}, hop={hops[m]})")

    # cut every modality into the same number of windows
    cut = {m: sliding_windows(np.asarray(a, np.float32), windows[m], hops[m])
           for m, a in streams.items()}
    n_win = min(len(c) for c in cut.values())
    cut = {m: c[:n_win] for m, c in cut.items()}

    model, meta = restore_model(config, Path(args.checkpoint), device)
    mb = max(1, min(args.microbatch, n_win))
    print(f"Restored {args.checkpoint} (meta: {meta}); "
          f"{n_win} windows x {mb} per microbatch")

    # pad W up to a multiple of the microbatch with the last window and
    # run the whole timeline as stacked (S, mb, ...) microbatches
    n_pad = (n_win + mb - 1) // mb * mb
    feats = {}
    for m, c in cut.items():
        if n_pad != n_win:
            c = np.concatenate(
                [c, np.repeat(c[-1:], n_pad - n_win, axis=0)], axis=0)
        feats[m] = torch.from_numpy(
            np.ascontiguousarray(c.reshape((n_pad // mb, mb) + c.shape[1:]))
        ).to(device)
    forward_many = make_batched_forward_fn(model)
    logits = forward_many(feats).float().cpu().numpy().reshape(n_pad, -1)[:n_win]

    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    probs = ema_smooth(probs, args.smooth)
    preds = probs.argmax(-1)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "probs.npy", probs)
    np.save(out_dir / "predictions.npy", preds)
    first = sorted(streams)[0]
    with open(out_dir / "timeline.csv", "w") as f:
        heads = [f"{m}_start,{m}_end" for m in sorted(streams)]
        f.write("window," + ",".join(heads) + ",label,"
                + ",".join(f"p{c}" for c in range(probs.shape[1])) + "\n")
        for i in range(n_win):
            spans = []
            for m in sorted(streams):
                s = i * hops[m]
                spans += [str(s), str(s + windows[m])]
            f.write(f"{i}," + ",".join(spans) + f",{preds[i]},"
                    + ",".join(f"{p:.6f}" for p in probs[i]) + "\n")
    summary = {
        "windows": int(n_win),
        "window": {m: int(windows[m]) for m in streams},
        "hop": {m: int(hops[m]) for m in streams},
        "smooth": args.smooth,
        "label_changes": int((preds[1:] != preds[:-1]).sum()),
        "first_modality": first,
    }
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    print(f"Wrote streaming timeline to {out_dir}")
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
