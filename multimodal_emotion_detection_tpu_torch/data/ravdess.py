"""RAVDESS ETL: raw media -> fixed-shape ``.npy`` splits.

Produces the reference pipeline's output layout (the reference's
dataprocessing.py): ``out_root/{train,val,test}/{audio,video,labels}.npy``
with audio ``(N, 48000, 1)`` (16 kHz, 3 s, peak-normalized) and video
``(N, 24, 4096)`` (24 uniformly-sampled grayscale 64x64 frames / 255,
flattened).  Host code, as in the JAX package, whose ``data/ravdess.py``
this is: the same arrays bit for bit and the same files byte for byte.

Differences from the reference by design:
* audio decode / resample uses the port's WAV reader + polyphase resampler
  (``utils/wav.py``, the native upfirdn core; librosa is not needed; same
  16 kHz contract);
* video frames are decoded in ONE sequential pass retrieving only the
  sampled indices (the reference buffers every frame in RAM first) and
  resized with the exact-area resizer (``ops/resize.py::area_resize_np``,
  cv2.INTER_AREA's result);
* the stratified split draws ONE set of indices shared by all modalities
  (sklearn two-stage with identical seed / stratify, so split membership
  matches the reference, without its two-independent-calls pattern).

``cv2`` (video decode) and ``sklearn`` (the split) are imported when they
are needed: without sklearn the split takes a numpy per-class shuffle, and
without cv2 the CLI runs with ``--no_video``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from multimodal_emotion_detection_tpu_torch.ops.resize import area_resize_np
from multimodal_emotion_detection_tpu_torch.utils.wav import load_audio

AUDIO_SR = 16000
AUDIO_MAX_DURATION = 3.0
VIDEO_MAX_FRAMES = 24
VIDEO_H = 64
VIDEO_W = 64

EMOTION_NAMES = [
    "neutral", "calm", "happy", "sad", "angry", "fearful", "disgust",
    "surprised",
]

_FIELDS = (
    "modality", "channel", "emotion", "intensity", "statement",
    "repetition", "actor",
)


def parse_ravdess_filename(fname: str) -> Dict[str, int]:
    """Decode the 7-field A-B-C-D-E-F-G stem (modality/channel/emotion/
    intensity/statement/repetition/actor)."""
    stem = Path(fname).stem
    parts = stem.split("-")
    if len(parts) != 7:
        raise ValueError(f"Unexpected RAVDESS filename format: {fname}")
    return {field: int(part) for field, part in zip(_FIELDS, parts)}


def map_emotion_label(meta: Dict[str, int]) -> int:
    """Emotion code 01-08 -> class index 0-7."""
    code = meta["emotion"]
    if not 1 <= code <= 8:
        raise ValueError(f"Invalid emotion code: {code}")
    return code - 1


def load_filepaths(root_dir: str, ext: str) -> List[Path]:
    return sorted(Path(root_dir).rglob(f"*{ext}"))


def build_stem_map(filepaths: List[Path]) -> Dict[str, Path]:
    """Full-stem index with duplicate detection (the reference's
    dataprocessing.py:131-141; superseded by build_join_key_map in the join
    flow, kept for API completeness)."""
    stem_map: Dict[str, Path] = {}
    for fp in filepaths:
        if fp.stem in stem_map:
            raise ValueError(
                f"Duplicate stem: {fp.stem} for {fp} and {stem_map[fp.stem]}"
            )
        stem_map[fp.stem] = fp
    return stem_map


def build_join_key_map(filepaths: List[Path]) -> Dict[str, Path]:
    """Key files by the last 6 stem fields so audio/video join even when
    the modality code differs; on collision prefer modality 01 > 02 > 03."""
    modality_rank = {1: 0, 2: 1, 3: 2}
    join_map: Dict[str, Path] = {}
    for fp in filepaths:
        parts = fp.stem.split("-")
        if len(parts) != 7:
            raise ValueError(f"Unexpected RAVDESS filename format: {fp}")
        key = "-".join(parts[1:])
        rank = modality_rank.get(int(parts[0]), 999)
        if key not in join_map:
            join_map[key] = fp
        else:
            old_rank = modality_rank.get(
                int(join_map[key].stem.split("-")[0]), 999
            )
            if rank < old_rank:
                join_map[key] = fp
    return join_map


def load_raw_audio(
    wav_path: Path,
    sr: int = AUDIO_SR,
    max_duration: float = AUDIO_MAX_DURATION,
) -> np.ndarray:
    """(T, 1) float32: resample -> truncate/zero-pad -> peak-normalize."""
    y, _ = load_audio(wav_path, sr=sr)
    max_len = int(max_duration * sr)
    if len(y) > max_len:
        y = y[:max_len]
    elif len(y) < max_len:
        y = np.pad(y, (0, max_len - len(y)))
    peak = np.max(np.abs(y))
    if peak > 0:
        y = y / peak
    return y.astype(np.float32).reshape(-1, 1)


def load_raw_video_frames(
    video_path: Path,
    max_frames: int = VIDEO_MAX_FRAMES,
    frame_height: int = VIDEO_H,
    frame_width: int = VIDEO_W,
) -> np.ndarray:
    """(max_frames, H*W) float32 in [0,1]; zeros fallback if undecodable."""
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError(
            "OpenCV is required for video ETL; rerun with --no_video or "
            "install opencv-python"
        ) from exc

    feat_dim = frame_height * frame_width
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise IOError(f"Failed to open video: {video_path}")

    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    selected: List[np.ndarray] = []

    def to_feat(frame: np.ndarray) -> np.ndarray:
        gray = frame.astype(np.float32) @ np.array(
            [0.114, 0.587, 0.299], dtype=np.float32
        )  # BGR luma
        small = area_resize_np(gray, frame_height, frame_width)
        return (small / 255.0).reshape(-1).astype(np.float32)

    if total > 0:
        if total >= max_frames:
            wanted = set(np.linspace(0, total - 1, max_frames).astype(int))
        else:
            wanted = set(range(total))
        # single sequential pass: grab() skips, retrieve() decodes selected
        for i in range(total):
            if i in wanted:
                ret, frame = cap.read()
                if not ret:
                    break
                selected.append(to_feat(frame))
            else:
                if not cap.grab():
                    break
    else:
        # unknown frame count: decode everything, then uniform-sample
        frames = []
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            frames.append(frame)
        if frames:
            if len(frames) >= max_frames:
                idx = np.linspace(0, len(frames) - 1, max_frames).astype(int)
            else:
                idx = np.arange(len(frames))
            selected = [to_feat(frames[i]) for i in idx]
    cap.release()

    if not selected:
        return np.zeros((max_frames, feat_dim), dtype=np.float32)
    out = np.stack(selected, axis=0)
    if out.shape[0] < max_frames:
        pad = np.zeros((max_frames - out.shape[0], feat_dim), np.float32)
        out = np.concatenate([out, pad], axis=0)
    return out[:max_frames]


def stratified_two_stage_split(
    labels: np.ndarray,
    strat_keys: Optional[np.ndarray],
    val_size: float,
    test_size: float,
    random_state: int = 42,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Train/val/test INDEX split, one shared permutation for all
    modalities.  Uses sklearn when available (exact membership parity with
    the reference's seeds), else a numpy per-class shuffle."""
    n = len(labels)
    indices = np.arange(n)
    temp_frac = val_size + test_size
    if not 0 < temp_frac < 1:
        raise ValueError("val_size + test_size must be in (0, 1)")
    val_rel = val_size / temp_frac
    try:
        from sklearn.model_selection import train_test_split

        def safe_split(idx, y, frac, stratify):
            try:
                return train_test_split(
                    idx, y, test_size=frac, random_state=random_state,
                    stratify=stratify,
                )
            except ValueError as exc:
                # tiny per-class counts: degrade to unstratified (the
                # reference would crash here)
                print(f"[split] stratify disabled for this stage: {exc}")
                return train_test_split(
                    idx, y, test_size=frac, random_state=random_state,
                    stratify=None,
                )

        idx_train, idx_temp, y_train, y_temp = safe_split(
            indices, labels, temp_frac, strat_keys
        )
        idx_val, idx_test, _, _ = safe_split(
            idx_temp, y_temp, 1 - val_rel,
            y_temp if strat_keys is not None else None,
        )
        return idx_train, idx_val, idx_test
    except ImportError:  # no sklearn: a numpy per-class shuffle
        rng = np.random.RandomState(random_state)
        keys = strat_keys if strat_keys is not None else np.zeros(n, int)
        tr, va, te = [], [], []
        for k in np.unique(keys):
            grp = indices[keys == k]
            rng.shuffle(grp)
            n_temp = int(round(len(grp) * temp_frac))
            n_val = int(round(n_temp * val_rel))
            va.extend(grp[:n_val])
            te.extend(grp[n_val:n_temp])
            tr.extend(grp[n_temp:])
        return (np.array(tr), np.array(va), np.array(te))


def build_ravdess_multimodal_raw(
    audio_root: str,
    video_root: Optional[str] = None,
    use_video: bool = True,
    val_size: float = 0.1,
    test_size: float = 0.1,
    random_state: int = 42,
    stratify_by: Optional[str] = "emotion",
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Discover + join + extract + split.  Returns (train, val, test) dicts
    with 'audio' [+ 'video'] + 'labels' arrays."""
    audio_files = load_filepaths(audio_root, ".wav")
    if not audio_files:
        raise RuntimeError(f"No .wav files found under {audio_root}")
    audio_map = build_join_key_map(audio_files)

    if use_video:
        if video_root is None:
            raise ValueError("use_video=True but video_root is None")
        video_files = load_filepaths(video_root, ".mp4")
        if not video_files:
            raise RuntimeError(f"No .mp4 files found under {video_root}")
        video_map = build_join_key_map(video_files)
        common_keys = sorted(set(audio_map) & set(video_map))
        if not common_keys:
            raise RuntimeError(
                "No matching join keys between audio and video sets.\n"
                f"Example audio keys: {list(audio_map)[:5]}\n"
                f"Example video keys: {list(video_map)[:5]}"
            )
        print(f"Found {len(common_keys)} matched audio+video samples.")
    else:
        common_keys = sorted(audio_map)
        print(f"Using audio only; found {len(common_keys)} audio samples.")

    audio_feats, video_feats, labels, strat_keys = [], [], [], []
    for key in common_keys:
        audio_path = audio_map[key]
        meta = parse_ravdess_filename(audio_path.name)
        label = map_emotion_label(meta)
        audio_feats.append(load_raw_audio(audio_path))
        if use_video:
            video_feats.append(load_raw_video_frames(video_map[key]))
        labels.append(label)
        if stratify_by == "emotion":
            strat_keys.append(label)
        elif stratify_by == "actor":
            strat_keys.append(meta["actor"])
        else:
            strat_keys.append(0)

    audio_arr = np.stack(audio_feats)
    labels_arr = np.asarray(labels, dtype=np.int64)
    strat = np.asarray(strat_keys) if stratify_by else None
    video_arr = np.stack(video_feats) if use_video else None

    print(f"Audio feats shape: {audio_arr.shape}")
    if use_video:
        print(f"Video feats shape: {video_arr.shape}")
    print(f"Labels shape: {labels_arr.shape}")

    idx_train, idx_val, idx_test = stratified_two_stage_split(
        labels_arr, strat, val_size, test_size, random_state
    )

    def make(idx):
        out = {"audio": audio_arr[idx], "labels": labels_arr[idx]}
        if use_video:
            out["video"] = video_arr[idx]
        return out

    print(
        f"Train: {len(idx_train)}, Val: {len(idx_val)}, Test: {len(idx_test)}"
    )
    return make(idx_train), make(idx_val), make(idx_test)


def save_splits_to_disk(
    train_data: Dict[str, np.ndarray],
    val_data: Dict[str, np.ndarray],
    test_data: Dict[str, np.ndarray],
    out_root: str,
    modalities: Optional[List[str]] = None,
) -> None:
    """Write ``{split}/{modality}.npy`` + ``labels.npy`` (loader contract)."""
    root = Path(out_root)
    root.mkdir(parents=True, exist_ok=True)
    if modalities is None:
        modalities = [k for k in train_data if k != "labels"]
    for split_name, data in (
        ("train", train_data), ("val", val_data), ("test", test_data)
    ):
        split_dir = root / split_name
        split_dir.mkdir(parents=True, exist_ok=True)
        for m in modalities:
            if m not in data:
                raise KeyError(f"Modality '{m}' missing from {split_name}")
            np.save(split_dir / f"{m}.npy", data[m])
        np.save(split_dir / "labels.npy", data["labels"])
    print(f"Saved preprocessed data to: {root}")


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Preprocess RAVDESS (raw audio + grayscale frames)."
    )
    parser.add_argument("--audio_root", type=str, required=True)
    parser.add_argument("--video_root", type=str, default=None)
    parser.add_argument("--out_root", type=str, required=True)
    parser.add_argument("--val_size", type=float, default=0.15)
    parser.add_argument("--test_size", type=float, default=0.15)
    parser.add_argument("--no_video", action="store_true")
    parser.add_argument("--no_stratify", action="store_true")
    args = parser.parse_args(argv)

    use_video = not args.no_video
    train_data, val_data, test_data = build_ravdess_multimodal_raw(
        audio_root=args.audio_root,
        video_root=args.video_root,
        use_video=use_video,
        val_size=args.val_size,
        test_size=args.test_size,
        stratify_by=None if args.no_stratify else "emotion",
    )
    save_splits_to_disk(
        train_data, val_data, test_data, args.out_root,
        modalities=["audio", "video"] if use_video else ["audio"],
    )
    print("RAVDESS raw preprocessing complete.")


if __name__ == "__main__":
    main()
