"""Generic manifest-driven ETL: any dataset -> ``{split}/{modality}.npy``.

The dataset-agnostic side of the array data model (the reference's
data.py:19-122 is likewise dataset-agnostic at load time): the loader
consumes whatever the RAVDESS recipe (``data/ravdess.py``) writes, and this
module writes the same layout from a CSV *manifest* instead of RAVDESS's
filename encoding: the shape of IEMOCAP-style corpora (sessions of
utterances with a label file, audio plus precomputed per-utterance feature
tracks).  The JAX package's ``data/manifest.py``, whose arrays and files
these are bit for bit.

Manifest format (CSV with a header):

    label,strat_key,audio,mocap,...
    3,Ses01,clips/a1.wav,feats/a1.npy,...

* ``label``      - integer class id (required)
* ``strat_key``  - stratification key for the split (optional column;
                   defaults to the label, the reference's
                   ``stratify_by='emotion'`` behavior)
* every other column is a modality: a path to a ``.wav`` (decoded through
  the same resample / pad / peak-normalize pipeline as RAVDESS,
  ``utils/wav.py::load_audio``) or a ``.npy`` of per-utterance features,
  padded / truncated on axis 0 to the modality's fixed length.

Splits reuse ``stratified_two_stage_split`` and ``save_splits_to_disk``
from the RAVDESS recipe, so a manifest dataset trains with
``dataset.data_dir=<out_root>`` exactly like RAVDESS does.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from multimodal_emotion_detection_tpu_torch.data.ravdess import (
    load_raw_audio,
    save_splits_to_disk,
    stratified_two_stage_split,
)


def read_manifest(path: str | Path) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"Empty manifest: {path}")
    if "label" not in rows[0]:
        raise ValueError(
            f"Manifest {path} needs a 'label' column; has {list(rows[0])}"
        )
    return rows


def _load_modality(
    path: Path, target_len: int, sample_rate: int, audio_seconds: float
) -> np.ndarray:
    if path.suffix.lower() == ".wav":
        # same contract as RAVDESS audio: resample -> truncate/zero-pad to
        # the fixed duration -> peak-normalize -> (T, 1) float32
        return load_raw_audio(path, sr=sample_rate,
                              max_duration=audio_seconds)
    feats = np.load(path).astype(np.float32)
    if feats.ndim == 1:
        feats = feats[:, None]
    t = feats.shape[0]
    if t >= target_len:
        return feats[:target_len]
    pad = np.zeros((target_len - t,) + feats.shape[1:], np.float32)
    return np.concatenate([feats, pad], axis=0)


def build_manifest_multimodal(
    manifest_path: str | Path,
    out_root: str | Path,
    modalities: Optional[Sequence[str]] = None,
    sample_rate: int = 16000,
    audio_seconds: float = 3.0,
    feature_len: int = 100,
    val_size: float = 0.15,
    test_size: float = 0.15,
    random_state: int = 42,
) -> Dict[str, Dict[str, np.ndarray]]:
    """ETL a manifest into the on-disk split layout; returns the splits."""
    rows = read_manifest(manifest_path)
    root = Path(manifest_path).parent
    if modalities is None:
        modalities = [
            c for c in rows[0] if c not in ("label", "strat_key")
        ]

    labels = np.array([int(r["label"]) for r in rows])
    strat = (
        np.array([r["strat_key"] for r in rows])
        if "strat_key" in rows[0]
        else labels
    )
    features: Dict[str, np.ndarray] = {}
    for mod in modalities:
        stacked = []
        for r in rows:
            p = root / r[mod]
            if not p.exists():
                raise FileNotFoundError(f"{mod} file not found: {p}")
            stacked.append(
                _load_modality(p, feature_len, sample_rate, audio_seconds)
            )
        shapes = {a.shape for a in stacked}
        if len(shapes) != 1:
            raise ValueError(
                f"Modality '{mod}' rows disagree on shape: {shapes} — fixed"
                " shapes are required (pad or re-extract)"
            )
        features[mod] = np.stack(stacked)

    idx_tr, idx_val, idx_test = stratified_two_stage_split(
        labels, strat, val_size, test_size, random_state
    )

    def split(idx):
        return {
            **{m: a[idx] for m, a in features.items()},
            "labels": labels[idx],
        }

    train, val, test = split(idx_tr), split(idx_val), split(idx_test)
    save_splits_to_disk(train, val, test, Path(out_root),
                        modalities=list(modalities))
    return {"train": train, "val": val, "test": test}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--out_root", required=True)
    ap.add_argument("--modalities", nargs="*", default=None)
    ap.add_argument("--sample_rate", type=int, default=16000)
    ap.add_argument("--audio_seconds", type=float, default=3.0)
    ap.add_argument("--feature_len", type=int, default=100)
    ap.add_argument("--val_size", type=float, default=0.15)
    ap.add_argument("--test_size", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    splits = build_manifest_multimodal(
        args.manifest, args.out_root, args.modalities,
        sample_rate=args.sample_rate, audio_seconds=args.audio_seconds,
        feature_len=args.feature_len, val_size=args.val_size,
        test_size=args.test_size, random_state=args.seed,
    )
    for name, data in splits.items():
        print(f"{name}: {len(data['labels'])} rows")
    print(f"Saved manifest dataset to: {args.out_root}")


if __name__ == "__main__":
    main()
