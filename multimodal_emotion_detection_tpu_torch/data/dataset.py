"""Fixed-shape multimodal array datasets.

A split is a dict of dense, fixed-shape numpy arrays in the on-disk layout
the ETL writes: ``<data_dir>/<split>/{modality}.npy`` + ``labels.npy``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np


@dataclass
class MultimodalArrays:
    """One split: per-modality feature arrays + labels, row-aligned."""

    features: Dict[str, np.ndarray]  # each (N, ...) float32
    labels: np.ndarray  # (N,) int
    modalities: List[str]

    def __post_init__(self) -> None:
        n = len(self.labels)
        for name, arr in self.features.items():
            if arr.shape[0] != n:
                raise ValueError(
                    f"Modality '{name}' has {arr.shape[0]} rows, labels have {n}"
                )

    def __len__(self) -> int:
        return int(len(self.labels))

    @property
    def num_modalities(self) -> int:
        return len(self.modalities)


class ArrayDataset:
    """Loads the ``<data_dir>/<split>/{modality}.npy`` layout from disk.

    ``mmap=True`` memory-maps the files instead of reading them into host
    RAM (no copy when the ETL wrote float32).
    """

    def __init__(self, data_dir: str | Path, modalities: List[str],
                 split: str, mmap: bool = False):
        split_dir = Path(data_dir) / split
        mode = "r" if mmap else None
        features = {}
        for modality in modalities:
            path = split_dir / f"{modality}.npy"
            if not path.exists():
                raise FileNotFoundError(f"Modality file not found: {path}")
            arr = np.load(path, mmap_mode=mode)
            features[modality] = (
                arr if mmap and arr.dtype == np.float32
                else np.asarray(arr).astype(np.float32, copy=False)
            )
        labels_path = split_dir / "labels.npy"
        if not labels_path.exists():
            raise FileNotFoundError(f"Labels file not found: {labels_path}")
        labels = np.asarray(np.load(labels_path)).astype(np.int32, copy=False)
        self.arrays = MultimodalArrays(features, labels, list(modalities))
