"""Evaluation batches over one on-disk split.

``MultimodalLoader`` walks a split in order in fixed-size batches.  The
trailing partial batch is padded by wrapping indices round to the start,
so every batch has the same shape, and the availability mask zeroes the
padding rows (a row with an all-zero mask is not a real sample).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from multimodal_emotion_detection_tpu_torch.data.dataset import (
    ArrayDataset,
    MultimodalArrays,
)

Batch = Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]


class MultimodalLoader:
    """Iterates ``(features, labels, mask)`` batches over one split, in
    order; features and mask on ``device``, labels on the CPU.

    Evaluation only: no shuffling and no modality dropout (both belong to
    training, ROADMAP.md Queue 1 item 5).
    """

    def __init__(self, arrays: MultimodalArrays, batch_size: int,
                 device: torch.device = torch.device("cpu")):
        self.arrays = arrays
        self.batch_size = int(batch_size)
        self.device = torch.device(device)

    def __len__(self) -> int:
        return math.ceil(len(self.arrays) / self.batch_size)

    @property
    def num_samples(self) -> int:
        return len(self.arrays)

    def batch_indices(self) -> np.ndarray:
        """(num_batches, batch_size) row indices; the tail wraps round."""
        total = len(self) * self.batch_size
        order = np.resize(np.arange(len(self.arrays)), total)
        return order.reshape(len(self), self.batch_size)

    def batch_valid(self) -> np.ndarray:
        """(num_batches, batch_size) 1.0 for real rows, 0.0 for padding."""
        valid = np.zeros(len(self) * self.batch_size, dtype=np.float32)
        valid[: len(self.arrays)] = 1.0
        return valid.reshape(len(self), self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        valid = self.batch_valid()
        m = self.arrays.num_modalities
        for b, idx in enumerate(self.batch_indices()):
            features = {
                name: torch.from_numpy(np.ascontiguousarray(arr[idx])).to(self.device)
                for name, arr in self.arrays.features.items()
            }
            # labels only feed host-side metrics: they stay on the CPU
            labels = torch.from_numpy(self.arrays.labels[idx].astype(np.int32))
            mask = torch.from_numpy(
                np.repeat(valid[b][:, None], m, axis=1)).to(self.device)
            yield features, labels, mask


def create_eval_loader(data_dir: str, modalities: List[str], split: str,
                       batch_size: int = 32, mmap: bool = False,
                       device: torch.device = torch.device("cpu")) -> MultimodalLoader:
    """Loader over one on-disk split (``<data_dir>/<split>/*.npy``); only
    that split is read."""
    arrays = ArrayDataset(data_dir, modalities, split, mmap=mmap).arrays
    return MultimodalLoader(arrays, batch_size, device=device)
