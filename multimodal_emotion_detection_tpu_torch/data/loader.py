"""Batches over a split (on-disk or synthetic): the device-resident
training path, the host-streaming one and in-order evaluation.

* **Device-resident** (``dataset.device_resident``, the default): the whole
  split is placed on the device once (``device_arrays``); each step gathers
  its batch there with ``index_select`` by a (B,) index row of
  ``epoch_batch_indices``, so steady-state training copies no features
  from the host.
* **Host streaming** (``device_resident=false``, for splits larger than
  the card): ``stream`` gathers each batch of an epoch on the host in the
  same order and copies it to the device when it is asked for, from pinned
  memory without waiting on the card; the split is never placed whole.
* **Host iteration** (``__iter__``, the predict CLI): in-order batches,
  each copied to the device.

Batch order is the JAX package's, index for index: an epoch-seeded
permutation ``RandomState((seed * 1_000_003 + epoch) % 2**31)`` when
shuffling, the trailing partial batch padded by wrapping the order round
cyclically, and ``epoch_batch_valid`` marking the padding rows with 0.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from multimodal_emotion_detection_tpu_torch.data.dataset import (
    ArrayDataset,
    MultimodalArrays,
)
from multimodal_emotion_detection_tpu_torch.data.synthetic import synthetic_split

Batch = Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]


class MultimodalLoader:
    """Fixed-size batches over one split; features on ``device``."""

    def __init__(self, arrays: MultimodalArrays, batch_size: int,
                 shuffle: bool = False, seed: int = 42,
                 device: torch.device = torch.device("cpu"),
                 device_resident: bool = True):
        self.arrays = arrays
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.device = torch.device(device)
        self.device_resident = bool(device_resident)
        self.frontend_cached = False
        self._device_arrays: Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor]] = None

    def __len__(self) -> int:
        return math.ceil(len(self.arrays) / self.batch_size)

    @property
    def num_samples(self) -> int:
        return len(self.arrays)

    def replace_features(self, name: str, values: np.ndarray) -> None:
        """Swap one modality's host array (e.g. for cached frontend
        features); the device copy is placed anew on next use."""
        self.arrays.features[name] = values
        self._device_arrays = None

    def device_arrays(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The whole split on ``device``, placed once: features float32,
        labels int64."""
        if self._device_arrays is None:
            features = {name: torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
                        for name, arr in self.arrays.features.items()}
            labels = torch.from_numpy(self.arrays.labels.astype(np.int64)).to(self.device)
            self._device_arrays = (features, labels)
        return self._device_arrays

    def epoch_batch_indices(self, epoch: int = 0) -> np.ndarray:
        """(num_batches, batch_size) int32 row indices for one epoch."""
        n = len(self.arrays)
        if self.shuffle:
            rng = np.random.RandomState((self.seed * 1_000_003 + epoch) % (2**31))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        num_batches = len(self)
        total = num_batches * self.batch_size
        if total > n:
            # cyclic wrap (handles splits smaller than one batch too);
            # epoch_batch_valid() zeroes positions >= n either way
            order = np.resize(order, total)
        else:
            order = order[:total]
        return order.reshape(num_batches, self.batch_size).astype(np.int32)

    def epoch_batch_valid(self) -> np.ndarray:
        """(num_batches, batch_size) 1.0 for real rows, 0.0 for wrap-padding."""
        n = len(self.arrays)
        num_batches = len(self)
        valid = np.ones((num_batches * self.batch_size,), dtype=np.float32)
        if num_batches * self.batch_size > n:
            valid[n:] = 0.0
        return valid.reshape(num_batches, self.batch_size)

    def stream(self, epoch: int) -> Iterator[Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
        """``(features, labels)`` per batch of ``epoch``, in
        ``epoch_batch_indices``' order (wrap-padded), each gathered on the
        host and copied to ``device`` when it is asked for: features
        float32, labels int64.  To a CUDA card the copy leaves from pinned
        memory and does not wait for it (the pinned block is not reused
        before its copy has run)."""
        pin = self.device.type == "cuda"

        def put(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.pin_memory().to(self.device, non_blocking=True) if pin else t

        for idx in self.epoch_batch_indices(epoch):
            yield ({name: put(arr[idx]) for name, arr in self.arrays.features.items()},
                   put(self.arrays.labels[idx].astype(np.int64)))

    def __iter__(self) -> Iterator[Batch]:
        """In-order ``(features, labels, mask)`` batches of epoch 0:
        features and mask on ``device``, labels on the CPU; the mask is 1
        for every modality of a real row and 0 on padding rows."""
        valid = self.epoch_batch_valid()
        m = self.arrays.num_modalities
        for b, idx in enumerate(self.epoch_batch_indices(0)):
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


SYNTHETIC_KEYS = ("num_samples", "num_samples_eval", "num_classes",
                  "modality_dim", "sequence_length")


def create_dataloaders(
    dataset_name: str,
    data_dir: str,
    modalities: List[str],
    batch_size: int = 32,
    num_workers: int = 4,  # schema parity: no host worker processes
    seed: int = 42,
    device_resident: bool = True,
    mmap: bool = False,
    device: torch.device = torch.device("cpu"),
    **synthetic,
) -> Tuple[MultimodalLoader, MultimodalLoader, MultimodalLoader]:
    """Train (shuffled by ``seed`` and epoch), val and test loaders.

    ``dataset_name == 'synthetic'`` makes the splits with
    ``synthetic_split`` (``synthetic`` takes its ``SYNTHETIC_KEYS``);
    anything else reads the on-disk ``.npy`` layout.  Modality dropout
    belongs to the train step."""
    if num_workers not in (0, 4):  # 4 == reference default (schema parity)
        print(
            f"[data] num_workers={num_workers} accepted for config-schema "
            "parity but has no effect: batches are gathered on-device from "
            "the HBM-resident split (no host worker processes)."
        )
    if dataset_name == "synthetic":
        splits = {split: synthetic_split(split, list(modalities), seed, **synthetic)
                  for split in ("train", "val", "test")}
    else:
        splits = {split: ArrayDataset(data_dir, modalities, split, mmap=mmap).arrays
                  for split in ("train", "val", "test")}
    kw = dict(seed=seed, device=device, device_resident=device_resident)
    train = MultimodalLoader(splits["train"], batch_size, shuffle=True, **kw)
    val = MultimodalLoader(splits["val"], batch_size, **kw)
    test = MultimodalLoader(splits["test"], batch_size, **kw)
    return train, val, test
