"""Synthetic multimodal dataset: the repo's fast test fixture.

Gaussian sequences of shape (N, sequence_length, dim) per modality and
uniform random labels, from a numpy ``RandomState`` seeded with the seed
plus a split offset (train 0, val 1, test 2), so the splits are distinct,
reproducible and identical, array for array, to the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from multimodal_emotion_detection_tpu_torch.data.dataset import MultimodalArrays

_SPLIT_OFFSETS = {"train": 0, "val": 1, "test": 2}


def synthetic_arrays(
    num_samples: int = 10000,
    num_classes: int = 5,
    modality_dims: Dict[str, int] | None = None,
    sequence_length: int = 100,
    split: str = "train",
    seed: int = 42,
) -> MultimodalArrays:
    if modality_dims is None:
        modality_dims = {"sensor1": 32, "sensor2": 32, "sensor3": 32}
    rng = np.random.RandomState(seed + _SPLIT_OFFSETS.get(split, 0))
    features = {
        modality: rng.randn(num_samples, sequence_length, dim).astype(np.float32)
        for modality, dim in modality_dims.items()
    }
    labels = rng.randint(0, num_classes, num_samples).astype(np.int32)
    return MultimodalArrays(features, labels, list(modality_dims.keys()))


def synthetic_split(split: str, modalities: List[str], seed: int = 42,
                    num_samples: int = 10000, num_samples_eval: int = 2000,
                    num_classes: int = 5, modality_dim: int = 32,
                    sequence_length: int = 100) -> MultimodalArrays:
    """One split sized as the JAX ``create_dataloaders`` sizes it: train
    ``num_samples`` rows, val and test ``num_samples_eval // 5`` each;
    ``modality_dim`` features for every modality."""
    n = num_samples if split == "train" else num_samples_eval // 5
    return synthetic_arrays(n, num_classes, {m: modality_dim for m in modalities},
                            sequence_length, split, seed)
