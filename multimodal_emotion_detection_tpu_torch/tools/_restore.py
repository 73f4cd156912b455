"""Checkpoint restore for the serving CLIs."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.data.loader import (
    SYNTHETIC_KEYS,
    MultimodalLoader,
    create_eval_loader,
)
from multimodal_emotion_detection_tpu_torch.data.synthetic import synthetic_split
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.training.checkpoints import (
    load_checkpoint,
)


def restore_model(config, checkpoint: Path, device: torch.device
                  ) -> Tuple[nn.Module, Dict[str, Any]]:
    """-> ``(model, meta)``: the model built from ``config`` with the
    checkpoint's weights, on ``device`` in eval mode."""
    model = classifier_from_config(config)
    state_dict, meta = load_checkpoint(Path(checkpoint))
    model.load_state_dict(state_dict)
    return model.to(device).eval(), meta


def restore_for_eval(
    config, checkpoint: Path, split: str, device: torch.device
) -> Tuple[nn.Module, Dict[str, Any], MultimodalLoader]:
    """-> ``(model, meta, loader)``: ``restore_model``'s, and a loader over
    ``split`` alone: the on-disk layout, or with ``dataset.name=synthetic``
    the synthetic split the train CLI made from the same config."""
    ds = config.dataset
    if ds.name == "synthetic":
        arrays = synthetic_split(split, list(ds.modalities), config.seed,
                                 **{k: getattr(ds, k) for k in SYNTHETIC_KEYS})
        loader = MultimodalLoader(arrays, ds.batch_size, device=device)
    else:
        loader = create_eval_loader(ds.data_dir, list(ds.modalities), split,
                                    batch_size=ds.batch_size, mmap=ds.mmap,
                                    device=device)
    model, meta = restore_model(config, checkpoint, device)
    return model, meta, loader
