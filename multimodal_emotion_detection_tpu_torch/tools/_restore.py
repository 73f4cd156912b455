"""Checkpoint restore for the serving CLIs."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.data.loader import (
    MultimodalLoader,
    create_eval_loader,
)
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
)
from multimodal_emotion_detection_tpu_torch.training.checkpoints import (
    load_checkpoint,
)


def restore_for_eval(
    config, checkpoint: Path, split: str, device: torch.device
) -> Tuple[nn.Module, Dict[str, Any], MultimodalLoader]:
    """-> ``(model, meta, loader)``: the model built from ``config`` with
    the checkpoint's weights, on ``device`` in eval mode, and a loader over
    ``split`` alone (the on-disk layout; synthetic data is not ported)."""
    if config.dataset.name == "synthetic":
        raise NotImplementedError(
            "dataset.name=synthetic is not ported yet (ROADMAP.md Queue 1 "
            "item 5); point dataset.data_dir at an on-disk split"
        )
    loader = create_eval_loader(
        config.dataset.data_dir, list(config.dataset.modalities), split,
        batch_size=config.dataset.batch_size, mmap=config.dataset.mmap,
        device=device,
    )
    model = classifier_from_config(config)
    state_dict, meta = load_checkpoint(Path(checkpoint))
    model.load_state_dict(state_dict)
    return model.to(device).eval(), meta, loader
