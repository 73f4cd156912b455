"""The serving forward."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


def forward(
    model: nn.Module,
    features: Dict[str, torch.Tensor],
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inference logits (B, C): dropout off, no autograd graph.

    ``mask`` (B, M) defaults to every modality available.
    """
    if mask is None:
        lead = next(iter(features.values()))
        mask = torch.ones((lead.shape[0], len(model.modalities)),
                          dtype=torch.float32, device=lead.device)
    model.eval()
    with torch.inference_mode():
        return model(features, mask)
