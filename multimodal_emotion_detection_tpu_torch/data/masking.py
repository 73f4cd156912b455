"""Missing-modality simulation for robustness evaluation."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def simulate_missing_modalities(
    features: Dict[str, torch.Tensor],
    mask: torch.Tensor,
    missing_pattern: Optional[List[int]] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Zero out features for missing modalities and rewrite the mask.

    ``missing_pattern`` lists modality indices (in ``features`` order) to
    KEEP; the new mask is 1 exactly there.  None keeps ``mask``.
    """
    if missing_pattern is not None:
        mask = torch.zeros_like(mask)
        mask[..., list(missing_pattern)] = 1.0
    out = {}
    for i, (name, feat) in enumerate(features.items()):
        m = mask[..., i]
        out[name] = feat * m.reshape(m.shape + (1,) * (feat.ndim - m.ndim))
    return out, mask
