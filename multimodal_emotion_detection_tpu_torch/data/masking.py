"""Modality availability masks: dropout for training, missing-modality
simulation for robustness evaluation."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def modality_dropout_mask(generator: torch.Generator, batch_size: int,
                          num_modalities: int, dropout_prob: float,
                          device: torch.device) -> torch.Tensor:
    """(B, M) float mask, 1 = available, each modality dropped with
    probability ``dropout_prob``; a row that drops every modality gets one
    uniformly chosen modality back, so every row keeps at least one.
    Drawn from ``generator`` on ``device``."""
    if dropout_prob <= 0.0:
        return torch.ones((batch_size, num_modalities), dtype=torch.float32,
                          device=device)
    keep = torch.rand((batch_size, num_modalities), generator=generator,
                      device=device) >= dropout_prob
    fallback_idx = torch.randint(0, num_modalities, (batch_size,),
                                 generator=generator, device=device)
    fallback = torch.nn.functional.one_hot(fallback_idx, num_modalities).bool()
    all_dropped = ~keep.any(dim=-1, keepdim=True)
    return torch.where(all_dropped, fallback, keep).to(torch.float32)


def modality_dropout_mask_from_uniforms(uniforms: torch.Tensor,
                                        fallback_idx: torch.Tensor,
                                        dropout_prob: float) -> torch.Tensor:
    """``modality_dropout_mask``'s rule on draws already made: ``uniforms``
    (B, M) in [0, 1) and ``fallback_idx`` (B,) in [0, M).  A modality is
    kept where its uniform is >= ``dropout_prob``, so under the same draws
    a higher probability drops a superset (the sweep's members share one
    draw a step); at 0 every modality is kept."""
    keep = uniforms >= dropout_prob
    fallback = torch.nn.functional.one_hot(fallback_idx, uniforms.shape[-1]).bool()
    all_dropped = ~keep.any(dim=-1, keepdim=True)
    return torch.where(all_dropped, fallback, keep).to(torch.float32)


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
