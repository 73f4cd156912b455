"""Ensemble uncertainty over members of one architecture.

The JAX package stacks N parameter trees and maps one forward over them.
The port's kernel launches cannot be batched by ``torch.func.vmap``, and
members with different weights cannot share a launch, so the members run
one after another; the mean probabilities and the across-member variance
are the same.  A port ``state_dict`` holds parameters and buffers alike, so
one stacked dict stands for the JAX package's parameters and model state.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.training.steps import forward


def stack_params(param_sets: Sequence[Mapping[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """N state dicts with the same keys -> one, each tensor stacked along a
    new leading axis."""
    return {k: torch.stack([p[k] for p in param_sets]) for k in param_sets[0]}


def ensemble_predict(
    model: nn.Module,
    stacked_params: Mapping[str, torch.Tensor],
    features: Dict[str, torch.Tensor],
    num_modalities: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(mean softmax probs (B, C), uncertainty (B,))``:
    uncertainty is the across-member population variance of the
    probabilities, averaged over classes (the reference's definition).
    Each member is ``model``'s architecture with its slice of
    ``stacked_params``, run as the inference forward with every modality
    available; ``model`` itself is not changed."""
    m = num_modalities if num_modalities is not None else len(features)
    lead = next(iter(features.values()))
    mask = torch.ones((lead.shape[0], m), dtype=torch.float32, device=lead.device)
    member = copy.deepcopy(model)
    n = next(iter(stacked_params.values())).shape[0]
    probs = []
    for i in range(n):
        member.load_state_dict({k: v[i] for k, v in stacked_params.items()})
        logits = forward(member, features, mask)
        probs.append(torch.softmax(logits.to(torch.float32), dim=-1))
    probs = torch.stack(probs)  # (N, B, C)
    return probs.mean(dim=0), probs.var(dim=0, unbiased=False).mean(dim=-1)


def ensemble_predict_list(
    model: nn.Module,
    param_sets: List[Mapping[str, torch.Tensor]],
    features: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ensemble_predict`` over a list of state dicts."""
    return ensemble_predict(model, stack_params(param_sets), features)
