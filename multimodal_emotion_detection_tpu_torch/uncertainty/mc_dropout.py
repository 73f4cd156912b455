"""MC-dropout uncertainty as one forward over S x B rows.

The JAX package maps one jitted forward over S dropout keys, one program
at S·B rows.  Here the S samples fold into the batch: the inputs repeat S
times (row s·B + b is sample s of clip b) and one training-mode forward
under ``torch.no_grad()`` draws every dropout mask from one ``Noise``, so
each sample of a clip sees its own masks.  The audio frontend runs inside
the fold, on all S·B rows at once; it has no randomness, so its S copies
are equal.

The rule is the JAX package's (``deterministic=False, bn_eval=True``):
dropout on, and every BatchNorm normalises with its running statistics
and leaves them as they were.  That is also what makes the fold legal:
batch statistics over S·B rows would be another function than S forwards
over B rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.models.noise import Noise


def mc_dropout_predict(
    model: nn.Module,
    features: Dict[str, torch.Tensor],
    num_samples: int = 10,
    noise: Optional[Noise] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(mean_logits (B, C), uncertainty (B,))``.

    ``uncertainty`` is the across-sample population variance of the
    softmax probabilities, averaged over classes (the reference's
    definition).  ``noise`` defaults to a generator seeded with 0 on the
    features' device.  ``mask`` (B, M) marks the modalities present; None
    means all (a caller simulating missing modalities passes the rewritten
    mask, or a mask-aware fusion takes the zeroed inputs as valid).
    """
    if num_samples < 1:
        raise ValueError(f"num_samples must be at least 1, got {num_samples}")
    lead = next(iter(features.values()))
    b, device = lead.shape[0], lead.device
    if mask is None:
        mask = torch.ones((b, len(features)), dtype=torch.float32, device=device)
    if noise is None:
        noise = Noise(torch.Generator(device=device).manual_seed(0))

    def fold(x: torch.Tensor) -> torch.Tensor:
        return x.repeat((num_samples,) + (1,) * (x.ndim - 1))

    was_training = model.training
    model.train()
    try:
        with torch.no_grad():
            logits = model({k: fold(v) for k, v in features.items()}, fold(mask),
                           noise=noise, bn_eval=True)
    finally:
        model.train(was_training)
    logits = logits.reshape(num_samples, b, -1)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    uncertainty = probs.var(dim=0, unbiased=False).mean(dim=-1)
    # the mean over the samples sums in float32, as jnp.mean does for bf16
    return logits.float().mean(dim=0).to(logits.dtype), uncertainty
