"""The train step, the eval step's metric sums and the serving forward.

* ``train_step``: gather the batch on the device from the resident split,
  modality-dropout mask times the valid rows, forward in training mode,
  masked cross-entropy, backward, clip by global norm, optimizer update,
  and the step's metrics, all without a host round trip;
* ``eval_sums``: exact per-batch metric sums (so epoch means over uneven,
  wrap-padded batches are exact) plus the logits;
* ``forward``: the inference logits;
* ``make_batched_forward_fn``: the throughput-serving forward over S
  stacked microbatches.

A model with BatchNorm (the CNN and MLP encoders) normalises with the
batch statistics in ``train_step``, whose forward also moves the running
statistics (buffers: no gradient, no optimizer update, no clip), over
every row of the gathered batch, wrap padding included, as the JAX step
does; ``eval_sums`` and ``forward`` read them.

A classifier with library fusion returns its logits here too (a fusion's
auxiliary outputs come only with ``return_aux``), so the loss takes the
logits alone, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_emotion_detection_tpu_torch.data.masking import (
    modality_dropout_mask,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.training.optim import (
    clip_by_global_norm,
)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy (B,), in the logits' dtype, as the JAX step's
    ``optax.softmax_cross_entropy_with_integer_labels``: logsumexp(logits)
    - logits[label].  On float32 logits it is ``F.cross_entropy``.  On bf16
    logits ``F.cross_entropy`` would take the log-softmax in float32 and
    round once (on the CPU and on CUDA alike: both accumulate bf16 in
    float32), where optax's logsumexp runs in bf16, each op rounded: the
    max, exp(x - max), the sum (float32, rounded once, as ``jnp.sum``), the
    log and the sums.  So bf16 takes optax's ops one by one."""
    if logits.dtype != torch.bfloat16:
        return F.cross_entropy(logits, labels, reduction="none")
    top = logits.amax(dim=-1, keepdim=True).detach()
    sumexp = torch.exp(logits - top).float().sum(dim=-1).to(logits.dtype)
    return (torch.log(sumexp) + top[:, 0]) - logits.gather(-1, labels[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """sum(ce * valid) / max(sum(valid), 1): padding rows weigh nothing; a
    bf16 ce is weighed in float32, as the JAX step's."""
    ce = softmax_cross_entropy(logits, labels)
    return (ce * valid).sum() / valid.sum().clamp(min=1.0)


def batch_metrics(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    denom = valid.sum().clamp(min=1.0)
    acc = ((logits.argmax(dim=-1) == labels) * valid).sum() / denom
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    conf = (probs.amax(dim=-1) * valid).sum() / denom
    ent = (-(probs * torch.log(probs.clamp(min=1e-12))).sum(dim=-1) * valid
           ).sum() / denom
    return {"acc": acc, "confidence_mean": conf, "entropy": ent}


def optimizer_update(optimizer: torch.optim.Optimizer, lr: float,
                     clip_norm: float) -> None:
    """Apply the gradients in ``.grad``: clip by global norm (``clip_norm >
    0``), then one optimizer step at learning rate ``lr``.  A parameter
    without a gradient gets a zero one, so weight decay and the moments
    still move it, as in optax."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if clip_norm > 0:
        clip_by_global_norm([p.grad for p in params], clip_norm)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


def train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    features: Dict[str, torch.Tensor],
    labels: torch.Tensor,
    idx: torch.Tensor,
    valid: torch.Tensor,
    *,
    lr: float,
    clip_norm: float,
    modality_dropout: float,
    noise: Noise,
) -> Dict[str, torch.Tensor]:
    """One update on the batch ``idx`` (B,) of the resident split
    ``features`` / ``labels``; ``valid`` (B,) marks real rows.  Returns the
    step's metrics as 0-d tensors on the device (loss, acc,
    confidence_mean, entropy, count)."""
    batch = {m: a.index_select(0, idx) for m, a in features.items()}
    batch_labels = labels.index_select(0, idx)
    b, device = idx.shape[0], valid.device
    mask = noise.draw(
        lambda g: modality_dropout_mask(g, b, len(model.modalities),
                                        modality_dropout, device), device)
    mask = mask * valid[:, None]

    model.train()
    logits = model(batch, mask, noise=noise)
    loss = cross_entropy(logits, batch_labels, valid)
    optimizer.zero_grad()
    loss.backward()
    optimizer_update(optimizer, lr, clip_norm)
    with torch.no_grad():
        logits = logits.detach()
        return {"loss": loss.detach(),
                **batch_metrics(logits, batch_labels, valid),
                "count": valid.sum()}


def eval_sums(
    model: nn.Module,
    features: Dict[str, torch.Tensor],
    labels: torch.Tensor,
    idx: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Metric sums over the valid rows of batch ``idx``: loss_sum,
    correct_sum, conf_sum, entropy_sum, count; plus (logits, labels)."""
    batch = {m: a.index_select(0, idx) for m, a in features.items()}
    batch_labels = labels.index_select(0, idx)
    mask = torch.ones((idx.shape[0], len(model.modalities)),
                      dtype=torch.float32, device=valid.device) * valid[:, None]
    model.eval()
    with torch.inference_mode():
        logits = model(batch, mask)
        ce = softmax_cross_entropy(logits, batch_labels)
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        ent = -(probs * torch.log(probs.clamp(min=1e-12))).sum(dim=-1)
        sums = {
            "loss_sum": (ce * valid).sum(),
            "correct_sum": ((logits.argmax(dim=-1) == batch_labels) * valid).sum(),
            "conf_sum": (probs.amax(dim=-1) * valid).sum(),
            "entropy_sum": (ent * valid).sum(),
            "count": valid.sum(),
        }
    return sums, logits, batch_labels


def forward(
    model: nn.Module,
    features: Dict[str, torch.Tensor],
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inference logits (B, C), in the model's compute dtype: dropout off,
    no autograd graph.

    ``mask`` (B, M) defaults to every modality available.
    """
    if mask is None:
        lead = next(iter(features.values()))
        mask = torch.ones((lead.shape[0], len(model.modalities)),
                          dtype=torch.float32, device=lead.device)
    model.eval()
    with torch.inference_mode():
        return model(features, mask)


def make_batched_forward_fn(model: nn.Module) -> Callable:
    """Throughput-serving forward over S microbatches.

    ``forward_many(features[, mask]) -> (S, B, C)`` logits, where every
    ``features`` value is stacked (S, B, ...) and ``mask`` (S, B, M)
    defaults to every modality available.  Each microbatch takes one
    deterministic ``forward`` under ``torch.inference_mode``, in order, so
    activations peak at one microbatch's and each microbatch's logits are
    ``forward``'s bit for bit (the JAX package scans the same body over the
    stacked axis in one dispatch; capture of the loop is not ported).
    """

    def forward_many(features: Dict[str, torch.Tensor],
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = next(iter(features.values())).shape[0]
        with torch.inference_mode():
            return torch.stack([
                forward(model, {m: f[i] for m, f in features.items()},
                        None if mask is None else mask[i])
                for i in range(s)])

    return forward_many
