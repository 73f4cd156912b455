"""Optimizers and learning-rate schedules, with the JAX package's (optax)
semantics.

* ``lr_schedule``: 'none' | 'cosine' (T_max = max_epochs, eta_min =
  lr/100) | 'step' (``scheduler_step_size`` epochs, ``scheduler_gamma``) |
  'warmup_cosine' (optax's ``warmup_cosine_decay_schedule``: linear from 0
  over ``warmup_steps``, then cosine to lr/100 at max_epochs), all but the
  last at per-epoch granularity, as a pure function of the global step.
  The optimizer reads the schedule at the step count BEFORE the update, as
  optax does (so warmup_cosine gives lr 0 at step 0): the train step sets
  ``group["lr"] = schedule(step)`` before each ``optimizer.step()``.
* ``build_optimizer``: AdamW (decoupled weight decay on every parameter,
  biases and LayerNorm included, as ``optax.adamw``) or Adam (weight decay
  as L2 folded into the gradient before the moments), one parameter group.
* ``clip_by_global_norm``: optax's rule, ``g * max_norm / norm`` when
  ``norm >= max_norm``, with no epsilon.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Tuple

import torch


def lr_schedule(training_cfg, steps_per_epoch: int) -> Callable[[int], float]:
    base_lr = float(training_cfg.learning_rate)
    kind = training_cfg.scheduler
    max_epochs = int(training_cfg.max_epochs)
    spe = max(1, int(steps_per_epoch))

    if kind == "none":
        return lambda step: base_lr

    if kind == "cosine":
        eta_min = base_lr / 100.0

        def cosine(step: int) -> float:
            epoch = min(step // spe, max_epochs)
            return eta_min + 0.5 * (base_lr - eta_min) * (
                1.0 + math.cos(math.pi * epoch / max_epochs))

        return cosine

    if kind == "step":
        size = int(training_cfg.scheduler_step_size)
        gamma = float(training_cfg.scheduler_gamma)
        return lambda step: base_lr * (gamma ** ((step // spe) // size))

    if kind == "warmup_cosine":
        warmup = max(1, int(training_cfg.warmup_steps))
        decay = max(max_epochs * spe, warmup + 1) - warmup
        alpha = 1.0 / 100.0  # end value lr/100 over peak lr

        def warmup_cosine(step: int) -> float:
            if step < warmup:
                return base_lr * step / warmup
            count = min(step - warmup, decay)
            cos = 0.5 * (1.0 + math.cos(math.pi * count / decay))
            return base_lr * ((1.0 - alpha) * cos + alpha)

        return warmup_cosine

    raise ValueError(f"Unknown scheduler: {kind}")


def build_optimizer(training_cfg, params: Iterable[torch.nn.Parameter],
                    steps_per_epoch: int
                    ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    schedule = lr_schedule(training_cfg, steps_per_epoch)
    wd = float(training_cfg.weight_decay)
    params = list(params)
    if training_cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=wd)
    elif training_cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=wd)
    else:
        raise ValueError(f"Unknown optimizer: {training_cfg.optimizer}")
    return opt, schedule


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place so their global L2 norm is at most
    ``max_norm``, on the device without a host round trip.  The norms sum
    in float64: the CPU's float32 reduction is off by ~3e-5 relative on a
    2M-element gradient, which moves every clipped gradient by as much."""
    norms = torch._foreach_norm(grads, 2, dtype=torch.float64)
    norm = torch.linalg.vector_norm(torch.stack(norms))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))
