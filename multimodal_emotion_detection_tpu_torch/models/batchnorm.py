"""BatchNorm with the JAX package's semantics (``flax.linen.BatchNorm``).

Flax and torch differ in two ways that change the numbers, so the port
does not use ``nn.BatchNorm1d``:

* the batch variance is the biased one, ``mean((x - mean(x))^2)``; it
  normalises the batch and feeds the running average alike (torch feeds
  the unbiased variance).  Flax forms the same variance as ``mean(x^2) -
  mean(x)^2`` (``use_fast_variance``); the two-pass form here drops that
  form's cancellation where |mean| is many times the spread, as on the
  log-mel CNN's first convolution (up to ~20x), where it costs float32
  digits in the statistics and the gradient;
* ``running = 0.99 * running + 0.01 * batch_stat`` (flax's momentum 0.99
  weighs the old value; torch's 0.1 weighs the new one).

The statistics reduce over every axis but the last (the features): (B, T)
for a (B, T, C) sequence, B for a (B, C) batch.  Every row counts,
wrap-padded rows too, as in the JAX train step.  The mode is an argument
of ``forward``, not ``self.training``: MC dropout runs a training-mode
forward on the running statistics.  ``state_dict`` holds exactly
``weight``, ``bias``, ``running_mean`` and ``running_var`` (flax's
``scale``, ``bias`` and ``batch_stats``' ``mean`` and ``var``).

A bf16 input takes flax's ``dtype=bfloat16`` form: the statistics come
from the input read into float32 (``_compute_stats`` promotes), the
normalisation runs in float32 against the float32 scale and bias, the
result is rounded to bf16 once, and the running statistics stay float32.
"""

from __future__ import annotations

import torch
from torch import nn


def use_running_average(training: bool, bn_eval) -> bool:
    """The JAX encoders' rule: ``bn_eval`` when given, else eval mode."""
    return (not training) if bn_eval is None else bool(bn_eval)


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, use_running_average: bool) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return self._normalise(x.to(torch.float32), use_running_average).to(x.dtype)
        return self._normalise(x, use_running_average)

    def _normalise(self, x: torch.Tensor, use_running_average: bool) -> torch.Tensor:
        if use_running_average:
            centred, var = x - self.running_mean, self.running_var
        else:
            dims = tuple(range(x.ndim - 1))
            mean = x.mean(dim=dims)
            centred = x - mean
            var = (centred * centred).mean(dim=dims)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return centred * (torch.rsqrt(var + self.epsilon) * self.weight) + self.bias
