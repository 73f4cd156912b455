"""Post-hoc temperature scaling.

T is fitted on validation logits by a guarded Newton iteration on log T,
where the mean NLL is convex, in float32: from log T = 0, each step is
g / h (or g where the curvature |h| <= 1e-12), clipped to [-1, 1], for at
most ``max_iter`` steps, stopping once |g| < ``tol``; g and h are the first
and second derivatives from ``torch.autograd``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class TemperatureScaling:
    """P_calibrated = softmax(logits / T), T > 0 learned on validation NLL."""

    def __init__(self) -> None:
        self.temperature: float = 1.0

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        return logits / max(self.temperature, 1e-6)

    def calibrate(self, logits, labels, max_iter: int = 50,
                  tol: float = 1e-8) -> float:
        logits = torch.as_tensor(logits, dtype=torch.float32)
        labels = torch.as_tensor(labels).to(torch.int64)
        log_t = torch.zeros((), dtype=torch.float32)
        for _ in range(max_iter):
            x = log_t.clone().requires_grad_(True)
            nll = F.cross_entropy(logits / torch.exp(x), labels)
            (g,) = torch.autograd.grad(nll, x, create_graph=True)
            (h,) = torch.autograd.grad(g, x)
            g = g.detach()
            step = g / h if abs(float(h)) > 1e-12 else g
            log_t = log_t - step.clamp(-1.0, 1.0)
            if abs(float(g)) < tol:
                break
        self.temperature = float(torch.exp(log_t).clamp(1e-6, 1e6))
        return self.temperature
