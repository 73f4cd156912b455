"""Stacked LSTM for the final-hidden serving path.

The parameter layout matches the JAX package's ``_CellParams`` /
``FusedStackedRNN``: ``layer_<l>.{w_ih (D, 4H), w_hh (H, 4H), b (4H,)}``,
gate order i, f, g, o, so a JAX checkpoint maps onto it key for key.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import lstm2_infer


class _CellParams(nn.Module):
    """One LSTM layer's parameters, in the JAX layout."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(in_dim, 4 * hidden_dim))
        self.w_hh = nn.Parameter(torch.empty(hidden_dim, 4 * hidden_dim))
        self.b = nn.Parameter(torch.empty(4 * hidden_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """U(-1/sqrt(H), 1/sqrt(H)) for every tensor, as the JAX init."""
        k = 1.0 / math.sqrt(self.w_hh.shape[0])
        for p in (self.w_ih, self.w_hh, self.b):
            nn.init.uniform_(p, -k, k, generator=generator)

    def as_dict(self):
        return {"w_ih": self.w_ih, "w_hh": self.w_hh, "b": self.b}


class FusedStackedRNN(nn.Module):
    """Deterministic 2-layer LSTM returning the last layer's final hidden
    state (B, H).

    The forward is ``ops.lstm_kernel.lstm2_infer``: the hand-written
    kernel on the card, its plain version on the CPU.  Inference only —
    dropout between the layers is the identity here.
    """

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2):
        super().__init__()
        if num_layers != 2:
            raise NotImplementedError(
                f"FusedStackedRNN with num_layers={num_layers}: only the "
                "2-layer LSTM is ported (ROADMAP.md Queue 1 item 3)"
            )
        self.layer_0 = _CellParams(in_dim, hidden_dim)
        self.layer_1 = _CellParams(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lstm2_infer(x, self.layer_0.as_dict(), self.layer_1.as_dict())
