"""Stacked LSTM, final hidden state: serving and training.

The parameter layout matches the JAX package's ``_CellParams`` /
``FusedStackedRNN``: ``layer_<l>.{w_ih (D, 4H), w_hh (H, 4H), b (4H,)}``,
gate order i, f, g, o, so a JAX checkpoint maps onto it key for key.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.models.noise import Noise, keep_mask
from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import lstm2_infer
from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import fused_lstm_final


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
    """2-layer LSTM returning the last layer's final hidden state (B, H).

    In eval mode the forward is ``ops.lstm_kernel.lstm2_infer``.  In
    training mode it is ``ops.lstm_vjp.fused_lstm_final`` (training forward
    and reverse-chain kernels), with dropout between the layers: a keep
    mask Bernoulli(1 - dropout) / (1 - dropout) of shape (T, B, H) drawn
    from ``noise`` (all ones at dropout 0).  Each op is the hand-written
    kernel on the card and its plain version on the CPU.
    """

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 dropout: float = 0.0):
        super().__init__()
        if num_layers != 2:
            raise NotImplementedError(
                f"FusedStackedRNN with num_layers={num_layers}: only the "
                "2-layer LSTM is ported (ROADMAP.md Queue 1 item 3)"
            )
        self.dropout = float(dropout)
        self.layer_0 = _CellParams(in_dim, hidden_dim)
        self.layer_1 = _CellParams(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor, noise: Optional[Noise] = None) -> torch.Tensor:
        layer0, layer1 = self.layer_0.as_dict(), self.layer_1.as_dict()
        if not self.training:
            return lstm2_infer(x, layer0, layer1)
        shape = (x.shape[1], x.shape[0], self.layer_0.w_hh.shape[0])
        keep = keep_mask(noise, shape, self.dropout, x.device)
        return fused_lstm_final(x, keep, layer0, layer1)
