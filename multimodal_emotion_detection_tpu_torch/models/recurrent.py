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
from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import (
    lstm1_infer,
    lstm2_infer,
)
from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import (
    fused_lstm_final,
    lstm_route,
    sm_count,
)


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
    """L-layer LSTM (L >= 2) returning the top layer's final hidden state
    (B, H).

    ``ops.lstm_vjp.lstm_route`` picks the kernels: the 2-layer ones for 2
    layers of H up to twice the card's SM count, one layer per launch
    otherwise.  In eval mode the forward is ``lstm2_infer``, or per layer
    the input projection and ``lstm1_infer`` (the h series into the next
    layer, the final h out of the top one).  In training mode it is
    ``ops.lstm_vjp.fused_lstm_final``, with dropout between the layers: a
    keep mask Bernoulli(1 - dropout) / (1 - dropout) of shape
    (T, L-1, B, H), one draw per step, from ``noise`` (all ones at dropout
    0).  Each op is the hand-written kernel on the card and its plain
    version on the CPU.
    """

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 dropout: float = 0.0):
        super().__init__()
        if num_layers < 2:
            raise NotImplementedError(
                f"FusedStackedRNN with num_layers={num_layers}: a 1-layer "
                "LSTM (StackedRNN / LSTMLayer) is not ported yet (ROADMAP.md "
                "Queue 1 item 3)"
            )
        self.dropout = float(dropout)
        self.num_layers = num_layers
        for layer in range(num_layers):
            self.add_module(f"layer_{layer}", _CellParams(
                in_dim if layer == 0 else hidden_dim, hidden_dim))

    def forward(self, x: torch.Tensor, noise: Optional[Noise] = None) -> torch.Tensor:
        layers = [getattr(self, f"layer_{i}").as_dict()
                  for i in range(self.num_layers)]
        h_dim = layers[0]["w_hh"].shape[0]
        if not self.training:
            if lstm_route(self.num_layers, h_dim, sm_count(x.device)) == "pair":
                return lstm2_infer(x, *layers)
            x_l = x.to(torch.float32).transpose(0, 1)
            for i, p in enumerate(layers):
                x_l = lstm1_infer(torch.matmul(x_l, p["w_ih"]) + p["b"],
                                  p["w_hh"], want_series=i < self.num_layers - 1)
            return x_l
        shape = (x.shape[1], self.num_layers - 1, x.shape[0], h_dim)
        keep = keep_mask(noise, shape, self.dropout, x.device)
        return fused_lstm_final(x, keep, layers)
