"""Stacked LSTM or GRU, final hidden state: serving and training.

The parameter layout matches the JAX package's ``_CellParams`` /
``FusedStackedRNN``: an LSTM's ``layer_<l>.{w_ih (D, 4H), w_hh (H, 4H),
b (4H,)}``, gate order i, f, g, o; a GRU's ``layer_<l>.{w_ih (D, 3H),
w_hh (H, 3H), b_ih (3H,), b_hh (3H,)}``, gate order r, z, n; so a JAX
checkpoint maps onto it key for key.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.models.noise import Noise, keep_mask
from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import (
    gru1_infer,
    gru2_infer,
    lstm1_infer,
    lstm2_infer,
)
from multimodal_emotion_detection_tpu_torch.ops.lstm_vjp import (
    H100_SMS,
    check_gru_stack,
    fused_gru_final,
    fused_lstm_final,
    lstm_route,
    sm_count,
)


class _CellParams(nn.Module):
    """One LSTM or GRU layer's parameters, in the JAX layout."""

    def __init__(self, in_dim: int, hidden_dim: int, cell_type: str = "lstm"):
        super().__init__()
        gates = (4 if cell_type == "lstm" else 3) * hidden_dim
        self.w_ih = nn.Parameter(torch.empty(in_dim, gates))
        self.w_hh = nn.Parameter(torch.empty(hidden_dim, gates))
        if cell_type == "lstm":
            self.b = nn.Parameter(torch.empty(gates))
        else:
            self.b_ih = nn.Parameter(torch.empty(gates))
            self.b_hh = nn.Parameter(torch.empty(gates))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """U(-1/sqrt(H), 1/sqrt(H)) for every tensor, as the JAX init."""
        k = 1.0 / math.sqrt(self.w_hh.shape[0])
        for p in self.parameters():
            nn.init.uniform_(p, -k, k, generator=generator)

    def as_dict(self):
        return dict(self.named_parameters())


class FusedStackedRNN(nn.Module):
    """L-layer LSTM or GRU (any L >= 1) returning the top layer's final
    hidden state (B, H).

    ``ops.lstm_vjp.lstm_route`` (``gru_route`` for a GRU, the same rule)
    picks the kernels: the 2-layer ones for 2 layers of H up to twice the
    card's SM count, one layer per launch otherwise.  In eval mode the
    forward is ``lstm2_infer`` / ``gru2_infer``, or per layer the input
    projection and ``lstm1_infer`` / ``gru1_infer`` (the h series into the
    next layer, the final h out of the top one).  In training mode it is
    ``ops.lstm_vjp.fused_lstm_final`` / ``fused_gru_final``.  A GRU wider
    than the one-layer kernels take (``ops.lstm_vjp.check_gru_stack``) is
    refused.

    Training mode drops out between the layers (not at depth 1, as the JAX
    package): a keep mask Bernoulli(1 - dropout) / (1 - dropout) of shape
    (T, L-1, B, H), one draw per step, from ``noise`` (all ones at dropout
    0).  Each op is the hand-written kernel on the card and its plain
    version on the CPU.

    ``remat_gates`` (set from ``runtime.lstm_remat_gates`` where the model
    is built) makes the 2-layer LSTM pair's training route recompute its
    gates in the backward instead of storing them; the layered LSTM, the
    GRU and the eval forward ignore it, as in the JAX package.
    ``residual_dtype`` (set from ``runtime.lstm_residual_dtype``, a torch
    dtype) is the training routes' residual streams' (``fused_lstm_final``
    says where bf16 engages); the eval forward stores none.
    """

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 dropout: float = 0.0, cell_type: str = "lstm"):
        super().__init__()
        if cell_type not in ("lstm", "gru"):
            raise ValueError(f"Unknown cell type {cell_type!r}")
        if num_layers < 1:
            raise ValueError(f"FusedStackedRNN needs a layer, got num_layers={num_layers}")
        if cell_type == "gru":
            # against an H100 here, as the CPU mirrors one; each forward
            # checks again against the card it runs on
            check_gru_stack(hidden_dim, H100_SMS)
        self.cell_type = cell_type
        self.remat_gates = False
        self.residual_dtype = torch.float32
        self.dropout = float(dropout) if num_layers > 1 else 0.0
        self.num_layers = num_layers
        for layer in range(num_layers):
            self.add_module(f"layer_{layer}", _CellParams(
                in_dim if layer == 0 else hidden_dim, hidden_dim, cell_type))

    def forward(self, x: torch.Tensor, noise: Optional[Noise] = None) -> torch.Tensor:
        layers = [getattr(self, f"layer_{i}").as_dict()
                  for i in range(self.num_layers)]
        h_dim = layers[0]["w_hh"].shape[0]
        gru = self.cell_type == "gru"
        if not self.training:
            sms = sm_count(x.device)
            if gru:
                check_gru_stack(h_dim, sms)
            if lstm_route(self.num_layers, h_dim, sms) == "pair":
                return (gru2_infer if gru else lstm2_infer)(x, *layers)
            x_l = x.to(torch.float32).transpose(0, 1)
            for i, p in enumerate(layers):
                series = i < self.num_layers - 1
                if gru:
                    x_l = gru1_infer(torch.matmul(x_l, p["w_ih"]) + p["b_ih"],
                                     p["w_hh"], p["b_hh"], want_series=series)
                else:
                    x_l = lstm1_infer(torch.matmul(x_l, p["w_ih"]) + p["b"],
                                      p["w_hh"], want_series=series)
            return x_l
        shape = (x.shape[1], self.num_layers - 1, x.shape[0], h_dim)
        keep = keep_mask(noise, shape, self.dropout, x.device)
        if gru:
            return fused_gru_final(x, keep, layers, res_dtype=self.residual_dtype)
        return fused_lstm_final(x, keep, layers, remat_gates=self.remat_gates,
                                res_dtype=self.residual_dtype)
