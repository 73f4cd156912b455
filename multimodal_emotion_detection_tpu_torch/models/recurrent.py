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

from multimodal_emotion_detection_tpu_torch.models.layers import bf16_scalar
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
    rounds_weight_grads,
    sm_count,
)


class _RoundBF16(torch.autograd.Function):
    """A float32 tensor rounded to bf16 and held in float32; the gradient
    passes through unrounded (the JAX pairs' float32 weight gradients reach
    the float32 parameters as they are)."""

    @staticmethod
    def forward(ctx, w):
        return w.to(torch.bfloat16).to(w.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


def round_bf16(w: torch.Tensor, exact_grad: bool = True) -> torch.Tensor:
    """``w`` rounded to bf16 (to nearest even), in ``w``'s dtype; its
    gradient unrounded, or without ``exact_grad`` rounded to bf16 too."""
    if exact_grad:
        return _RoundBF16.apply(w)
    return w.to(torch.bfloat16).to(w.dtype)


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

    ``compute_dtype`` bf16 (``runtime.compute_dtype`` or the encoder's
    ``dtype``) runs the JAX module's ``dtype=bfloat16``: every parameter is
    rounded to bf16 at use (``round_bf16``: the float32 parameters stay;
    their gradients are rounded to bf16 where the JAX package's custom VJPs
    hand them back so, ``ops.lstm_vjp.rounds_weight_grads``), x is rounded
    to bf16, the keep mask is made in bf16 (a kept element is bf16(1 /
    bf16(1 - p)), 1.109375 at p = 0.1), and the final h is returned in
    bf16.  The kernels read
    those operands into float32 and compute in float32, as the JAX kernels
    do, so every route runs the float32 kernels.  The eval forward is the
    JAX package's ``inference_kernel=True`` numerics (its default bf16 eval
    forward is an XLA scan in bf16 arithmetic, a few bf16 ulps away).
    """

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 dropout: float = 0.0, cell_type: str = "lstm",
                 dtype: torch.dtype = torch.float32):
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
        self.compute_dtype = dtype
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
        half = self.compute_dtype == torch.bfloat16
        if half:
            exact = not rounds_weight_grads(self.cell_type, self.num_layers, h_dim, x.device)
            layers = [{k: round_bf16(v, exact) for k, v in p.items()} for p in layers]
            x = x.to(torch.bfloat16)
        h = self._run(x, layers, h_dim, gru, noise, half)
        return h.to(torch.bfloat16) if half else h

    def _run(self, x, layers, h_dim: int, gru: bool, noise: Optional[Noise],
             half: bool) -> torch.Tensor:
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
        if half and self.dropout > 0.0:
            # flax's bf16 mask: 1 / bf16(1 - p), rounded to bf16
            keep = torch.where(keep > 0, bf16_scalar(1.0 / bf16_scalar(1.0 - self.dropout)),
                               0.0)
        if gru:
            return fused_gru_final(x, keep, layers, res_dtype=self.residual_dtype)
        return fused_lstm_final(x, keep, layers, remat_gates=self.remat_gates,
                                res_dtype=self.residual_dtype)
