"""Gradient of the 2-layer LSTM's final hidden state, with hoisted weight
gradients.

``FusedLSTMFinal`` is the counterpart of the JAX package's
``fused_lstm_final`` on its residual-native route: the forward is
``lstm2_train_fwd_residuals`` (saving the residuals), the backward is the
serial reverse chain ``lstm2_bwd_chain``, which emits every step's dgates
of both layers, followed by the weight gradients as single matrix products
over the flattened (T*B, .) series:

    dW_ih0 = x^T dg0     dW_hh0 = h0_prev^T dg0     db0 = sum dg0
    dW_ih1 = x1^T dg1    dW_hh1 = h1_prev^T dg1     db1 = sum dg1

On the card both recurrences are hand-written kernels; on the CPU the same
Function runs their plain versions.  The keep mask is a dropout draw and
gets no gradient.
"""

from __future__ import annotations

import torch

from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import (
    Params,
    lstm2_bwd_chain,
    lstm2_train_fwd_residuals,
)


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0] * a.shape[1], -1)


class FusedLSTMFinal(torch.autograd.Function):
    """(x (B, T, D), keep (T, B, H), w_ih0, w_hh0, b0, w_ih1, w_hh1, b1)
    -> final hidden state of layer 1 (B, H)."""

    @staticmethod
    def forward(ctx, x, keep, w_ih0, w_hh0, b0, w_ih1, w_hh1, b1):
        x_tm = x.to(torch.float32).transpose(0, 1).contiguous()
        layer0 = {"w_ih": w_ih0, "w_hh": w_hh0, "b": b0}
        layer1 = {"w_ih": w_ih1, "w_hh": w_hh1, "b": b1}
        packed, h0p, h1p, x1, finals = lstm2_train_fwd_residuals(
            x_tm, keep, layer0, layer1)
        ctx.save_for_backward(x_tm, keep, packed, h0p, h1p, x1,
                              w_ih0, w_hh0, w_ih1, w_hh1)
        return finals[2].clone()

    @staticmethod
    def backward(ctx, dh_final):
        (x_tm, keep, packed, h0p, h1p, x1,
         w_ih0, w_hh0, w_ih1, w_hh1) = ctx.saved_tensors
        dg0, dg1 = lstm2_bwd_chain(packed, keep, dh_final, w_hh0, w_hh1, w_ih1)
        dg0f, dg1f = _flat(dg0), _flat(dg1)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dg0 @ w_ih0.T).transpose(0, 1)
        return (dx, None,
                _flat(x_tm).T @ dg0f, _flat(h0p).T @ dg0f, dg0f.sum(0),
                _flat(x1).T @ dg1f, _flat(h1p).T @ dg1f, dg1f.sum(0))


def fused_lstm_final(x: torch.Tensor, keep: torch.Tensor, layer0: Params,
                     layer1: Params) -> torch.Tensor:
    """x (B, T, D), keep (T, B, H) -> layer 1's final hidden state (B, H),
    differentiable in x and both layers' parameters."""
    return FusedLSTMFinal.apply(
        x, keep, layer0["w_ih"], layer0["w_hh"], layer0["b"],
        layer1["w_ih"], layer1["w_hh"], layer1["b"])
