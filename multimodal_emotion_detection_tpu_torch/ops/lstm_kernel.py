"""2-layer LSTM inference: CUDA kernel + plain PyTorch version.

Final hidden state (B, H) of a 2-layer LSTM from zero state.  Parameters
keep the JAX package's layout: ``w_ih`` (D, 4H), ``w_hh`` (H, 4H) and one
fused bias ``b`` (4H,), gate order i, f, g, o.  Layer 0's input projection
``x @ w_ih0 + b0`` is one ``torch.matmul`` over all steps; the recurrence
runs in ``csrc/lstm2_infer.cu`` on the card and in the loop of
``lstm2_infer_reference`` on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from multimodal_emotion_detection_tpu_torch.ops._build import (
    CudaKernel,
    check_cuda_f32,
    stream_of,
)

Params = Dict[str, torch.Tensor]


def _cell(c: torch.Tensor, gates: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _input_projection(x: torch.Tensor, layer0: Params) -> torch.Tensor:
    return torch.matmul(x.to(torch.float32), layer0["w_ih"]) + layer0["b"]


def lstm2_infer_reference(x: torch.Tensor, layer0: Params, layer1: Params) -> torch.Tensor:
    """Plain version: x (B, T, D) -> final h of layer 1 (B, H), one step of
    each layer at a time."""
    ih0 = _input_projection(x, layer0)
    batch, h_dim = x.shape[0], layer0["w_hh"].shape[0]
    h0 = c0 = h1 = c1 = ih0.new_zeros((batch, h_dim))
    for t in range(x.shape[1]):
        h0, c0 = _cell(c0, ih0[:, t] + h0 @ layer0["w_hh"])
        g1 = (h0 @ layer1["w_ih"] + layer1["b"]) + h1 @ layer1["w_hh"]
        h1, c1 = _cell(c1, g1)
    return h1


_P = ctypes.c_void_p
_I = ctypes.c_int
LSTM2_INFER = CudaKernel(
    "lstm2_infer", "lstm2_infer_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
)


def lstm2_infer(x: torch.Tensor, layer0: Params, layer1: Params) -> torch.Tensor:
    """x (B, T, D) -> final h of layer 1 (B, H), float32.

    On a CUDA tensor this launches ``csrc/lstm2_infer.cu`` (one cooperative
    launch for the whole sequence) and counts it in
    ``LSTM2_INFER.launches``; on a CPU tensor it runs
    ``lstm2_infer_reference``.  Any other device raises.
    """
    if x.device.type == "cpu":
        return lstm2_infer_reference(x, layer0, layer1)
    batch, t_len, _ = x.shape
    h_dim = layer0["w_hh"].shape[0]
    if t_len < 1:
        raise ValueError("lstm2_infer: the sequence has no steps")
    if h_dim % 4:
        raise ValueError(f"lstm2_infer: hidden size {h_dim} is not a multiple of 4")
    ih0 = _input_projection(x, layer0).contiguous()
    w_hh0 = layer0["w_hh"].contiguous()
    w_ih1 = layer1["w_ih"].contiguous()
    b1 = layer1["b"].contiguous()
    w_hh1 = layer1["w_hh"].contiguous()
    for name, t, shape in (
        ("w_hh0", w_hh0, (h_dim, 4 * h_dim)),
        ("w_ih1", w_ih1, (h_dim, 4 * h_dim)),
        ("b1", b1, (4 * h_dim,)),
        ("w_hh1", w_hh1, (h_dim, 4 * h_dim)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"lstm2_infer: {name} has shape {tuple(t.shape)}, expected {shape}")
    # h state exchanged between the kernel's blocks, double-buffered per
    # layer; the kernel reads slot 1 of each as the zero initial state
    h_state = torch.zeros((2, 2, batch, h_dim), dtype=torch.float32, device=x.device)
    out = torch.empty((batch, h_dim), dtype=torch.float32, device=x.device)
    check_cuda_f32("lstm2_infer", ih0=ih0, w_hh0=w_hh0, w_ih1=w_ih1, b1=b1,
                   w_hh1=w_hh1, h_state=h_state, out=out)
    LSTM2_INFER(
        ih0.data_ptr(), w_hh0.data_ptr(), w_ih1.data_ptr(), b1.data_ptr(),
        w_hh1.data_ptr(), h_state[0].data_ptr(), h_state[1].data_ptr(),
        out.data_ptr(), batch, t_len, h_dim, stream_of(x),
    )
    return out
