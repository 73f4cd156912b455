"""2-layer LSTM recurrences: CUDA kernels + plain PyTorch versions.

Parameters keep the JAX package's layout: ``w_ih`` (D, 4H), ``w_hh``
(H, 4H) and one fused bias ``b`` (4H,), gate order i, f, g, o.  Layer 0's
input projection ``x @ w_ih0 + b0`` is one ``torch.matmul`` over all
steps; each recurrence runs in its ``csrc/`` kernel on the card and in the
loop of its plain version on the CPU.

* ``lstm2_infer``: final hidden state (B, H) from zero state
  (``csrc/lstm2_infer.cu``);
* ``lstm2_train_fwd_residuals``: the training forward, time-major, with
  the residuals the backward consumes (``csrc/lstm2_train_fwd.cu``);
* ``lstm2_bwd_chain``: the reverse dgates chain of both layers over those
  residuals (``csrc/lstm2_bwd_chain.cu``).

The residual layout is the JAX package's: ``packed`` (T, B, 10H) =
``[g0 | g1 | c0_prev | c1_prev]`` at the ``RES2_*`` offsets (units of H),
``h0_prev`` / ``h1_prev`` / ``x1`` (T, B, H) and ``finals`` (4, B, H) =
``[h0, c0, h1, c1]``.  Unlike the TPU kernels, exactly T steps run: there
are no pad rows.
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
    square = (h_dim, 4 * h_dim)
    _check_shapes("lstm2_infer", w_hh0=(w_hh0, square), w_ih1=(w_ih1, square),
                  b1=(b1, (4 * h_dim,)), w_hh1=(w_hh1, square))
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


# ---------------------------------------------------------------------------
# Training: forward with residuals, reverse dgates chain
# ---------------------------------------------------------------------------

RES2_G0, RES2_G1, RES2_C0P, RES2_C1P, RES2_W = 0, 4, 8, 9, 10


def _cell_bwd(g: torch.Tensor, c_prev: torch.Tensor, dh: torch.Tensor,
              dc: torch.Tensor):
    """One LSTM step backward: (dgates pre-activation (B, 4H), dc_prev)."""
    i, f, gg, o = g.chunk(4, dim=-1)
    si, sf, so = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    tg = torch.tanh(gg)
    tc = torch.tanh(sf * c_prev + si * tg)
    dc = dc + dh * so * (1.0 - tc * tc)
    dgates = torch.cat([
        dc * tg * si * (1.0 - si),
        dc * c_prev * sf * (1.0 - sf),
        dc * si * (1.0 - tg * tg),
        dh * tc * so * (1.0 - so),
    ], dim=-1)
    return dgates, dc * sf


def lstm2_train_fwd_reference(x_tm: torch.Tensor, keep_tm: torch.Tensor,
                              layer0: Params, layer1: Params):
    """Plain version of the training forward.

    x_tm (T, B, D) time-major, keep_tm (T, B, H) the layer-0 -> 1 keep
    mask -> ``(packed, h0_prev, h1_prev, x1, finals)`` in the module's
    residual layout.  Differentiable, so autograd through it is a plain
    reference for the kernel pair's gradients.
    """
    ih0 = _input_projection(x_tm, layer0)
    keep = keep_tm.to(torch.float32)
    batch, h_dim = x_tm.shape[1], layer0["w_hh"].shape[0]
    h0 = c0 = h1 = c1 = ih0.new_zeros((batch, h_dim))
    packed, h0p, h1p, x1s = [], [], [], []
    for t in range(x_tm.shape[0]):
        g0 = ih0[t] + h0 @ layer0["w_hh"]
        h0n, c0n = _cell(c0, g0)
        x1 = h0n * keep[t]
        g1 = (x1 @ layer1["w_ih"] + layer1["b"]) + h1 @ layer1["w_hh"]
        h1n, c1n = _cell(c1, g1)
        packed.append(torch.cat([g0, g1, c0, c1], dim=-1))
        h0p.append(h0)
        h1p.append(h1)
        x1s.append(x1)
        h0, c0, h1, c1 = h0n, c0n, h1n, c1n
    return (torch.stack(packed), torch.stack(h0p), torch.stack(h1p),
            torch.stack(x1s), torch.stack([h0, c0, h1, c1]))


def _refuse_dys(dys) -> None:
    if dys is not None:
        raise NotImplementedError(
            "a sequence-output LSTM (dys given to the backward chain) is not "
            "ported yet (ROADMAP.md Queue 1 item 3)"
        )


def lstm2_bwd_chain_reference(packed: torch.Tensor, keep_tm: torch.Tensor,
                              dh_final: torch.Tensor, w_hh0: torch.Tensor,
                              w_hh1: torch.Tensor, w_ih1: torch.Tensor,
                              dys=None):
    """Plain version of the reverse chain: ``(dg0, dg1)``, each (T, B, 4H).

    Per reverse step t: layer 1's cell backward, ``dh1 <- dg1 w_hh1^T``,
    the hop ``dx1 = dg1 w_ih1^T`` times ``keep[t]`` into layer 0, layer 0's
    cell backward, ``dh0 <- dg0 w_hh0^T``.  Only the final hidden state of
    layer 1 has a cotangent (``dh_final``).
    """
    _refuse_dys(dys)
    h_dim = w_hh0.shape[0]
    keep = keep_tm.to(torch.float32)
    dh1 = dh_final.to(torch.float32)
    dc1 = dh0 = dc0 = torch.zeros_like(dh1)
    dg0s, dg1s = [], []
    for t in reversed(range(packed.shape[0])):
        pk = packed[t]
        dg1, dc1 = _cell_bwd(pk[:, RES2_G1 * h_dim:RES2_C0P * h_dim],
                             pk[:, RES2_C1P * h_dim:RES2_W * h_dim], dh1, dc1)
        dh1 = dg1 @ w_hh1.T
        dx1 = dg1 @ w_ih1.T
        dg0, dc0 = _cell_bwd(pk[:, RES2_G0 * h_dim:RES2_G1 * h_dim],
                             pk[:, RES2_C0P * h_dim:RES2_C1P * h_dim],
                             dh0 + dx1 * keep[t], dc0)
        dh0 = dg0 @ w_hh0.T
        dg0s.append(dg0)
        dg1s.append(dg1)
    return torch.stack(dg0s[::-1]), torch.stack(dg1s[::-1])


LSTM2_TRAIN_FWD = CudaKernel(
    "lstm2_train_fwd", "lstm2_train_fwd_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
)
LSTM2_BWD_CHAIN = CudaKernel(
    "lstm2_bwd_chain", "lstm2_bwd_chain_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
)


def _check_shapes(name: str, **shaped) -> None:
    for arg, (t, shape) in shaped.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def lstm2_train_fwd_residuals(x_tm: torch.Tensor, keep_tm: torch.Tensor,
                              layer0: Params, layer1: Params):
    """Training forward: x_tm (T, B, D), keep_tm (T, B, H) ->
    ``(packed, h0_prev, h1_prev, x1, finals)``, all float32.

    On a CUDA tensor this launches ``csrc/lstm2_train_fwd.cu`` (one
    cooperative launch for the whole sequence) and counts it in
    ``LSTM2_TRAIN_FWD.launches``; on a CPU tensor it runs
    ``lstm2_train_fwd_reference``.
    """
    if x_tm.device.type == "cpu":
        return lstm2_train_fwd_reference(x_tm, keep_tm, layer0, layer1)
    t_len, batch, _ = x_tm.shape
    h_dim = layer0["w_hh"].shape[0]
    if t_len < 1 or batch < 1:
        raise ValueError(f"lstm2_train_fwd: empty input of shape {tuple(x_tm.shape)}")
    ih0 = _input_projection(x_tm, layer0).contiguous()
    keep = keep_tm.to(torch.float32).contiguous()
    w_hh0 = layer0["w_hh"].contiguous()
    w_ih1 = layer1["w_ih"].contiguous()
    b1 = layer1["b"].contiguous()
    w_hh1 = layer1["w_hh"].contiguous()
    square = (h_dim, 4 * h_dim)
    _check_shapes("lstm2_train_fwd", keep=(keep, (t_len, batch, h_dim)),
                  w_hh0=(w_hh0, square), w_ih1=(w_ih1, square),
                  b1=(b1, (4 * h_dim,)), w_hh1=(w_hh1, square))
    new = dict(dtype=torch.float32, device=x_tm.device)
    packed = torch.empty((t_len, batch, RES2_W * h_dim), **new)
    h0p, h1p, x1 = (torch.empty((t_len, batch, h_dim), **new) for _ in range(3))
    finals = torch.empty((4, batch, h_dim), **new)
    check_cuda_f32("lstm2_train_fwd", ih0=ih0, keep=keep, w_hh0=w_hh0,
                   w_ih1=w_ih1, b1=b1, w_hh1=w_hh1)
    LSTM2_TRAIN_FWD(
        ih0.data_ptr(), keep.data_ptr(), w_hh0.data_ptr(), w_ih1.data_ptr(),
        b1.data_ptr(), w_hh1.data_ptr(), packed.data_ptr(), h0p.data_ptr(),
        h1p.data_ptr(), x1.data_ptr(), finals.data_ptr(), batch, t_len,
        h_dim, stream_of(x_tm),
    )
    return packed, h0p, h1p, x1, finals


def lstm2_bwd_chain(packed: torch.Tensor, keep_tm: torch.Tensor,
                    dh_final: torch.Tensor, w_hh0: torch.Tensor,
                    w_hh1: torch.Tensor, w_ih1: torch.Tensor, dys=None):
    """Reverse dgates chain: ``(dg0, dg1)``, each (T, B, 4H) float32.

    On a CUDA tensor this launches ``csrc/lstm2_bwd_chain.cu`` (one
    cooperative launch) and counts it in ``LSTM2_BWD_CHAIN.launches``; on a
    CPU tensor it runs ``lstm2_bwd_chain_reference``.  ``dys`` (a
    sequence-output cotangent) is not taken: it raises.
    """
    _refuse_dys(dys)
    if packed.device.type == "cpu":
        return lstm2_bwd_chain_reference(packed, keep_tm, dh_final, w_hh0,
                                         w_hh1, w_ih1)
    t_len, batch, _ = packed.shape
    h_dim = w_hh0.shape[0]
    keep = keep_tm.to(torch.float32).contiguous()
    dh = dh_final.to(torch.float32).contiguous()
    w_hh0, w_hh1, w_ih1 = (w.contiguous() for w in (w_hh0, w_hh1, w_ih1))
    square = (h_dim, 4 * h_dim)
    _check_shapes("lstm2_bwd_chain", packed=(packed, (t_len, batch, RES2_W * h_dim)),
                  keep=(keep, (t_len, batch, h_dim)), dh_final=(dh, (batch, h_dim)),
                  w_hh0=(w_hh0, square), w_hh1=(w_hh1, square),
                  w_ih1=(w_ih1, square))
    if t_len < 1 or batch < 1:
        raise ValueError(f"lstm2_bwd_chain: empty residuals {tuple(packed.shape)}")
    new = dict(dtype=torch.float32, device=packed.device)
    dg0 = torch.empty((t_len, batch, 4 * h_dim), **new)
    dg1 = torch.empty((t_len, batch, 4 * h_dim), **new)
    check_cuda_f32("lstm2_bwd_chain", packed=packed, keep=keep, dh_final=dh,
                   w_hh0=w_hh0, w_hh1=w_hh1, w_ih1=w_ih1)
    LSTM2_BWD_CHAIN(
        packed.data_ptr(), keep.data_ptr(), dh.data_ptr(), w_hh0.data_ptr(),
        w_hh1.data_ptr(), w_ih1.data_ptr(), dg0.data_ptr(), dg1.data_ptr(),
        batch, t_len, h_dim, stream_of(packed),
    )
    return dg0, dg1
