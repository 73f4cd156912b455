"""LSTM and GRU recurrences: CUDA kernels + plain PyTorch versions.

Parameters keep the JAX package's layout: for an LSTM layer ``w_ih``
(D, 4H), ``w_hh`` (H, 4H) and one fused bias ``b`` (4H,), gate order i, f,
g, o; for a GRU layer ``w_ih`` (D, 3H), ``w_hh`` (H, 3H), ``b_ih`` and
``b_hh`` (3H,), gate order r, z, n.  Each layer-0 input projection (``x @
w_ih + b``, or ``+ b_ih``) is one ``torch.matmul`` over all steps; each
recurrence runs in its ``csrc/`` kernel on the card and in the loop of its
plain version on the CPU.  The four eval forms (``lstm2_infer``,
``gru2_infer``, ``lstm1_infer``, ``gru1_infer``) call ``torch.library``
custom ops of those names in the ``med_torch`` namespace
(``_build.kernel_op``), so ``torch.export`` traces each as one node; the
training kernels launch behind their ``autograd.Function``s.

Two layers in one launch (H up to twice the SM count):

* ``lstm2_infer``: final hidden state (B, H) from zero state
  (``csrc/lstm2_infer.cu`` on the 2-layer forward core
  ``csrc/rnn2_fwd_chain.cuh``, split by ``chain_plan(forward=True,
  layers=2)``);
* ``lstm2_train_fwd_residuals``: the training forward, time-major, with
  the residuals the backward consumes (``csrc/lstm2_train_fwd.cu``, the
  training form of the same 2-layer forward core, on the same plan);
* ``lstm2_bwd_chain``: the reverse dgates chain of both layers over those
  residuals (``csrc/lstm2_bwd_chain.cu`` on the 2-layer reverse core
  ``csrc/rnn2_bwd_chain.cuh``, split by ``chain_plan(layers=2)``);
* ``lstm2_train_fwd_residuals(store_gates=False)`` and
  ``lstm2_bwd_chain_remat``: the gate-rematerialising pair
  (``runtime.lstm_remat_gates``).  The forward (the same source, its
  no-gates form) stores only the cell states; the reverse chain
  (``csrc/lstm2_bwd_chain_remat.cu``, the same reverse core with the remat
  cell, on the same plan with its gate blocks' shared memory) recomputes
  each step's gate pre-activations from the streamed x, h_prev and x1
  series, ``REMAT_KS`` steps a block.

The legacy-layout twins of the pair (the routes of the JAX package's
``set_res2_mode("off")``):

* ``lstm2_train_fwd_legacy``: the training forward in the older layout
  (``csrc/lstm2_train_fwd_legacy.cu``, the 2-layer forward core's training
  form with the legacy cell, on ``lstm2_train_fwd_residuals``' plan),
  ``res`` (T, B, 12H) = ``[g0 | g1 | h0 | h1 | c0 | c1]`` with the states
  AFTER each step, and ``h_final`` (B, H);
* ``lstm2_bwd_chain_legacy``: both layers' reverse chain over that
  layout's separate g / c_prev series, packed into ``lstm2_bwd_chain``'s
  rows, with an optional ``dys`` stream, into ``dg`` (T, B, 8H) = ``[dg0 |
  dg1]`` (``csrc/lstm2_bwd_chain_legacy.cu``, the 2-layer reverse core
  with the legacy cell, on ``lstm2_bwd_chain``'s plan).

One layer per launch, any depth (H up to at least 1024):

* ``lstm1_train_fwd``: one layer's training forward over its hoisted
  input projection, with its residuals; ``lstm1_infer`` the same kernel
  source's eval form (``csrc/lstm1_fwd.cu`` on the forward core
  ``csrc/rnn_fwd_chain.cuh``, split by ``chain_plan(forward=True)``);
* ``lstm_bwd_chain``: one layer's reverse dgates chain
  (``csrc/lstm_bwd_chain.cu`` on the core ``csrc/rnn_bwd_chain.cuh``, split
  by ``chain_plan``).

The 2-layer residual layout is the JAX package's: ``packed`` (T, B, 10H) =
``[g0 | g1 | c0_prev | c1_prev]`` at the ``RES2_*`` offsets (units of H),
or (T, B, 2H) = ``[c0_prev | c1_prev]`` at the ``RES3_*`` ones without gates,
``h0_prev`` / ``h1_prev`` / ``x1`` (T, B, H) and ``finals`` (4, B, H) =
``[h0, c0, h1, c1]``; one layer's is ``g`` (T, B, 4H), ``h_prev`` and
``c_prev`` (T, B, H) and ``finals`` (B, 2H) = ``[h | c]``.

Two GRU layers in one launch (H up to twice the SM count), the twins of
the 2-layer LSTM kernels:

* ``gru2_infer``: final hidden state (B, H) from zero state
  (``csrc/gru2_infer.cu`` on the 2-layer forward core
  ``csrc/rnn2_fwd_chain.cuh``, split by ``chain_plan(forward=True,
  layers=2)``);
* ``gru2_train_fwd_residuals``: the training forward with its residuals
  (``csrc/gru2_train_fwd.cu``, the core's training form);
* ``gru2_bwd_chain``: the reverse chain of both layers, emitting ``dih``
  and only the ``dhn`` lane of ``dhh`` (``csrc/gru2_bwd_chain.cu`` on the
  2-layer reverse core ``csrc/rnn2_bwd_chain.cuh``, split by
  ``chain_plan(layers=2)``).

The GRU legacy-layout twins (``set_res2_mode("off")``):
``gru2_train_fwd_legacy`` (``csrc/gru2_train_fwd_legacy.cu``, the 2-layer
forward core's training form with the legacy GRU cell, on
``gru2_train_fwd_residuals``' plan: ``res`` (T, B, 10H) = ``[r0 | z0 | n0 |
hn0 | h0 | r1 | z1 | n1 | hn1 | h1]``, h after each step, and ``h_final``) and
``gru2_bwd_chain_legacy`` (``csrc/gru2_bwd_chain_legacy.cu``, the 2-layer
reverse core with the legacy GRU cell, on ``gru2_bwd_chain``'s plan: over
the per-layer ``[h_prev | r | z | n | hn]`` rows, with an optional
``dys``, into (T, B, 12H) = ``[dih0 | dhh0 | dih1 | dhh1]`` with the full
``dhh``).  Whether the legacy GRU backward takes it or two layered chains
is ``lstm_vjp.GRU_BWD2_ENABLED``'s choice, as in the JAX package.

The GRU residual layout is the JAX package's too: ``packed`` (T, B, 8H) =
``[r0 | z0 | n0 | hn0 | r1 | z1 | n1 | hn1]`` (gate activations, and
``hn = h_prev w_hn + b_hn`` before the reset gate multiplies it),
``h0_prev`` / ``h1_prev`` / ``x1`` (T, B, H) and ``finals`` (2, B, H) =
``[h0, h1]``.  Unlike the TPU kernels, exactly T steps run: there are no
pad rows.

One GRU layer per launch, any depth (H up to 8 times the SM count), the
twins of the one-layer LSTM kernels:

* ``gru1_train_fwd``: one layer's training forward over its hoisted input
  projection, with its residuals ``gates`` (T, B, 4H) = ``[r | z | n |
  hn]`` and ``h_prev`` (T, B, H); ``gru1_infer`` the same kernel source's
  eval form (``csrc/gru1_fwd.cu``, the same forward core);
* ``gru_bwd_chain``: one layer's reverse chain, emitting ``dih`` and the
  ``dhn`` lane of ``dhh`` (``csrc/gru_bwd_chain.cu``, the same core).

bf16 residual streams (the JAX package's ``runtime.lstm_residual_dtype``
"bfloat16"): ``lstm2_train_fwd_residuals`` (with and without the gates),
``gru2_train_fwd_residuals`` and ``lstm1_train_fwd`` take
``res_dtype=torch.bfloat16`` and then store their residual series in bf16,
each value rounded once (to nearest even) from the float32 value the
float32 form stores: the pairs' ``packed``, ``h0_prev``, ``h1_prev`` and
``x1``, the one-layer forward's ``g`` and ``c_prev`` (its ``h_prev`` stays
float32).  The finals stay float32, and so does the exchange between steps
and layers inside the kernels (the pairs' bf16 forms exchange through
float32 series they allocate beside the bf16 ones), so the forward's value
is the float32 form's.  The chains take bf16 residuals as they come and
read them into float32: ``lstm2_bwd_chain``, ``lstm2_bwd_chain_remat``
(over bf16 ``x``, ``x1``, ``h0_prev`` and ``h1_prev`` too, its gates
recomputed in float32 against the float32 weights) and ``gru2_bwd_chain``
then write their outputs in bf16 too (exchanging in float32 inside),
``lstm_bwd_chain`` float32, as the JAX kernels do.  Each bf16 form is an
entry point of the same source, counted apart (``*_BF16``); the plain
versions round at the same points.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from typing import Callable, Dict, Tuple

import torch

from multimodal_emotion_detection_tpu_torch.ops._build import (
    CudaKernel,
    check_cuda,
    check_cuda_f32,
    kernel_op,
    load,
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
    [_P] * 9 + [_I] * 7 + [_P],
)


def _lstm2_infer_launch(x: torch.Tensor, layer0: Params, layer1: Params) -> torch.Tensor:
    """The CUDA kernel of ``med_torch::lstm2_infer``."""
    batch, t_len, _ = x.shape
    h_dim = layer0["w_hh"].shape[0]
    if t_len < 1 or batch < 1:
        raise ValueError(f"lstm2_infer: empty input of shape {tuple(x.shape)}")
    ih0 = _input_projection(x, layer0).contiguous()
    w_hh0 = layer0["w_hh"].contiguous()
    w_ih1 = layer1["w_ih"].contiguous()
    b1 = layer1["b"].contiguous()
    w_hh1 = layer1["w_hh"].contiguous()
    square = (h_dim, 4 * h_dim)
    _check_shapes("lstm2_infer", w_hh0=(w_hh0, square), w_ih1=(w_ih1, square),
                  b1=(b1, (4 * h_dim,)), w_hh1=(w_hh1, square))
    # the kernel's CTAs exchange h through these: layer 0's whole series
    # (layer 1 reads it a step behind), layer 1's two slots used in turn;
    # the carries c (zeros)
    new = dict(dtype=torch.float32, device=x.device)
    h0 = torch.empty((t_len, batch, h_dim), **new)
    h1 = torch.empty((2, batch, h_dim), **new)
    carry = torch.zeros((2, batch, h_dim), **new)
    check_cuda_f32("lstm2_infer", ih0=ih0, w_hh0=w_hh0, w_ih1=w_ih1, b1=b1,
                   w_hh1=w_hh1)
    plan, flags = _pair_launch("lstm2_infer", 4, batch, h_dim, x.device, forward=True)
    LSTM2_INFER(
        ih0.data_ptr(), w_hh0.data_ptr(), w_ih1.data_ptr(), b1.data_ptr(),
        w_hh1.data_ptr(), h0.data_ptr(), h1.data_ptr(), carry.data_ptr(),
        flags.data_ptr(), batch, t_len, h_dim, plan.upc, plan.ncl, plan.rgroups,
        plan.kc, stream_of(x),
    )
    # a fresh tensor: an op's output is no view of its scratch (opcheck
    # holds its storage offset to the fake's)
    return h1[(t_len - 1) % 2].clone()


def _pair_infer_fake(x: torch.Tensor, layer0: Params, layer1: Params) -> torch.Tensor:
    return x.new_empty((x.shape[0], layer0["w_hh"].shape[0]), dtype=torch.float32)


def _lstm_pair_op(fn):
    """``fn(x, layer0, layer1)`` as an op kernel over the six LSTM tensors."""
    def kernel(x, w_ih0, w_hh0, b0, w_ih1, w_hh1, b1):
        return fn(x, {"w_ih": w_ih0, "w_hh": w_hh0, "b": b0},
                  {"w_ih": w_ih1, "w_hh": w_hh1, "b": b1})
    return kernel


LSTM2_INFER_OP = kernel_op(
    "lstm2_infer",
    "(Tensor x, Tensor w_ih0, Tensor w_hh0, Tensor b0, Tensor w_ih1, Tensor w_hh1, "
    "Tensor b1) -> Tensor",
    cpu=_lstm_pair_op(lstm2_infer_reference), cuda=_lstm_pair_op(_lstm2_infer_launch),
    fake=_lstm_pair_op(_pair_infer_fake))


def lstm2_infer(x: torch.Tensor, layer0: Params, layer1: Params) -> torch.Tensor:
    """x (B, T, D) -> final h of layer 1 (B, H), float32.

    Calls ``med_torch::lstm2_infer``: on a CUDA tensor it launches
    ``csrc/lstm2_infer.cu`` (one cooperative cluster launch for the whole
    sequence on ``chain_plan_on``'s 2-layer forward plan: layer 0 on one
    CTA set, layer 1 on another) and counts it in
    ``LSTM2_INFER.launches``; on a CPU tensor it runs
    ``lstm2_infer_reference``.  Any other device raises.
    """
    return LSTM2_INFER_OP(x, layer0["w_ih"], layer0["w_hh"], layer0["b"],
                          layer1["w_ih"], layer1["w_hh"], layer1["b"])


# ---------------------------------------------------------------------------
# Training: forward with residuals, reverse dgates chain
# ---------------------------------------------------------------------------

RES2_G0, RES2_G1, RES2_C0P, RES2_C1P, RES2_W = 0, 4, 8, 9, 10
# without the gates, which the remat chain recomputes
RES3_C0P, RES3_C1P, RES3_W = 0, 1, 2

# the residual streams' dtypes (runtime.lstm_residual_dtype)
RES_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def residual_dtype(name) -> torch.dtype:
    """``runtime.lstm_residual_dtype``'s torch dtype: "float32" or
    "bfloat16" (or the dtype itself); anything else raises, as the JAX
    package's ``set_res2_dtype`` does."""
    if isinstance(name, torch.dtype) and name in RES_DTYPES.values():
        return name
    if name not in RES_DTYPES:
        raise ValueError(f"residual dtype {name!r} is neither 'float32' nor 'bfloat16'")
    return RES_DTYPES[name]


def _stored(series: torch.Tensor, res_dtype: torch.dtype) -> torch.Tensor:
    """A plain forward's series as its kernel stores it: rounded once to
    bf16 in the bf16 form, else as computed."""
    return series.to(torch.bfloat16) if res_dtype == torch.bfloat16 else series


def _read(series: torch.Tensor) -> torch.Tensor:
    """A plain chain's residual as its kernel reads it: bf16 into float32,
    else as given."""
    return series.to(torch.float32) if series.dtype == torch.bfloat16 else series


def _half(name: str, *residuals: torch.Tensor) -> bool:
    """Whether a chain's residuals are bf16 (its bf16 form) or float32,
    all of one dtype."""
    dtypes = {t.dtype for t in residuals}
    if len(dtypes) != 1 or not dtypes <= set(RES_DTYPES.values()):
        raise ValueError(f"{name}: residuals of dtypes {sorted(map(str, dtypes))}, "
                         "expected all float32 or all bfloat16")
    return dtypes == {torch.bfloat16}


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
                              layer0: Params, layer1: Params,
                              store_gates: bool = True,
                              res_dtype: torch.dtype = torch.float32):
    """Plain version of the training forward.

    x_tm (T, B, D) time-major, keep_tm (T, B, H) the layer-0 -> 1 keep
    mask -> ``(packed, h0_prev, h1_prev, x1, finals)`` in the module's
    residual layout (``packed`` without the gates unless ``store_gates``),
    the series rounded to ``res_dtype``, the finals float32.
    Differentiable, so autograd through it is a plain reference for the
    kernel pair's gradients.
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
        packed.append(torch.cat([g0, g1, c0, c1] if store_gates else [c0, c1],
                                dim=-1))
        h0p.append(h0)
        h1p.append(h1)
        x1s.append(x1)
        h0, c0, h1, c1 = h0n, c0n, h1n, c1n
    return (*(_stored(torch.stack(s), res_dtype) for s in (packed, h0p, h1p, x1s)),
            torch.stack([h0, c0, h1, c1]))


def _refuse_dys(dys, cell: str = "LSTM", item: int = 3) -> None:
    if dys is not None:
        raise NotImplementedError(
            f"a sequence-output {cell} (dys given to the backward chain) is "
            f"not ported yet (ROADMAP.md Queue 1 item {item})"
        )


def lstm2_bwd_chain_reference(packed: torch.Tensor, keep_tm: torch.Tensor,
                              dh_final: torch.Tensor, w_hh0: torch.Tensor,
                              w_hh1: torch.Tensor, w_ih1: torch.Tensor,
                              dys=None):
    """Plain version of the reverse chain: ``(dg0, dg1)``, each (T, B, 4H)
    in ``packed``'s dtype (bf16 residuals read into float32, the chain
    float32, its outputs rounded to bf16 once).

    Per reverse step t: layer 1's cell backward, ``dh1 <- dg1 w_hh1^T``,
    the hop ``dx1 = dg1 w_ih1^T`` times ``keep[t]`` into layer 0, layer 0's
    cell backward, ``dh0 <- dg0 w_hh0^T``.  Only the final hidden state of
    layer 1 has a cotangent (``dh_final``).
    """
    _refuse_dys(dys)
    h_dim = w_hh0.shape[0]

    def step(t):
        pk = _read(packed[t])
        return (pk[:, RES2_G0 * h_dim:RES2_G1 * h_dim],
                pk[:, RES2_G1 * h_dim:RES2_C0P * h_dim],
                pk[:, RES2_C0P * h_dim:RES2_C1P * h_dim],
                pk[:, RES2_C1P * h_dim:RES2_W * h_dim])

    return tuple(dg.to(packed.dtype) for dg in _lstm2_chain(
        packed.shape[0], step, keep_tm, dh_final, w_hh0, w_hh1, w_ih1))


def _lstm2_chain(t_len: int, step, keep_tm: torch.Tensor, dh_final: torch.Tensor,
                 w_hh0: torch.Tensor, w_hh1: torch.Tensor, w_ih1: torch.Tensor,
                 dys=None):
    """The reverse walk the chains share; ``step(t)`` gives step t's
    ``(g0, g1, c0_prev, c1_prev)``; ``dys`` (T, B, H), where given, adds to
    layer 1's dh before its cell backward."""
    keep = keep_tm.to(torch.float32)
    dh1 = dh_final.to(torch.float32)
    dc1 = dh0 = dc0 = torch.zeros_like(dh1)
    dg0s, dg1s = [], []
    for t in reversed(range(t_len)):
        g0, g1, c0p, c1p = step(t)
        dh1_t = dh1 if dys is None else dh1 + dys[t].to(torch.float32)
        dg1, dc1 = _cell_bwd(g1, c1p, dh1_t, dc1)
        dh1 = dg1 @ w_hh1.T
        dx1 = dg1 @ w_ih1.T
        dg0, dc0 = _cell_bwd(g0, c0p, dh0 + dx1 * keep[t], dc0)
        dh0 = dg0 @ w_hh0.T
        dg0s.append(dg0)
        dg1s.append(dg1)
    return torch.stack(dg0s[::-1]), torch.stack(dg1s[::-1])


def lstm2_bwd_chain_remat_reference(packed: torch.Tensor, keep_tm: torch.Tensor,
                                    x_tm: torch.Tensor, x1: torch.Tensor,
                                    h0p: torch.Tensor, h1p: torch.Tensor,
                                    dh_final: torch.Tensor, layer0: Params,
                                    layer1: Params, dys=None):
    """Plain version of the gate-rematerialising reverse chain: ``(dg0,
    dg1)``, each (T, B, 4H) in ``packed``'s dtype, over ``packed`` (T, B,
    2H) = ``[c0_prev | c1_prev]``.

    The chain of ``lstm2_bwd_chain_reference``, with each step's gate
    pre-activations recomputed from the streamed series as the JAX kernel
    forms them: ``g0 = (x w_ih0 + b0) + h0_prev w_hh0`` and ``g1 = [x1 |
    h1_prev] [w_ih1; w_hh1] + b1``.  bf16 series (the bf16 form's) are
    read into float32 and the gates formed against the float32 weights;
    the chain is float32, its outputs rounded to bf16 once.
    """
    _refuse_dys(dys)
    h_dim = layer0["w_hh"].shape[0]
    w_xh1 = torch.cat([layer1["w_ih"], layer1["w_hh"]], dim=0)

    def step(t):
        pk = _read(packed[t])
        g0 = (x_tm[t].to(torch.float32) @ layer0["w_ih"] + layer0["b"]) \
            + _read(h0p[t]) @ layer0["w_hh"]
        g1 = torch.cat([_read(x1[t]), _read(h1p[t])], dim=-1) @ w_xh1 + layer1["b"]
        return (g0, g1, pk[:, RES3_C0P * h_dim:RES3_C1P * h_dim],
                pk[:, RES3_C1P * h_dim:RES3_W * h_dim])

    return tuple(dg.to(packed.dtype) for dg in _lstm2_chain(
        packed.shape[0], step, keep_tm, dh_final, layer0["w_hh"], layer1["w_hh"],
        layer1["w_ih"]))


LSTM2_TRAIN_FWD = CudaKernel(
    "lstm2_train_fwd", "lstm2_train_fwd_launch",
    [_P] * 13 + [_I] * 7 + [_P],
)
# the same source's no-gates form, counted apart
LSTM2_TRAIN_FWD_NOGATES = CudaKernel(
    "lstm2_train_fwd", "lstm2_train_fwd_nogates_launch",
    [_P] * 13 + [_I] * 7 + [_P],
)
# the bf16 forms of the same sources, counted apart
LSTM2_TRAIN_FWD_BF16 = CudaKernel(
    "lstm2_train_fwd", "lstm2_train_fwd_bf16_launch",
    [_P] * 16 + [_I] * 7 + [_P],
)
LSTM2_TRAIN_FWD_NOGATES_BF16 = CudaKernel(
    "lstm2_train_fwd", "lstm2_train_fwd_nogates_bf16_launch",
    [_P] * 16 + [_I] * 7 + [_P],
)
LSTM2_BWD_CHAIN = CudaKernel(
    "lstm2_bwd_chain", "lstm2_bwd_chain_launch",
    [_P] * 10 + [_I] * 7 + [_P],
)
LSTM2_BWD_CHAIN_BF16 = CudaKernel(
    "lstm2_bwd_chain", "lstm2_bwd_chain_bf16_launch",
    [_P] * 12 + [_I] * 7 + [_P],
)
LSTM2_BWD_CHAIN_REMAT = CudaKernel(
    "lstm2_bwd_chain_remat", "lstm2_bwd_chain_remat_launch",
    [_P] * 18 + [_I] * 10 + [_P],
)
LSTM2_BWD_CHAIN_REMAT_BF16 = CudaKernel(
    "lstm2_bwd_chain_remat", "lstm2_bwd_chain_remat_bf16_launch",
    [_P] * 20 + [_I] * 10 + [_P],
)


def _fwd_exchange(series: Tuple[int, int, int], device: torch.device):
    """The float32 exchange of a 2-layer training forward's bf16 form
    (scratch): each layer's own h in two (B, H) slots, layer 1's input x1 a
    whole (T, B, H) series (layer 0 runs ahead of layer 1)."""
    t_len, batch, h_dim = series
    new = dict(dtype=torch.float32, device=device)
    return (torch.empty((2, batch, h_dim), **new), torch.empty((2, batch, h_dim), **new),
            torch.empty(series, **new))


def _check_shapes(name: str, **shaped) -> None:
    for arg, (t, shape) in shaped.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _lstm2_fwd_inputs(name: str, x_tm: torch.Tensor, keep_tm: torch.Tensor,
                      layer0: Params, layer1: Params):
    """``(ih0, keep, w_hh0, w_ih1, b1, w_hh1)`` of a 2-layer training
    forward, contiguous and shape-checked, and ``(T, B, H)``."""
    t_len, batch, _ = x_tm.shape
    h_dim = layer0["w_hh"].shape[0]
    if t_len < 1 or batch < 1:
        raise ValueError(f"{name}: empty input of shape {tuple(x_tm.shape)}")
    ih0 = _input_projection(x_tm, layer0).contiguous()
    keep = keep_tm.to(torch.float32).contiguous()
    w_hh0 = layer0["w_hh"].contiguous()
    w_ih1 = layer1["w_ih"].contiguous()
    b1 = layer1["b"].contiguous()
    w_hh1 = layer1["w_hh"].contiguous()
    square = (h_dim, 4 * h_dim)
    _check_shapes(name, keep=(keep, (t_len, batch, h_dim)),
                  w_hh0=(w_hh0, square), w_ih1=(w_ih1, square),
                  b1=(b1, (4 * h_dim,)), w_hh1=(w_hh1, square))
    tensors = (ih0, keep, w_hh0, w_ih1, b1, w_hh1)
    check_cuda_f32(name, **dict(zip(("ih0", "keep", "w_hh0", "w_ih1", "b1",
                                     "w_hh1"), tensors)))
    return tensors, (t_len, batch, h_dim)


def lstm2_train_fwd_residuals(x_tm: torch.Tensor, keep_tm: torch.Tensor,
                              layer0: Params, layer1: Params,
                              store_gates: bool = True,
                              res_dtype: torch.dtype = torch.float32):
    """Training forward: x_tm (T, B, D), keep_tm (T, B, H) ->
    ``(packed, h0_prev, h1_prev, x1, finals)``; ``packed`` is (T, B, 10H),
    or (T, B, 2H) without the gates; the series in ``res_dtype`` (float32
    or bf16), the finals float32.

    On a CUDA tensor this launches ``csrc/lstm2_train_fwd.cu`` (one
    cooperative cluster launch for the whole sequence on ``chain_plan_on``'s
    2-layer forward plan: layer 0 on one CTA set, layer 1 on another) and
    counts it in ``LSTM2_TRAIN_FWD.launches``, its no-gates form in
    ``LSTM2_TRAIN_FWD_NOGATES.launches``, their bf16 forms in
    ``LSTM2_TRAIN_FWD_BF16.launches`` and
    ``LSTM2_TRAIN_FWD_NOGATES_BF16.launches``; on a CPU tensor it runs
    ``lstm2_train_fwd_reference``.
    """
    half = residual_dtype(res_dtype) == torch.bfloat16
    if x_tm.device.type == "cpu":
        return lstm2_train_fwd_reference(x_tm, keep_tm, layer0, layer1,
                                         store_gates=store_gates, res_dtype=res_dtype)
    tensors, (t_len, batch, h_dim) = _lstm2_fwd_inputs(
        "lstm2_train_fwd", x_tm, keep_tm, layer0, layer1)
    new = dict(dtype=torch.float32, device=x_tm.device)
    width = RES2_W if store_gates else RES3_W
    series = (t_len, batch, h_dim)
    finals = torch.empty((4, batch, h_dim), **new)
    carry = torch.zeros((2, batch, h_dim), **new)
    plan, flags = _pair_launch("lstm2_train_fwd", 4, batch, h_dim, x_tm.device,
                               forward=True)
    if half:
        res = dict(dtype=torch.bfloat16, device=x_tm.device)
        packed = torch.empty((t_len, batch, width * h_dim), **res)
        stored = [torch.empty(series, **res) for _ in range(3)]
        (LSTM2_TRAIN_FWD_BF16 if store_gates else LSTM2_TRAIN_FWD_NOGATES_BF16)(
            *(t.data_ptr() for t in (*tensors, packed, *stored,
                                     *_fwd_exchange(series, x_tm.device), finals,
                                     carry, flags)),
            batch, t_len, h_dim, plan.upc, plan.ncl, plan.rgroups, plan.kc,
            stream_of(x_tm),
        )
        return (packed, *stored, finals)
    packed = torch.empty((t_len, batch, width * h_dim), **new)
    # the kernel's CTAs exchange h through the h0p, h1p and x1 series
    h0p, h1p, x1 = (torch.empty(series, **new) for _ in range(3))
    (LSTM2_TRAIN_FWD if store_gates else LSTM2_TRAIN_FWD_NOGATES)(
        *(t.data_ptr() for t in tensors), packed.data_ptr(), h0p.data_ptr(),
        h1p.data_ptr(), x1.data_ptr(), finals.data_ptr(), carry.data_ptr(),
        flags.data_ptr(), batch, t_len, h_dim, plan.upc, plan.ncl, plan.rgroups,
        plan.kc, stream_of(x_tm),
    )
    return packed, h0p, h1p, x1, finals


def lstm2_bwd_chain(packed: torch.Tensor, keep_tm: torch.Tensor,
                    dh_final: torch.Tensor, w_hh0: torch.Tensor,
                    w_hh1: torch.Tensor, w_ih1: torch.Tensor, dys=None):
    """Reverse dgates chain: ``(dg0, dg1)``, each (T, B, 4H) in
    ``packed``'s dtype: float32, or bf16 over bf16 residuals (the bf16
    form).

    On a CUDA tensor this launches ``csrc/lstm2_bwd_chain.cu`` (one
    cooperative cluster launch on ``chain_plan_on``'s 2-layer plan: layer 1
    on one CTA set, layer 0 on another) and counts it in
    ``LSTM2_BWD_CHAIN.launches``, its bf16 form in
    ``LSTM2_BWD_CHAIN_BF16.launches``; on a CPU tensor it runs
    ``lstm2_bwd_chain_reference``.  ``dys`` (a sequence-output cotangent)
    is not taken: it raises.
    """
    _refuse_dys(dys)
    if packed.device.type == "cpu":
        return lstm2_bwd_chain_reference(packed, keep_tm, dh_final, w_hh0,
                                         w_hh1, w_ih1)
    half = _half("lstm2_bwd_chain", packed)
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
    # the kernel's CTAs exchange dg through these: the outputs, or in the
    # bf16 form float32 scratch beside them, layer 0's own rows in two slots
    # (layer 1's are the hop into layer 0, which runs behind)
    dg0 = torch.empty((2 if half else t_len, batch, 4 * h_dim), **new)
    dg1 = torch.empty((t_len, batch, 4 * h_dim), **new)
    check_cuda_f32("lstm2_bwd_chain", keep=keep, dh_final=dh, w_hh0=w_hh0,
                   w_hh1=w_hh1, w_ih1=w_ih1)
    check_cuda("lstm2_bwd_chain", packed.dtype, dict(packed=packed))
    plan, flags = _pair_launch("lstm2_bwd_chain", 4, batch, h_dim, packed.device,
                               forward=False)
    # the dc carries, zeros; dh_final enters at layer 1's first step
    carry = torch.zeros((2, batch, h_dim), **new)
    if half:
        out = [torch.empty_like(dg1, dtype=torch.bfloat16) for _ in range(2)]
        LSTM2_BWD_CHAIN_BF16(
            *(t.data_ptr() for t in (packed, keep, dh, w_hh0, w_hh1, w_ih1, *out, dg0,
                                     dg1, carry, flags)),
            batch, t_len, h_dim, plan.upc, plan.ncl, plan.rgroups, plan.kc,
            stream_of(packed),
        )
        return tuple(out)
    LSTM2_BWD_CHAIN(
        packed.data_ptr(), keep.data_ptr(), dh.data_ptr(), w_hh0.data_ptr(),
        w_hh1.data_ptr(), w_ih1.data_ptr(), dg0.data_ptr(), dg1.data_ptr(),
        carry.data_ptr(), flags.data_ptr(), batch, t_len, h_dim, plan.upc,
        plan.ncl, plan.rgroups, plan.kc, stream_of(packed),
    )
    return dg0, dg1


def lstm2_bwd_chain_remat(packed: torch.Tensor, keep_tm: torch.Tensor,
                          x_tm: torch.Tensor, x1: torch.Tensor, h0p: torch.Tensor,
                          h1p: torch.Tensor, dh_final: torch.Tensor,
                          layer0: Params, layer1: Params, dys=None):
    """Gate-rematerialising reverse chain: ``(dg0, dg1)``, each (T, B, 4H)
    in ``packed``'s dtype, over the no-gates forward's ``packed`` (T, B,
    2H), its ``x1`` / ``h0p`` / ``h1p`` (T, B, H) and the raw layer-0 input
    ``x_tm`` (T, B, D): all float32, or all bf16 (the bf16 form, the JAX
    kernel over bf16 streams and x cast to bf16).

    On a CUDA tensor this launches ``csrc/lstm2_bwd_chain_remat.cu`` (one
    cooperative cluster launch on ``chain_plan_on``'s 2-layer plan with the
    gate blocks' shared memory, ``remat_d`` the padded D; the gate columns
    packed by ``gate_columns``; one launch a ``batch_slice`` of the batch
    where the plan has one) and counts each in
    ``LSTM2_BWD_CHAIN_REMAT.launches``, its bf16 form in
    ``LSTM2_BWD_CHAIN_REMAT_BF16.launches`` (H a multiple of 8: it raises
    otherwise); on a CPU tensor it runs ``lstm2_bwd_chain_remat_reference``.
    ``dys`` is not taken: it raises.
    """
    _refuse_dys(dys)
    if packed.device.type == "cpu":
        return lstm2_bwd_chain_remat_reference(packed, keep_tm, x_tm, x1, h0p,
                                               h1p, dh_final, layer0, layer1)
    half = _half("lstm2_bwd_chain_remat", packed, x_tm, x1, h0p, h1p)
    t_len, batch, _ = packed.shape
    h_dim = layer0["w_hh"].shape[0]
    d_in = x_tm.shape[-1]
    if half and h_dim % 8:
        raise ValueError(f"lstm2_bwd_chain_remat: the bf16 form copies 16-byte pieces "
                         f"of the h rows, so H % 8 == 0; H={h_dim}")
    keep = keep_tm.to(torch.float32).contiguous()
    dh = dh_final.to(torch.float32).contiguous()
    x1, h0p, h1p = (a.contiguous() for a in (x1, h0p, h1p))
    w_ih0, b0, w_hh0 = (layer0[k].contiguous() for k in ("w_ih", "b", "w_hh"))
    w_ih1, b1, w_hh1 = (layer1[k].contiguous() for k in ("w_ih", "b", "w_hh"))
    series = (t_len, batch, h_dim)
    square = (h_dim, 4 * h_dim)
    _check_shapes("lstm2_bwd_chain_remat",
                  packed=(packed, (t_len, batch, RES3_W * h_dim)),
                  keep=(keep, series), x=(x_tm, (t_len, batch, d_in)), x1=(x1, series),
                  h0p=(h0p, series), h1p=(h1p, series), dh_final=(dh, (batch, h_dim)),
                  w_ih0=(w_ih0, (d_in, 4 * h_dim)), b0=(b0, (4 * h_dim,)),
                  w_hh0=(w_hh0, square), w_ih1=(w_ih1, square),
                  b1=(b1, (4 * h_dim,)), w_hh1=(w_hh1, square))
    if t_len < 1 or batch < 1:
        raise ValueError(f"lstm2_bwd_chain_remat: empty residuals {tuple(packed.shape)}")
    # the kernel copies 16-byte pieces of each input row (4 float32 values,
    # 8 bf16 ones): D padded with zero columns of x and zero rows of w_ih0
    vec = 8 if half else 4
    d_pad = _ceil(d_in, vec) * vec
    x, w_x0 = x_tm, w_ih0
    if d_pad != d_in:
        x = torch.nn.functional.pad(x, (0, d_pad - d_in))
        w_x0 = torch.nn.functional.pad(w_ih0, (0, 0, 0, d_pad - d_in))
    x = x.contiguous()
    check_cuda_f32("lstm2_bwd_chain_remat", keep=keep, dh_final=dh, w_ih0=w_ih0, b0=b0,
                   w_hh0=w_hh0, w_ih1=w_ih1, b1=b1, w_hh1=w_hh1)
    check_cuda("lstm2_bwd_chain_remat", packed.dtype,
               dict(packed=packed, x=x, x1=x1, h0p=h0p, h1p=h1p))
    plan, flags = _pair_launch("lstm2_bwd_chain_remat", 4, batch, h_dim, packed.device,
                               forward=False, remat_d=d_pad)
    units = plan.upc * plan.rgroups
    wg0 = gate_columns(torch.cat([w_x0, w_hh0]), units)
    wg1 = gate_columns(torch.cat([w_ih1, w_hh1]), units)
    new = dict(dtype=torch.float32, device=packed.device)
    # the kernel's CTAs exchange dg through these: the outputs, or in the
    # bf16 form float32 scratch beside them, layer 0's own rows in two slots
    # (layer 1's are the hop into layer 0, which runs behind); batch rows
    # apart, each launch from its first row
    dg0 = torch.empty((2 if half else t_len, batch, 4 * h_dim), **new)
    dg1 = torch.empty((t_len, batch, 4 * h_dim), **new)
    out = ([torch.empty_like(dg1, dtype=torch.bfloat16) for _ in range(2)]
           if half else [dg0, dg1])
    # one launch a slice of the batch (the whole batch where its gate
    # blocks fit), each over its rows of the series, batch rows apart
    rows = plan.batch_slice or batch
    for r0 in range(0, batch, rows):
        nb = min(rows, batch - r0)
        if r0:
            flags.zero_()
        # the dc carries, zeros; dh_final enters at layer 1's first step
        carry = torch.zeros((2, nb, h_dim), **new)

        def at(a: torch.Tensor) -> int:
            return a.data_ptr() + a.element_size() * r0 * a.shape[-1]

        ptrs = [at(packed), at(keep), at(dh), w_hh0.data_ptr(), w_hh1.data_ptr(),
                w_ih1.data_ptr(), at(x), at(x1), at(h0p), at(h1p), wg0.data_ptr(),
                wg1.data_ptr(), b0.data_ptr(), b1.data_ptr(), at(out[0]), at(out[1])]
        if half:
            ptrs += [at(dg0), at(dg1)]
        (LSTM2_BWD_CHAIN_REMAT_BF16 if half else LSTM2_BWD_CHAIN_REMAT)(
            *ptrs, carry.data_ptr(), flags.data_ptr(), nb, batch, t_len, h_dim, d_pad,
            plan.upc, plan.ncl, plan.rgroups, plan.kc, plan.rk, stream_of(packed),
        )
    return tuple(out)


def gate_columns(w: torch.Tensor, units: int) -> torch.Tensor:
    """An LSTM layer's stacked input and recurrent weights w (K, 4H) in
    the remat kernel's order: (H / units, K, 4 units), block k holding
    the gate columns q H + k units + u at q units + u, so each CTA's unit
    block is one contiguous (K, 4 units) matrix."""
    k_in, four_h = w.shape
    h_dim = four_h // 4
    return (w.reshape(k_in, 4, h_dim // units, units).permute(2, 0, 1, 3)
            .reshape(h_dim // units, k_in, 4 * units).contiguous())


# ---------------------------------------------------------------------------
# The 2-layer LSTM pair in the legacy layout (``set_res2_mode("off")``)
# ---------------------------------------------------------------------------


def lstm2_train_fwd_legacy_reference(x_tm: torch.Tensor, keep_tm: torch.Tensor,
                                     layer0: Params, layer1: Params):
    """Plain version of the legacy-layout training forward.

    x_tm (T, B, D) time-major, keep_tm (T, B, H) the layer-0 -> 1 keep
    mask -> ``(ys, h_final, g0, g1, h0_new, c0_new, c1_new)``, the JAX
    kernel's 7-tuple: the gate pre-activations (T, B, 4H) and the states
    AFTER each step (T, B, H), ``ys`` being h1's, ``h_final`` (B, H) the
    last.  Differentiable, so autograd through it is a plain reference for
    the legacy route's gradients.
    """
    ih0 = _input_projection(x_tm, layer0)
    keep = keep_tm.to(torch.float32)
    batch, h_dim = x_tm.shape[1], layer0["w_hh"].shape[0]
    h0 = c0 = h1 = c1 = ih0.new_zeros((batch, h_dim))
    series = ([], [], [], [], [], [])  # g0, g1, h0, h1, c0, c1
    for t in range(x_tm.shape[0]):
        g0 = ih0[t] + h0 @ layer0["w_hh"]
        h0, c0 = _cell(c0, g0)
        g1 = ((h0 * keep[t]) @ layer1["w_ih"] + layer1["b"]) + h1 @ layer1["w_hh"]
        h1, c1 = _cell(c1, g1)
        for out, val in zip(series, (g0, g1, h0, h1, c0, c1)):
            out.append(val)
    g0s, g1s, h0s, ys, c0s, c1s = (torch.stack(s) for s in series)
    return ys, h1, g0s, g1s, h0s, c0s, c1s


def lstm2_bwd_chain_legacy_reference(g0: torch.Tensor, g1: torch.Tensor,
                                     cp0: torch.Tensor, cp1: torch.Tensor, dys,
                                     keep_tm: torch.Tensor, dh_final: torch.Tensor,
                                     w_hh0: torch.Tensor, w_hh1: torch.Tensor,
                                     w_ih1: torch.Tensor):
    """Plain version of the legacy reverse chain: ``(dg0, dg1)``, each
    (T, B, 4H), over the separate gate (T, B, 4H) and c_prev (T, B, H)
    series; the walk of ``lstm2_bwd_chain_reference``, with ``dys`` (T, B,
    H, or ``None``: zeros) added to layer 1's dh at each step."""
    return _lstm2_chain(g0.shape[0], lambda t: (g0[t], g1[t], cp0[t], cp1[t]),
                        keep_tm, dh_final, w_hh0, w_hh1, w_ih1, dys)


LSTM2_TRAIN_FWD_LEGACY = CudaKernel(
    "lstm2_train_fwd_legacy", "lstm2_train_fwd_legacy_launch",
    [_P] * 13 + [_I] * 7 + [_P],
)
LSTM2_BWD_CHAIN_LEGACY = CudaKernel(
    "lstm2_bwd_chain_legacy", "lstm2_bwd_chain_legacy_launch",
    [_P] * 10 + [_I] * 7 + [_P],
)


def lstm2_train_fwd_legacy(x_tm: torch.Tensor, keep_tm: torch.Tensor,
                           layer0: Params, layer1: Params):
    """Legacy-layout training forward: x_tm (T, B, D), keep_tm (T, B, H)
    -> ``(ys, h_final, g0, g1, h0_new, c0_new, c1_new)``, float32; on the
    card the series are views of the kernel's one ``res`` (T, B, 12H).

    On a CUDA tensor this launches ``csrc/lstm2_train_fwd_legacy.cu`` (one
    cooperative cluster launch for the whole sequence on ``chain_plan_on``'s
    2-layer forward plan: layer 0 on one CTA set, layer 1 on another) and
    counts it in ``LSTM2_TRAIN_FWD_LEGACY.launches``; on a CPU tensor it
    runs ``lstm2_train_fwd_legacy_reference``.
    """
    if x_tm.device.type == "cpu":
        return lstm2_train_fwd_legacy_reference(x_tm, keep_tm, layer0, layer1)
    tensors, (t_len, batch, h_dim) = _lstm2_fwd_inputs(
        "lstm2_train_fwd_legacy", x_tm, keep_tm, layer0, layer1)
    new = dict(dtype=torch.float32, device=x_tm.device)
    res = torch.empty((t_len, batch, 12 * h_dim), **new)
    h_final = torch.empty((batch, h_dim), **new)
    # the layout holds no state before a step and no x1: the kernel's CTAs
    # exchange h through these scratch series
    h0p, h1p, x1 = (torch.empty((t_len, batch, h_dim), **new) for _ in range(3))
    carry = torch.zeros((2, batch, h_dim), **new)
    plan, flags = _pair_launch("lstm2_train_fwd_legacy", 4, batch, h_dim, x_tm.device,
                               forward=True)
    LSTM2_TRAIN_FWD_LEGACY(
        *(t.data_ptr() for t in tensors), res.data_ptr(), h_final.data_ptr(),
        h0p.data_ptr(), h1p.data_ptr(), x1.data_ptr(), carry.data_ptr(),
        flags.data_ptr(), batch, t_len, h_dim, plan.upc, plan.ncl, plan.rgroups,
        plan.kc, stream_of(x_tm),
    )
    g0, g1, h0, ys, c0, c1 = res.split([4 * h_dim, 4 * h_dim] + [h_dim] * 4, dim=-1)
    return ys, h_final, g0, g1, h0, c0, c1


def lstm2_bwd_chain_legacy(g0: torch.Tensor, g1: torch.Tensor, cp0: torch.Tensor,
                           cp1: torch.Tensor, dys, keep_tm: torch.Tensor,
                           dh_final: torch.Tensor, w_hh0: torch.Tensor,
                           w_hh1: torch.Tensor, w_ih1: torch.Tensor):
    """Legacy reverse chain: ``(dg0, dg1)``, each (T, B, 4H) float32; on
    the card views of the kernel's one ``dg`` (T, B, 8H).  ``dys`` (T, B,
    H) is the sequence output's cotangent, or ``None``, and then the kernel
    reads no stream.  On the card the gate and c_prev series are packed
    into one (T, B, 10H) ``[g0 | g1 | c0_prev | c1_prev]`` as
    ``lstm2_bwd_chain`` reads it.

    On a CUDA tensor this launches ``csrc/lstm2_bwd_chain_legacy.cu`` (one
    cooperative cluster launch on ``chain_plan_on``'s 2-layer plan: layer 1
    on one CTA set, layer 0 on another) and counts it in
    ``LSTM2_BWD_CHAIN_LEGACY.launches``; on a CPU tensor it runs
    ``lstm2_bwd_chain_legacy_reference``.
    """
    if g0.device.type == "cpu":
        return lstm2_bwd_chain_legacy_reference(g0, g1, cp0, cp1, dys, keep_tm,
                                                dh_final, w_hh0, w_hh1, w_ih1)
    if g0.dim() != 3:
        raise ValueError(f"lstm2_bwd_chain_legacy: g0 has shape {tuple(g0.shape)}, "
                         "expected (T, B, 4H)")
    t_len, batch, _ = g0.shape
    h_dim = w_hh0.shape[0]
    series, gates, square = (t_len, batch, h_dim), (t_len, batch, 4 * h_dim), (h_dim, 4 * h_dim)
    tensors = dict(
        keep=keep_tm.to(torch.float32).contiguous(),
        dh_final=dh_final.to(torch.float32).contiguous(), w_hh0=w_hh0.contiguous(),
        w_hh1=w_hh1.contiguous(), w_ih1=w_ih1.contiguous())
    shapes = dict(keep=series, dh_final=(batch, h_dim), w_hh0=square, w_hh1=square,
                  w_ih1=square)
    if dys is not None:
        tensors["dys"] = dys.to(torch.float32).contiguous()
        shapes["dys"] = series
    _check_shapes("lstm2_bwd_chain_legacy", g0=(g0, gates), g1=(g1, gates),
                  cp0=(cp0, series), cp1=(cp1, series),
                  **{k: (tensors[k], shapes[k]) for k in tensors})
    if t_len < 1 or batch < 1:
        raise ValueError(f"lstm2_bwd_chain_legacy: empty residuals {tuple(g0.shape)}")
    tensors["packed"] = torch.cat([a.to(torch.float32) for a in (g0, g1, cp0, cp1)],
                                  dim=-1)
    device = g0.device
    dg = torch.empty((t_len, batch, 8 * h_dim), dtype=torch.float32, device=device)
    check_cuda_f32("lstm2_bwd_chain_legacy", **tensors)
    ptr = {k: t.data_ptr() for k, t in tensors.items()}
    plan, flags = _pair_launch("lstm2_bwd_chain_legacy", 4, batch, h_dim, device,
                               forward=False)
    # the dc carries, zeros; dh_final enters at layer 1's first step
    carry = torch.zeros((2, batch, h_dim), dtype=torch.float32, device=device)
    LSTM2_BWD_CHAIN_LEGACY(
        ptr["packed"], ptr.get("dys"), ptr["keep"], ptr["dh_final"], ptr["w_hh0"],
        ptr["w_hh1"], ptr["w_ih1"], dg.data_ptr(), carry.data_ptr(), flags.data_ptr(),
        batch, t_len, h_dim, plan.upc, plan.ncl, plan.rgroups, plan.kc, stream_of(dg),
    )
    return dg[..., :4 * h_dim], dg[..., 4 * h_dim:]


# ---------------------------------------------------------------------------
# One layer per launch: training forward, its eval form, reverse chain
# ---------------------------------------------------------------------------


def lstm1_train_fwd_reference(ih: torch.Tensor, w_hh: torch.Tensor,
                              res_dtype: torch.dtype = torch.float32):
    """Plain version of one layer's training forward.

    ih (T, B, 4H) the hoisted input projection -> ``(g (T, B, 4H),
    h_prev (T, B, H), c_prev (T, B, H), finals (B, 2H) = [h | c])``: the
    gate pre-activations and the state before each step, from zero state;
    ``g`` and ``c_prev`` rounded to ``res_dtype``, ``h_prev`` and the finals
    float32.  Differentiable, so autograd through it is a plain reference
    for the layered gradient.
    """
    batch, h_dim = ih.shape[1], w_hh.shape[0]
    h = c = ih.new_zeros((batch, h_dim))
    gs, hps, cps = [], [], []
    for t in range(ih.shape[0]):
        g = ih[t] + h @ w_hh
        gs.append(g)
        hps.append(h)
        cps.append(c)
        h, c = _cell(c, g)
    return (_stored(torch.stack(gs), res_dtype), torch.stack(hps),
            _stored(torch.stack(cps), res_dtype), torch.cat([h, c], dim=-1))


def h_series(h_prev: torch.Tensor, finals: torch.Tensor) -> torch.Tensor:
    """The h after each step (T, B, H) from a training forward's residuals:
    h after step t is h_prev(t+1), and after step T-1 the final h."""
    return torch.cat([h_prev[1:], finals[None, :, :h_prev.shape[2]]])


def lstm1_infer_reference(ih: torch.Tensor, w_hh: torch.Tensor,
                          want_series: bool) -> torch.Tensor:
    """Plain version of the eval form: the h series (T, B, H) after each
    step, or only the final h (B, H)."""
    _, h_prev, _, finals = lstm1_train_fwd_reference(ih, w_hh)
    return h_series(h_prev, finals) if want_series else finals[:, :w_hh.shape[0]]


def lstm_bwd_chain_reference(g: torch.Tensor, c_prev: torch.Tensor,
                             dh_series, dh_final: torch.Tensor,
                             w_hh: torch.Tensor) -> torch.Tensor:
    """Plain version of one layer's reverse chain: dgates (T, B, 4H)
    float32, over ``g`` and ``c_prev`` in float32 or bf16 (read into
    float32).

    Walks t = T-1 .. 0 with carries dh (``dh_final`` at the start) and dc
    (zero): ``(dg, dc) = cell_bwd(g[t], c_prev[t], dh + dh_series[t], dc)``,
    ``dh = dg w_hh^T``.  ``dh_series=None`` means zeros (the top layer of
    a final-hidden-only stack).
    """
    dh = dh_final.to(torch.float32)
    dc = torch.zeros_like(dh)
    dgs = []
    for t in reversed(range(g.shape[0])):
        dh_t = dh if dh_series is None else dh + dh_series[t]
        dg, dc = _cell_bwd(_read(g[t]), _read(c_prev[t]), dh_t, dc)
        dh = dg @ w_hh.T
        dgs.append(dg)
    return torch.stack(dgs[::-1])


LSTM1_TRAIN_FWD = CudaKernel(
    "lstm1_fwd", "lstm1_fwd_train_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)
LSTM1_INFER = CudaKernel(
    "lstm1_fwd", "lstm1_fwd_infer_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
)
LSTM_BWD_CHAIN = CudaKernel(
    "lstm_bwd_chain", "lstm_bwd_chain_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)
# the bf16 forms of the same sources, counted apart
LSTM1_TRAIN_FWD_BF16 = CudaKernel(
    "lstm1_fwd", "lstm1_fwd_train_bf16_launch", [_P] * 8 + [_I] * 7 + [_P],
)
LSTM_BWD_CHAIN_BF16 = CudaKernel(
    "lstm_bwd_chain", "lstm_bwd_chain_bf16_launch", [_P] * 8 + [_I] * 7 + [_P],
)


# The recurrent cores' launch plan (csrc/rnn_bwd_chain.cuh for the one-layer
# reverse chains, csrc/rnn_fwd_chain.cuh for the one-layer forwards,
# csrc/rnn2_bwd_chain.cuh and csrc/rnn2_fwd_chain.cuh for the 2-layer ones,
# which re-check it against the card); the constants are the cores'.
CHAIN_NT = 256   # threads per CTA
CHAIN_PH = 8     # batch rows per pass
CHAIN_NU_MAX = 64  # units per cluster the kernels are built for
CHAIN_FLAGS = 4 * 256  # barrier flags of a CTA set: 256 words for each of <= 4 row groups


@dataclass(frozen=True)
class ChainPlan:
    """How one layer's reverse chain (``forward`` false) or forward is
    split on the card, or with ``layers`` 2 both layers' in one launch.

    ``grid = hidden / upc`` CTAs a layer, one per SM, in clusters of
    ``ncl``.  Cluster ``k = c // ncl`` serves row group ``k % rgroups``
    (``rows``: a contiguous ``ceil(B / rgroups)`` of the batch, in passes
    of ``CHAIN_PH``) and unit block ``k // rgroups`` (``cluster_units``,
    ``ncl * rgroups * upc`` units).  CTA ``c`` runs the cell of ``units(c)``
    and forms the partial products of the cluster's ``outputs`` over
    ``share(c % ncl)``, its float4 columns of the exchanged row, loaded in
    chunks of ``kc`` float4 columns; ``smem`` bytes of shared memory per
    CTA.  The product geometry: the reverse chain exchanges a ``width *
    hidden`` row and forms one sum a unit (dh); the forward exchanges the
    ``hidden`` row of h and forms ``width`` sums a unit (its gate
    columns).

    A 2-layer plan launches ``ctas = 2 grid``: CTA ``c < grid`` is the
    lead set's (the layer that needs no other: layer 1 of the reverse
    chain, layer 0 of the forward), ``c >= grid`` the follow set's, whose
    CTA ``c - grid`` has the lead's geometry over a row twice as wide: its
    own row, then the feed (the other layer's), ``share(rank, follow=True)``;
    a share's columns of each half form that half's sums.

    The remat chain's plan (``remat_d`` given to ``chain_plan``) also sets
    ``rk``, the steps of a gate block (``REMAT_KS``), with the blocks in
    ``smem``, and, where the blocks of the whole batch do not fit,
    ``batch_slice``: the rows a launch takes (the wrapper launches on
    slices of the batch, each an independent chain)."""

    hidden: int
    width: int
    upc: int
    ncl: int
    rgroups: int
    kc: int
    smem: int
    forward: bool = False
    layers: int = 1
    rk: int = 0
    batch_slice: int = 0

    @property
    def grid(self) -> int:
        return self.hidden // self.upc

    @property
    def ctas(self) -> int:
        """CTAs of the launch: a set of ``grid`` a layer."""
        return self.layers * self.grid

    @property
    def cluster_width(self) -> int:
        return self.ncl * self.rgroups * self.upc

    @property
    def outputs(self) -> int:
        """The sums a cluster forms per row: its units', or their gate columns'."""
        return self.cluster_width * (self.width if self.forward else 1)

    @property
    def exchanged(self) -> int:
        """Floats of the row each step exchanges."""
        return self.hidden if self.forward else self.width * self.hidden

    def share(self, rank: int, follow: bool = False) -> range:
        """Float4 columns of the row (the follow set's: own, then feed)."""
        n4 = self.exchanged * (2 if follow else 1) // 4
        return range(rank * n4 // self.ncl, (rank + 1) * n4 // self.ncl)

    def rows(self, cta: int, batch: int) -> range:
        bg = _ceil(batch, self.rgroups)
        b0 = min(batch, cta % self.grid // self.ncl % self.rgroups * bg)
        return range(b0, min(batch, b0 + bg))

    def cluster_units(self, cta: int) -> range:
        nu, k = self.cluster_width, cta % self.grid // self.ncl // self.rgroups
        return range(k * nu, (k + 1) * nu)

    def units(self, cta: int) -> range:
        per_cta = self.rgroups * self.upc
        u0 = self.cluster_units(cta).start + cta % self.ncl * per_cta
        return range(u0, u0 + per_cta)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _unit_block(nu: int, forward: bool) -> int:
    """Units per thread of the products: 8 in the reverse chain (one sum
    each), 2 in the forward (``width`` gate columns each)."""
    return min(nu, 2 if forward else 8)


def _column_slices(nu: int, forward: bool = False) -> int:
    """The products' float4 column slices for a cluster of ``nu`` units:
    the threads of one column group, 256 over ``nu / unit block`` groups."""
    return CHAIN_NT // (nu // _unit_block(nu, forward))


def remat_gate_floats(hidden: int, upc: int, rgroups: int, batch: int, din: int,
                      rk: int, half: bool = False) -> int:
    """Shared memory of one set's gate blocks in the remat chain, in floats,
    as ``rnn2_bwd::GateGeom``: a CTA's ``4 upc rgroups`` gate columns over
    its row group's rows padded to whole passes for ``rk`` steps, twice
    (the block in use and the one being formed), and one piece of the
    ``din + hidden`` deep product (``kp`` deep: whole 16-byte pieces of its
    inputs, a multiple of 4, or in the bf16 form (``half``) of 8): its
    input rows (stride 4 mod 8 floats; a bf16 row takes ``kp / 2``) and
    weight rows; and 4 floats for the bulk copies' transaction barrier."""
    vec = 8 if half else 4
    n = 4 * upc * rgroups
    bgp = _ceil(_ceil(batch, rgroups), CHAIN_PH) * CHAIN_PH
    m = rk * bgp
    kp = _ceil(_ceil(din + hidden, rk), vec) * vec
    ldi = _ceil(kp // 2 if half else kp, 8) * 8 + 4
    return 2 * m * n + m * ldi + kp * n + 4


def chain_smem_floats(width: int, hidden: int, upc: int, ncl: int, rgroups: int,
                      kc: int, forward: bool = False, layers: int = 1,
                      remat=None) -> int:
    """Shared memory of a plan in floats, as ``rnn_bwd::smem_floats``,
    ``rnn_fwd::smem_floats`` and, for ``layers`` 2, ``rnn2_bwd::`` /
    ``rnn2_fwd::smem_floats``: the weights, the chunk slots, the warps' and
    the cluster's partial sums (the forward keeps no warps' partials where
    a column group is one warp or less).  A 2-layer plan's buffers are the
    follow set's: a share of a row twice as wide, and the cluster's
    partials of each half.

    ``remat = (batch, d_in, rk)``: the remat chain's rule
    (``rnn2_bwd::remat_smem_floats``), the larger of the follow set's
    buffers with layer 0's gate blocks (``d_in`` deep inputs) and the lead
    set's, whose weights cover only its own share, with layer 1's (H
    deep); the plan serves both forms of the source, so each set's blocks
    are the larger of the float32 form's and the bf16 form's (at the
    flagship's shape the float32 form's)."""
    nu = upc * ncl * rgroups
    outputs, n4 = (width * nu, hidden // 4) if forward else (nu, width * hidden // 4)
    cs4 = _ceil(layers * n4, ncl)
    chunks = _ceil(cs4, kc)
    slots = chunks if chunks <= 8 else 2
    ldw = _ceil(4 * cs4, 32) * 32 + 4
    ldx = _ceil(4 * kc, 32) * 32 + 4
    warps = max(1, _column_slices(nu, forward) // 32)
    part = warps * CHAIN_PH * outputs if warps > 1 or not forward else 0
    total = (outputs * ldw + slots * CHAIN_PH * ldx + part
             + 2 * layers * CHAIN_PH * outputs)
    if remat is None:
        return total
    batch, d_in, rk = remat
    lead = total - outputs * (ldw - (_ceil(4 * _ceil(n4, ncl), 32) * 32 + 4))

    def blocks(din: int) -> int:
        return max(remat_gate_floats(hidden, upc, rgroups, batch, din, rk, half)
                   for half in (False, True))

    return max(total + blocks(d_in), lead + blocks(hidden))


def _row_groups_order(batch: int) -> Tuple[int, ...]:
    """The row-group counts a plan tries, best first.  A group takes its
    rows in passes of ``CHAIN_PH``, so the fewest passes a group come
    first; where two groups need no more passes than four (B <= 16), two
    come first: on the H100 they beat four and one at B = 1..16 on rows
    4, 7, 6 and 7f (``chain_ab.py --sweep``; a step's barrier spans half
    the grid, and four groups of a few rows form products for empty
    rows)."""
    return (2, 4, 1) if batch <= 2 * CHAIN_PH else (4, 2, 1)


# the remat chain's steps a gate block, the first that fits taken
REMAT_KS = (8, 4, 2)


def chain_plan(hidden: int, width: int, batch: int, sms: int, max_smem: int,
               active_clusters: Callable[[int, int, int, int], int],
               forward: bool = False, layers: int = 1, remat_d: int = 0) -> ChainPlan:
    """The launch plan of one layer's reverse chain (``forward`` false) or
    forward (``width`` 4: LSTM, 3: GRU) on a card of ``sms`` SMs and
    ``max_smem`` bytes of shared memory per block, or with ``layers`` 2 of
    both layers' in one launch (``ChainPlan``); ``active_clusters(upc,
    ncl, rgroups, kc)`` is how many clusters of that plan's kernel the
    card holds at once.

    UPC is the fewest units per CTA (1, 2, 4, 8) that keep the grid (a set
    of H / UPC CTAs a layer) within one CTA per SM.  The cluster size is the largest of 8, 4, 2, 1 that
    divides the grid and for which some row-group count fits; the row
    groups the first of ``_row_groups_order(batch)`` that divide the
    clusters' grid and whose weights fit beside a chunk of the share, at
    most 64 units a cluster, with the whole grid resident at once.  The chunk is the largest multiple of the
    products' column slices that fits (the whole share where it fits: on
    the H100, one chunk beat four, ``chain_ab.py --sweep``), else a ring
    of two chunks of a ninth of the share or less.  Shared memory is
    padded past half an SM's, so one CTA fits an SM.  With ``remat_d``
    (the remat chain's padded input width: 2 layers, reverse, width 4) the
    plan is the stored-gates chain's with the gate blocks
    (``chain_smem_floats``' ``remat``) of the first of ``REMAT_KS`` steps
    that fits beside it (any plan whose blocks fit, where none fit beside
    it even for one row); the blocks grow with the batch, so where they do
    not fit for the whole batch, the plan is that of the batch's fewest
    equal slices that fit (``batch_slice``, one launch each).  Raises
    ``ValueError`` for a shape no plan takes.
    """
    if (batch < 1 or hidden < 4 or hidden % 4 or layers not in (1, 2)
            or (remat_d and (layers != 2 or forward or width != 4 or remat_d % 4))):
        raise ValueError(f"chain_plan: no plan for B={batch}, H={hidden} (H % 4 == 0), "
                         f"{layers} layers" + (f", remat D={remat_d}" if remat_d else ""))
    upc = next((u for u in (1, 2, 4, 8)
                if hidden % u == 0 and layers * (hidden // u) <= sms), None)
    if upc is None:
        raise ValueError(f"chain_plan: {layers} x H={hidden} needs more than 8 units "
                         f"per CTA on {sms} SMs")
    grid = hidden // upc

    def need(ncl: int, rgroups: int, kc: int, rows: int, rk: int) -> int:
        remat = (rows, remat_d, rk) if rk else None
        return 4 * chain_smem_floats(width, hidden, upc, ncl, rgroups, kc, forward, layers,
                                     remat)

    def search(rows: int, ks: Tuple[int, ...]):
        """The first plan for ``rows`` whose buffers fit with gate blocks
        of one of ``ks`` steps (0: none)."""
        for ncl in (8, 4, 2, 1):
            for rgroups in _row_groups_order(rows):
                nu = ncl * rgroups * upc
                if grid % (ncl * rgroups) or nu > CHAIN_NU_MAX:
                    continue
                # the widest share: a 2-layer plan's follow set's
                cs4 = _ceil(layers * (hidden if forward else width * hidden) // 4, ncl)
                ks4 = _column_slices(nu, forward)
                blocks = _ceil(cs4, ks4)
                # whole column slices per chunk where they fit, else a ring of
                # two chunks of any width
                widths = [min(cs4, ks4 * _ceil(blocks, m)) for m in range(1, blocks + 1)]
                widths += [_ceil(cs4, m) for m in range(9, cs4 + 1)]
                fits = ((kc, rk) for kc in dict.fromkeys(widths) for rk in ks
                        if need(ncl, rgroups, kc, rows, rk) <= max_smem)
                kc, rk = next(fits, (None, 0))
                if kc is None or active_clusters(upc, ncl, rgroups, kc) * ncl < layers * grid:
                    continue
                return ChainPlan(hidden, width, upc, ncl, rgroups, kc,
                                 max(need(ncl, rgroups, kc, rows, rk), max_smem // 2 + 2048),
                                 forward, layers, rk)
        return None

    if not remat_d:
        plan = search(batch, (0,))
    else:
        def kept(rows: int):
            """The stored-gates chain's plan for ``rows`` with the first
            gate blocks that fit beside it."""
            p = search(rows, (0,))
            rk = next((k for k in REMAT_KS if p is not None
                       and need(p.ncl, p.rgroups, p.kc, rows, k) <= max_smem), 0)
            return None if not rk else replace(
                p, rk=rk, smem=max(need(p.ncl, p.rgroups, p.kc, rows, rk),
                                   max_smem // 2 + 2048))

        # the remat chain keeps the stored-gates chain's plan: on the H100
        # a second pass or a ring of chunks to make room for the blocks cost
        # more than another launch (chain_ab.py --sweep); only where no
        # blocks fit beside it even for one row, any plan whose blocks fit
        fit = kept if kept(1) is not None else (lambda rows: search(rows, REMAT_KS))
        plan = fit(batch)
        if plan is None and batch > 1 and fit(1) is not None:
            # the blocks grow with a row group's rows: the most rows that
            # fit (fewer always do), and the batch in equal slices of at
            # most that many, one launch each
            lo, hi = 1, batch - 1
            while lo < hi:
                mid = (lo + hi + 1) // 2
                lo, hi = (mid, hi) if fit(mid) is not None else (lo, mid - 1)
            rows = _ceil(batch, _ceil(batch, lo))
            plan = replace(fit(rows), batch_slice=rows)
    if plan is None:
        raise ValueError(f"chain_plan: no cluster size fits {layers} x H={hidden} on "
                         "this card")
    return plan


_CHAIN_PLANS: Dict[Tuple[int, str, int, Tuple[int, ...]], ChainPlan] = {}


def chain_plan_on(source: str, width: int, hidden: int, batch: int,
                  device: torch.device, forward: bool = False,
                  layers: int = 1, remat_d: int = 0) -> ChainPlan:
    """``chain_plan`` for ``csrc/<source>.cu``'s kernel on ``device``, its
    SM count, shared memory and resident cluster counts read from the CUDA
    runtime through the library; cached per card, source, H and the
    batch's row-group order (the remat chain's, whose gate blocks grow
    with the rows, per batch and ``remat_d``)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, source, hidden,
           (batch, remat_d) if remat_d else _row_groups_order(batch))
    plan = _CHAIN_PLANS.get(key)
    if plan is None:
        lib = load(source)
        with torch.cuda.device(index):
            sms, smem = ctypes.c_int(0), ctypes.c_int(0)
            card = getattr(lib, f"{source}_card")
            card.argtypes = [_P, _P]
            _chain_check(lib, source, card(ctypes.byref(sms), ctypes.byref(smem)))
            fn = getattr(lib, f"{source}_max_clusters")
            fn.argtypes = [_I, _I, _I, _I, _I, _P]

            def active(upc: int, ncl: int, rgroups: int, kc: int) -> int:
                count = ctypes.c_int(0)
                _chain_check(lib, source,
                             fn(hidden, upc, ncl, rgroups, kc, ctypes.byref(count)))
                return count.value

            plan = chain_plan(hidden, width, batch, sms.value, smem.value, active,
                              forward, layers, remat_d)
        _CHAIN_PLANS[key] = plan
    return plan


def _chain_check(lib, source: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{source}_error_string")
        msg.argtypes, msg.restype = [_I], ctypes.c_char_p
        raise RuntimeError(f"{source}: {msg(err).decode()} (code {err})")


def _layer_shapes(name: str, ih: torch.Tensor, w_hh: torch.Tensor, gates: int = 4):
    if ih.dim() != 3:
        raise ValueError(
            f"{name}: ih has shape {tuple(ih.shape)}, expected (T, B, {gates}H)")
    t_len, batch, _ = ih.shape
    h_dim = w_hh.shape[0]
    _check_shapes(name, ih=(ih, (t_len, batch, gates * h_dim)),
                  w_hh=(w_hh, (h_dim, gates * h_dim)))
    if t_len < 1 or batch < 1:
        raise ValueError(f"{name}: empty input of shape {tuple(ih.shape)}")
    return t_len, batch, h_dim


def _fwd_launch(source: str, width: int, batch: int, h_dim: int,
                device: torch.device):
    """A forward launch's plan, its carry (B, H) and the row groups'
    barrier flags, both zeros -> ``(plan, carry, flags)``."""
    plan = chain_plan_on(source, width, h_dim, batch, device, forward=True)
    carry = torch.zeros((batch, h_dim), dtype=torch.float32, device=device)
    flags = torch.zeros(CHAIN_FLAGS, dtype=torch.int32, device=device)
    return plan, carry, flags


def lstm1_train_fwd(ih: torch.Tensor, w_hh: torch.Tensor,
                    res_dtype: torch.dtype = torch.float32):
    """One layer's training forward: ih (T, B, 4H), w_hh (H, 4H) ->
    ``(g, h_prev, c_prev, finals)``: ``g`` and ``c_prev`` in ``res_dtype``
    (float32 or bf16), ``h_prev`` and ``finals`` float32.

    On a CUDA tensor this launches ``csrc/lstm1_fwd.cu`` (one cooperative
    cluster launch for the whole sequence on ``chain_plan_on``'s forward
    plan) and counts it in ``LSTM1_TRAIN_FWD.launches``, its bf16 form in
    ``LSTM1_TRAIN_FWD_BF16.launches``; on a CPU tensor it runs
    ``lstm1_train_fwd_reference``.
    """
    half = residual_dtype(res_dtype) == torch.bfloat16
    if ih.device.type == "cpu":
        return lstm1_train_fwd_reference(ih, w_hh, res_dtype)
    t_len, batch, h_dim = _layer_shapes("lstm1_train_fwd", ih, w_hh)
    ih, w_hh = ih.contiguous(), w_hh.contiguous()
    new = dict(dtype=torch.float32, device=ih.device)
    res = dict(new, dtype=torch.bfloat16 if half else torch.float32)
    g = torch.empty((t_len, batch, 4 * h_dim), **res)
    h_prev = torch.empty((t_len, batch, h_dim), **new)
    c_prev = torch.empty((t_len, batch, h_dim), **res)
    finals = torch.empty((batch, 2 * h_dim), **new)
    check_cuda_f32("lstm1_train_fwd", ih=ih, w_hh=w_hh)
    plan, carry, flags = _fwd_launch("lstm1_fwd", 4, batch, h_dim, ih.device)
    (LSTM1_TRAIN_FWD_BF16 if half else LSTM1_TRAIN_FWD)(
        ih.data_ptr(), w_hh.data_ptr(), g.data_ptr(), h_prev.data_ptr(),
        c_prev.data_ptr(), finals.data_ptr(), carry.data_ptr(), flags.data_ptr(),
        batch, t_len, h_dim, plan.upc, plan.ncl, plan.rgroups, plan.kc, stream_of(ih),
    )
    return g, h_prev, c_prev, finals


def _lstm1_infer_launch(ih: torch.Tensor, w_hh: torch.Tensor,
                        want_series: bool) -> torch.Tensor:
    """The CUDA kernel of ``med_torch::lstm1_infer``."""
    t_len, batch, h_dim = _layer_shapes("lstm1_infer", ih, w_hh)
    ih, w_hh = ih.contiguous(), w_hh.contiguous()
    # the kernel's blocks exchange h through ``out``: the series itself,
    # or two slots used in turn when only the final h is wanted
    slots = t_len if want_series else 2
    out = torch.empty((slots, batch, h_dim), dtype=torch.float32, device=ih.device)
    check_cuda_f32("lstm1_infer", ih=ih, w_hh=w_hh)
    plan, carry, flags = _fwd_launch("lstm1_fwd", 4, batch, h_dim, ih.device)
    LSTM1_INFER(ih.data_ptr(), w_hh.data_ptr(), out.data_ptr(), carry.data_ptr(),
                flags.data_ptr(), batch, t_len, h_dim, int(want_series), plan.upc,
                plan.ncl, plan.rgroups, plan.kc, stream_of(ih))
    return out if want_series else out[(t_len - 1) % 2].clone()


def _layer_infer_fake(ih: torch.Tensor, w_hh: torch.Tensor, *rest) -> torch.Tensor:
    """Shape and dtype of a one-layer eval form: ``rest`` ends with
    ``want_series``."""
    t_len, batch, h_dim = ih.shape[0], ih.shape[1], w_hh.shape[0]
    shape = (t_len, batch, h_dim) if rest[-1] else (batch, h_dim)
    return ih.new_empty(shape, dtype=torch.float32)


LSTM1_INFER_OP = kernel_op(
    "lstm1_infer", "(Tensor ih, Tensor w_hh, bool want_series) -> Tensor",
    cpu=lambda ih, w_hh, want_series: lstm1_infer_reference(
        ih, w_hh, want_series).contiguous(),
    cuda=_lstm1_infer_launch, fake=_layer_infer_fake)


def lstm1_infer(ih: torch.Tensor, w_hh: torch.Tensor,
                want_series: bool) -> torch.Tensor:
    """Eval form of ``lstm1_train_fwd``: ih (T, B, 4H) -> the h series
    (T, B, H) (the next layer's input) or, with ``want_series`` false, the
    final h (B, H).  It stores no gates and no cell states.

    Calls ``med_torch::lstm1_infer``: on a CUDA tensor it launches
    ``csrc/lstm1_fwd.cu``'s eval entry (on the training form's plan) and
    counts it in ``LSTM1_INFER.launches``; on a CPU tensor it runs
    ``lstm1_infer_reference``.
    """
    return LSTM1_INFER_OP(ih, w_hh, bool(want_series))


def lstm_bwd_chain(g: torch.Tensor, c_prev: torch.Tensor, dh_series,
                   dh_final: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """One layer's reverse dgates chain: dgates (T, B, 4H) float32.

    ``g`` (T, B, 4H) and ``c_prev`` (T, B, H) are ``lstm1_train_fwd``'s
    residuals, both float32 or both bf16 (the bf16 form), ``dh_series``
    (T, B, H) the per-step cotangent from the layer above (``None``: zeros,
    and the kernel reads nothing), ``dh_final`` (B, H) the final hidden
    state's.  On a CUDA tensor this launches ``csrc/lstm_bwd_chain.cu`` (one
    cooperative cluster launch on ``chain_plan_on``'s plan) and counts it in
    ``LSTM_BWD_CHAIN.launches``, its bf16 form in
    ``LSTM_BWD_CHAIN_BF16.launches``; on a CPU tensor it runs
    ``lstm_bwd_chain_reference``.
    """
    if g.device.type == "cpu":
        return lstm_bwd_chain_reference(g, c_prev, dh_series, dh_final, w_hh)
    half = _half("lstm_bwd_chain", g, c_prev)
    if g.dim() != 3:
        raise ValueError(f"lstm_bwd_chain: g has shape {tuple(g.shape)}, expected (T, B, 4H)")
    t_len, batch, _ = g.shape
    h_dim = w_hh.shape[0]
    series = (t_len, batch, h_dim)
    dh = dh_final.to(torch.float32).contiguous()
    g, c_prev, w_hh = g.contiguous(), c_prev.contiguous(), w_hh.contiguous()
    shaped = dict(g=(g, (t_len, batch, 4 * h_dim)), c_prev=(c_prev, series),
                  dh_final=(dh, (batch, h_dim)), w_hh=(w_hh, (h_dim, 4 * h_dim)))
    tensors = dict(dh_final=dh, w_hh=w_hh)
    check_cuda("lstm_bwd_chain", g.dtype, dict(g=g, c_prev=c_prev))
    if dh_series is not None:
        dh_series = dh_series.to(torch.float32).contiguous()
        shaped["dh_series"] = (dh_series, series)
        tensors["dh_series"] = dh_series
    _check_shapes("lstm_bwd_chain", **shaped)
    if t_len < 1 or batch < 1:
        raise ValueError(f"lstm_bwd_chain: empty residuals {tuple(g.shape)}")
    dg = torch.empty((t_len, batch, 4 * h_dim), dtype=torch.float32, device=g.device)
    check_cuda_f32("lstm_bwd_chain", **tensors)
    plan = chain_plan_on("lstm_bwd_chain", 4, h_dim, batch, g.device)
    # the dc carry, and the row groups' barrier flags
    carry = torch.zeros((batch, h_dim), dtype=torch.float32, device=g.device)
    flags = torch.zeros(CHAIN_FLAGS, dtype=torch.int32, device=g.device)
    (LSTM_BWD_CHAIN_BF16 if half else LSTM_BWD_CHAIN)(
        g.data_ptr(), c_prev.data_ptr(),
        dh_series.data_ptr() if dh_series is not None else None,
        dh.data_ptr(), w_hh.data_ptr(), dg.data_ptr(), carry.data_ptr(),
        flags.data_ptr(), batch, t_len, h_dim, plan.upc, plan.ncl,
        plan.rgroups, plan.kc, stream_of(g),
    )
    return dg


# ---------------------------------------------------------------------------
# GRU, two layers per launch: serving, training forward, reverse chain
# ---------------------------------------------------------------------------

GRU_RES2_W = 8  # packed residual width in units of H: [r|z|n|hn] x 2 layers


def _gru_step(h: torch.Tensor, ih_t: torch.Tensor, w_hh: torch.Tensor,
              b_hh: torch.Tensor):
    """One GRU step -> ``(h_new, r, z, n, hn)``.  ``b_hh`` stays beside
    ``h @ w_hh``: its n third sits inside the reset product."""
    hh = h @ w_hh + b_hh
    xr, xz, xn = ih_t.chunk(3, dim=-1)
    hr, hz, hn = hh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h, r, z, n, hn


def _gru_input_projection(x: torch.Tensor, layer0: Params) -> torch.Tensor:
    return torch.matmul(x.to(torch.float32), layer0["w_ih"]) + layer0["b_ih"]


def gru2_infer_reference(x: torch.Tensor, layer0: Params, layer1: Params) -> torch.Tensor:
    """Plain version: x (B, T, D) -> final h of layer 1 (B, H), one step of
    each layer at a time."""
    ih0 = _gru_input_projection(x, layer0)
    batch, h_dim = x.shape[0], layer0["w_hh"].shape[0]
    h0 = h1 = ih0.new_zeros((batch, h_dim))
    for t in range(x.shape[1]):
        h0 = _gru_step(h0, ih0[:, t], layer0["w_hh"], layer0["b_hh"])[0]
        ih1 = h0 @ layer1["w_ih"] + layer1["b_ih"]
        h1 = _gru_step(h1, ih1, layer1["w_hh"], layer1["b_hh"])[0]
    return h1


def gru2_train_fwd_reference(x_tm: torch.Tensor, keep_tm: torch.Tensor,
                             layer0: Params, layer1: Params,
                             res_dtype: torch.dtype = torch.float32):
    """Plain version of the GRU training forward.

    x_tm (T, B, D) time-major, keep_tm (T, B, H) the layer-0 -> 1 keep mask
    -> ``(packed, h0_prev, h1_prev, x1, finals)`` in the module's GRU
    residual layout, the series rounded to ``res_dtype``, the finals
    float32.  Differentiable, so autograd through it is a plain reference
    for the kernel pair's gradients.
    """
    ih0 = _gru_input_projection(x_tm, layer0)
    keep = keep_tm.to(torch.float32)
    batch, h_dim = x_tm.shape[1], layer0["w_hh"].shape[0]
    h0 = h1 = ih0.new_zeros((batch, h_dim))
    packed, h0p, h1p, x1s = [], [], [], []
    for t in range(x_tm.shape[0]):
        h0n, r0, z0, n0, hn0 = _gru_step(h0, ih0[t], layer0["w_hh"], layer0["b_hh"])
        x1 = h0n * keep[t]
        ih1 = x1 @ layer1["w_ih"] + layer1["b_ih"]
        h1n, r1, z1, n1, hn1 = _gru_step(h1, ih1, layer1["w_hh"], layer1["b_hh"])
        packed.append(torch.cat([r0, z0, n0, hn0, r1, z1, n1, hn1], dim=-1))
        h0p.append(h0)
        h1p.append(h1)
        x1s.append(x1)
        h0, h1 = h0n, h1n
    return (*(_stored(torch.stack(s), res_dtype) for s in (packed, h0p, h1p, x1s)),
            torch.stack([h0, h1]))


def _gru_cell_bwd(dh: torch.Tensor, h_prev: torch.Tensor, r: torch.Tensor,
                  z: torch.Tensor, n: torch.Tensor, hn: torch.Tensor):
    """One GRU step backward -> ``(dih (B, 3H) = [dr_pre | dz_pre |
    dn_pre], dhn (B, H) = dn_pre * r, dh_prev's direct part dh * z)``.
    ``dhh = [dr_pre | dz_pre | dhn]`` shares its first 2H lanes with dih."""
    dn_pre = dh * (1.0 - z) * (1.0 - n * n)
    dr_pre = dn_pre * hn * r * (1.0 - r)
    dz_pre = dh * (h_prev - n) * z * (1.0 - z)
    return torch.cat([dr_pre, dz_pre, dn_pre], dim=-1), dn_pre * r, dh * z


def gru2_bwd_chain_reference(packed: torch.Tensor, h0p: torch.Tensor,
                             h1p: torch.Tensor, keep_tm: torch.Tensor,
                             dh_final: torch.Tensor, w_hh0: torch.Tensor,
                             w_hh1: torch.Tensor, w_ih1: torch.Tensor,
                             dys=None):
    """Plain version of the GRU reverse chain: ``(dih0, dhn0, dih1, dhn1)``,
    (T, B, 3H) and (T, B, H) per layer, in the residuals' dtype (bf16
    residuals read into float32, the chain float32, its outputs rounded to
    bf16 once).

    Per reverse step t: layer 1's cell backward, ``dh1 <- dh1 z1 + [dih1[:,
    :2H] | dhn1] w_hh1^T``, the hop ``dx1 = dih1 w_ih1^T`` times ``keep[t]``
    into layer 0, layer 0's cell backward, ``dh0 <- dh0 z0 + [dih0[:, :2H] |
    dhn0] w_hh0^T``.  Only the final hidden state of layer 1 has a
    cotangent (``dh_final``).
    """
    _refuse_dys(dys, "GRU", 6)
    h_dim = w_hh0.shape[0]

    def step(t):
        r0, z0, n0, hn0, r1, z1, n1, hn1 = _read(packed[t]).split(h_dim, dim=-1)
        return (_read(h0p[t]), r0, z0, n0, hn0), (_read(h1p[t]), r1, z1, n1, hn1)

    return tuple(d.to(packed.dtype) for d in _gru2_chain(
        packed.shape[0], step, keep_tm, dh_final, w_hh0, w_hh1, w_ih1))


def _gru2_chain(t_len: int, step, keep_tm: torch.Tensor, dh_final: torch.Tensor,
                w_hh0: torch.Tensor, w_hh1: torch.Tensor, w_ih1: torch.Tensor,
                dys=None):
    """The reverse walk both GRU chains share: ``(dih0, dhn0, dih1,
    dhn1)``; ``step(t)`` gives step t's ``(h_prev, r, z, n, hn)`` of each
    layer; ``dys`` (T, B, H), where given, adds to layer 1's dh before its
    cell backward."""
    h_dim = w_hh0.shape[0]
    keep = keep_tm.to(torch.float32)
    dh1 = dh_final.to(torch.float32)
    dh0 = torch.zeros_like(dh1)
    outs = ([], [], [], [])
    for t in reversed(range(t_len)):
        res0, res1 = step(t)
        dh1_t = dh1 if dys is None else dh1 + dys[t].to(torch.float32)
        dih1, dhn1, dd1 = _gru_cell_bwd(dh1_t, *res1)
        dh1 = dd1 + torch.cat([dih1[:, :2 * h_dim], dhn1], dim=-1) @ w_hh1.T
        dx1 = dih1 @ w_ih1.T
        dih0, dhn0, dd0 = _gru_cell_bwd(dh0 + dx1 * keep[t], *res0)
        dh0 = dd0 + torch.cat([dih0[:, :2 * h_dim], dhn0], dim=-1) @ w_hh0.T
        for out, val in zip(outs, (dih0, dhn0, dih1, dhn1)):
            out.append(val)
    return tuple(torch.stack(o[::-1]) for o in outs)


GRU2_INFER = CudaKernel(
    "gru2_infer", "gru2_infer_launch",
    [_P] * 11 + [_I] * 7 + [_P],
)
GRU2_TRAIN_FWD = CudaKernel(
    "gru2_train_fwd", "gru2_train_fwd_launch",
    [_P] * 15 + [_I] * 7 + [_P],
)
GRU2_BWD_CHAIN = CudaKernel(
    "gru2_bwd_chain", "gru2_bwd_chain_launch",
    [_P] * 13 + [_I] * 7 + [_P],
)
# the bf16 forms of the same sources, counted apart
GRU2_TRAIN_FWD_BF16 = CudaKernel(
    "gru2_train_fwd", "gru2_train_fwd_bf16_launch",
    [_P] * 18 + [_I] * 7 + [_P],
)
GRU2_BWD_CHAIN_BF16 = CudaKernel(
    "gru2_bwd_chain", "gru2_bwd_chain_bf16_launch",
    [_P] * 17 + [_I] * 7 + [_P],
)


def _gru_weights(name: str, h_dim: int, layer0: Params, layer1: Params):
    """The recurrent weights and biases both GRU kernels take, contiguous
    and shape-checked: w_hh0, b_hh0, w_ih1, b_ih1, w_hh1, b_hh1."""
    w = (layer0["w_hh"], layer0["b_hh"], layer1["w_ih"], layer1["b_ih"],
         layer1["w_hh"], layer1["b_hh"])
    w = tuple(t.contiguous() for t in w)
    square, bias = (h_dim, 3 * h_dim), (3 * h_dim,)
    _check_shapes(name, w_hh0=(w[0], square), b_hh0=(w[1], bias),
                  w_ih1=(w[2], square), b_ih1=(w[3], bias),
                  w_hh1=(w[4], square), b_hh1=(w[5], bias))
    return w


def _pair_launch(source: str, width: int, batch: int, h_dim: int,
                 device: torch.device, forward: bool, remat_d: int = 0):
    """A 2-layer launch's plan and the two sets' barrier flags (zeros) ->
    ``(plan, flags)``."""
    plan = chain_plan_on(source, width, h_dim, batch, device, forward, layers=2,
                         remat_d=remat_d)
    return plan, torch.zeros(2 * CHAIN_FLAGS, dtype=torch.int32, device=device)


def _gru2_infer_launch(x: torch.Tensor, layer0: Params, layer1: Params) -> torch.Tensor:
    """The CUDA kernel of ``med_torch::gru2_infer``."""
    batch, t_len, _ = x.shape
    h_dim = layer0["w_hh"].shape[0]
    if t_len < 1 or batch < 1:
        raise ValueError(f"gru2_infer: empty input of shape {tuple(x.shape)}")
    ih0 = _gru_input_projection(x, layer0).contiguous()
    w = _gru_weights("gru2_infer", h_dim, layer0, layer1)
    # the kernel's CTAs exchange h through these: layer 0's whole series
    # (layer 1 reads it a step behind), layer 1's two slots used in turn;
    # the carries (zeros)
    new = dict(dtype=torch.float32, device=x.device)
    h0 = torch.empty((t_len, batch, h_dim), **new)
    h1 = torch.empty((2, batch, h_dim), **new)
    carry = torch.zeros((2, batch, h_dim), **new)
    check_cuda_f32("gru2_infer", ih0=ih0, w_hh0=w[0], b_hh0=w[1], w_ih1=w[2],
                   b_ih1=w[3], w_hh1=w[4], b_hh1=w[5])
    plan, flags = _pair_launch("gru2_infer", 3, batch, h_dim, x.device, forward=True)
    GRU2_INFER(
        ih0.data_ptr(), *(t.data_ptr() for t in w), h0.data_ptr(), h1.data_ptr(),
        carry.data_ptr(), flags.data_ptr(), batch, t_len, h_dim, plan.upc, plan.ncl,
        plan.rgroups, plan.kc, stream_of(x),
    )
    return h1[(t_len - 1) % 2].clone()


def _gru_pair_op(fn):
    """``fn(x, layer0, layer1)`` as an op kernel over the eight GRU tensors."""
    def kernel(x, w_ih0, w_hh0, b_ih0, b_hh0, w_ih1, w_hh1, b_ih1, b_hh1):
        return fn(x, {"w_ih": w_ih0, "w_hh": w_hh0, "b_ih": b_ih0, "b_hh": b_hh0},
                  {"w_ih": w_ih1, "w_hh": w_hh1, "b_ih": b_ih1, "b_hh": b_hh1})
    return kernel


GRU2_INFER_OP = kernel_op(
    "gru2_infer",
    "(Tensor x, Tensor w_ih0, Tensor w_hh0, Tensor b_ih0, Tensor b_hh0, Tensor w_ih1, "
    "Tensor w_hh1, Tensor b_ih1, Tensor b_hh1) -> Tensor",
    cpu=_gru_pair_op(gru2_infer_reference), cuda=_gru_pair_op(_gru2_infer_launch),
    fake=_gru_pair_op(_pair_infer_fake))


def gru2_infer(x: torch.Tensor, layer0: Params, layer1: Params) -> torch.Tensor:
    """x (B, T, D) -> final h of the 2-layer GRU's layer 1 (B, H), float32.

    Calls ``med_torch::gru2_infer``: on a CUDA tensor it launches
    ``csrc/gru2_infer.cu`` (one cooperative cluster launch for the whole
    sequence on ``chain_plan_on``'s 2-layer forward plan) and counts it in
    ``GRU2_INFER.launches``; on a CPU tensor it runs
    ``gru2_infer_reference``.
    """
    return GRU2_INFER_OP(x, *(layer[k] for layer in (layer0, layer1)
                              for k in ("w_ih", "w_hh", "b_ih", "b_hh")))


def gru2_train_fwd_residuals(x_tm: torch.Tensor, keep_tm: torch.Tensor,
                             layer0: Params, layer1: Params,
                             res_dtype: torch.dtype = torch.float32):
    """GRU training forward: x_tm (T, B, D), keep_tm (T, B, H) ->
    ``(packed, h0_prev, h1_prev, x1, finals)``, the series in ``res_dtype``
    (float32 or bf16), the finals float32.

    On a CUDA tensor this launches ``csrc/gru2_train_fwd.cu`` (one
    cooperative cluster launch for the whole sequence on ``chain_plan_on``'s
    2-layer forward plan: layer 0 on one CTA set, layer 1 on another) and
    counts it in ``GRU2_TRAIN_FWD.launches``, its bf16 form in
    ``GRU2_TRAIN_FWD_BF16.launches``; on a CPU tensor it runs
    ``gru2_train_fwd_reference``.
    """
    half = residual_dtype(res_dtype) == torch.bfloat16
    if x_tm.device.type == "cpu":
        return gru2_train_fwd_reference(x_tm, keep_tm, layer0, layer1, res_dtype)
    t_len, batch, _ = x_tm.shape
    h_dim = layer0["w_hh"].shape[0]
    if t_len < 1 or batch < 1:
        raise ValueError(f"gru2_train_fwd: empty input of shape {tuple(x_tm.shape)}")
    ih0 = _gru_input_projection(x_tm, layer0).contiguous()
    keep = keep_tm.to(torch.float32).contiguous()
    w = _gru_weights("gru2_train_fwd", h_dim, layer0, layer1)
    _check_shapes("gru2_train_fwd", keep=(keep, (t_len, batch, h_dim)))
    new = dict(dtype=torch.float32, device=x_tm.device)
    series = (t_len, batch, h_dim)
    finals = torch.empty((2, batch, h_dim), **new)
    carry = torch.zeros((2, batch, h_dim), **new)
    check_cuda_f32("gru2_train_fwd", ih0=ih0, keep=keep, w_hh0=w[0], b_hh0=w[1],
                   w_ih1=w[2], b_ih1=w[3], w_hh1=w[4], b_hh1=w[5])
    plan, flags = _pair_launch("gru2_train_fwd", 3, batch, h_dim, x_tm.device,
                               forward=True)
    if half:
        res = dict(dtype=torch.bfloat16, device=x_tm.device)
        packed = torch.empty((t_len, batch, GRU_RES2_W * h_dim), **res)
        stored = [torch.empty(series, **res) for _ in range(3)]
        GRU2_TRAIN_FWD_BF16(
            *(t.data_ptr() for t in (ih0, keep, *w, packed, *stored,
                                     *_fwd_exchange(series, x_tm.device), finals, carry,
                                     flags)),
            batch, t_len, h_dim, plan.upc, plan.ncl, plan.rgroups, plan.kc,
            stream_of(x_tm),
        )
        return (packed, *stored, finals)
    packed = torch.empty((t_len, batch, GRU_RES2_W * h_dim), **new)
    # the kernel's CTAs exchange h through the h0p, h1p and x1 series
    h0p, h1p, x1 = (torch.empty(series, **new) for _ in range(3))
    GRU2_TRAIN_FWD(
        ih0.data_ptr(), keep.data_ptr(), *(t.data_ptr() for t in w),
        packed.data_ptr(), h0p.data_ptr(), h1p.data_ptr(), x1.data_ptr(),
        finals.data_ptr(), carry.data_ptr(), flags.data_ptr(), batch, t_len, h_dim,
        plan.upc, plan.ncl, plan.rgroups, plan.kc, stream_of(x_tm),
    )
    return packed, h0p, h1p, x1, finals


def gru2_bwd_chain(packed: torch.Tensor, h0p: torch.Tensor, h1p: torch.Tensor,
                   keep_tm: torch.Tensor, dh_final: torch.Tensor,
                   w_hh0: torch.Tensor, w_hh1: torch.Tensor, w_ih1: torch.Tensor,
                   dys=None):
    """GRU reverse chain: ``(dih0, dhn0, dih1, dhn1)``, (T, B, 3H) and
    (T, B, H) per layer, in the residuals' dtype: float32, or bf16 over
    bf16 ``packed``, ``h0p`` and ``h1p`` (the bf16 form).

    On a CUDA tensor this launches ``csrc/gru2_bwd_chain.cu`` (one
    cooperative cluster launch on ``chain_plan_on``'s 2-layer plan) and
    counts it in ``GRU2_BWD_CHAIN.launches``, its bf16 form in
    ``GRU2_BWD_CHAIN_BF16.launches``; on a CPU tensor it runs
    ``gru2_bwd_chain_reference``.  ``dys`` (a sequence-output cotangent) is
    not taken: it raises.
    """
    _refuse_dys(dys, "GRU", 6)
    if packed.device.type == "cpu":
        return gru2_bwd_chain_reference(packed, h0p, h1p, keep_tm, dh_final,
                                        w_hh0, w_hh1, w_ih1)
    half = _half("gru2_bwd_chain", packed, h0p, h1p)
    t_len, batch, _ = packed.shape
    h_dim = w_hh0.shape[0]
    keep = keep_tm.to(torch.float32).contiguous()
    dh = dh_final.to(torch.float32).contiguous()
    packed, h0p, h1p = packed.contiguous(), h0p.contiguous(), h1p.contiguous()
    w_hh0, w_hh1, w_ih1 = (w.contiguous() for w in (w_hh0, w_hh1, w_ih1))
    series, square = (t_len, batch, h_dim), (h_dim, 3 * h_dim)
    _check_shapes("gru2_bwd_chain",
                  packed=(packed, (t_len, batch, GRU_RES2_W * h_dim)),
                  h0p=(h0p, series), h1p=(h1p, series), keep=(keep, series),
                  dh_final=(dh, (batch, h_dim)), w_hh0=(w_hh0, square),
                  w_hh1=(w_hh1, square), w_ih1=(w_ih1, square))
    if t_len < 1 or batch < 1:
        raise ValueError(f"gru2_bwd_chain: empty residuals {tuple(packed.shape)}")
    new = dict(dtype=torch.float32, device=packed.device)
    # the kernel's CTAs exchange [dih[:, :2H] | dhn] and dih through these:
    # the outputs, or in the bf16 form float32 scratch beside them, layer
    # 0's own rows in two slots (layer 1's dih is the hop into layer 0,
    # which runs behind)
    rows0 = 2 if half else t_len
    dih0 = torch.empty((rows0, batch, 3 * h_dim), **new)
    dhn0 = torch.empty((rows0, batch, h_dim), **new)
    dih1 = torch.empty((t_len, batch, 3 * h_dim), **new)
    dhn1 = torch.empty(series, **new)
    check_cuda_f32("gru2_bwd_chain", keep=keep, dh_final=dh, w_hh0=w_hh0, w_hh1=w_hh1,
                   w_ih1=w_ih1)
    check_cuda("gru2_bwd_chain", packed.dtype, dict(packed=packed, h0p=h0p, h1p=h1p))
    plan, flags = _pair_launch("gru2_bwd_chain", 3, batch, h_dim, packed.device,
                               forward=False)
    # the direct parts' carries: layer 0's starts at zero, layer 1's as
    # dh_final
    carry = torch.cat([torch.zeros_like(dh), dh]).contiguous()
    if half:
        out = [torch.empty_like(d, dtype=torch.bfloat16) for d in (dih1, dhn1) * 2]
        GRU2_BWD_CHAIN_BF16(
            *(t.data_ptr() for t in (packed, h0p, h1p, keep, w_hh0, w_hh1, w_ih1, *out,
                                     dih0, dhn0, dih1, dhn1, carry, flags)),
            batch, t_len, h_dim, plan.upc, plan.ncl, plan.rgroups, plan.kc,
            stream_of(packed),
        )
        return tuple(out)
    GRU2_BWD_CHAIN(
        packed.data_ptr(), h0p.data_ptr(), h1p.data_ptr(), keep.data_ptr(),
        w_hh0.data_ptr(), w_hh1.data_ptr(), w_ih1.data_ptr(),
        dih0.data_ptr(), dhn0.data_ptr(), dih1.data_ptr(), dhn1.data_ptr(),
        carry.data_ptr(), flags.data_ptr(), batch, t_len, h_dim, plan.upc,
        plan.ncl, plan.rgroups, plan.kc, stream_of(packed),
    )
    return dih0, dhn0, dih1, dhn1


# ---------------------------------------------------------------------------
# The 2-layer GRU pair in the legacy layout (``set_res2_mode("off")``)
# ---------------------------------------------------------------------------


def gru2_train_fwd_legacy_reference(x_tm: torch.Tensor, keep_tm: torch.Tensor,
                                    layer0: Params, layer1: Params):
    """Plain version of the legacy-layout GRU training forward.

    x_tm (T, B, D), keep_tm (T, B, H) -> ``(ys, h_final, ((r0, z0, n0, hn0,
    h0_new), (r1, z1, n1, hn1, h1_new)))``, the JAX kernel's structure: each
    (T, B, H), the gate activations, ``hn = h_prev w_hn + b_hn`` and the
    state AFTER each step; ``ys`` is ``h1_new``, ``h_final`` (B, H) its
    last.  Differentiable, so autograd through it is a plain reference for
    the legacy route's gradients.
    """
    ih0 = _gru_input_projection(x_tm, layer0)
    keep = keep_tm.to(torch.float32)
    batch, h_dim = x_tm.shape[1], layer0["w_hh"].shape[0]
    h0 = h1 = ih0.new_zeros((batch, h_dim))
    series = tuple([] for _ in range(10))
    for t in range(x_tm.shape[0]):
        h0, r0, z0, n0, hn0 = _gru_step(h0, ih0[t], layer0["w_hh"], layer0["b_hh"])
        ih1 = (h0 * keep[t]) @ layer1["w_ih"] + layer1["b_ih"]
        h1, r1, z1, n1, hn1 = _gru_step(h1, ih1, layer1["w_hh"], layer1["b_hh"])
        for out, val in zip(series, (r0, z0, n0, hn0, h0, r1, z1, n1, hn1, h1)):
            out.append(val)
    stacked = [torch.stack(s) for s in series]
    return stacked[9], h1, (tuple(stacked[:5]), tuple(stacked[5:]))


def gru2_bwd_chain_legacy_reference(res0, res1, dys, keep_tm: torch.Tensor,
                                    dh_final: torch.Tensor, w_hh0: torch.Tensor,
                                    w_hh1: torch.Tensor, w_ih1: torch.Tensor):
    """Plain version of the legacy GRU reverse chain: ``((dih0, dhh0),
    (dih1, dhh1))``, each (T, B, 3H), over ``res0``, ``res1`` the layers'
    ``(h_prev, r, z, n, hn)`` series (T, B, H); the walk of
    ``gru2_bwd_chain_reference`` with ``dys`` (T, B, H, or ``None``: zeros)
    added to layer 1's dh, and the full ``dhh = [dih[:, :2H] | dhn]``."""
    h_dim = w_hh0.shape[0]
    dih0, dhn0, dih1, dhn1 = _gru2_chain(
        res0[0].shape[0], lambda t: ([a[t] for a in res0], [a[t] for a in res1]),
        keep_tm, dh_final, w_hh0, w_hh1, w_ih1, dys)
    return ((dih0, torch.cat([dih0[..., :2 * h_dim], dhn0], dim=-1)),
            (dih1, torch.cat([dih1[..., :2 * h_dim], dhn1], dim=-1)))


GRU2_TRAIN_FWD_LEGACY = CudaKernel(
    "gru2_train_fwd_legacy", "gru2_train_fwd_legacy_launch",
    [_P] * 15 + [_I] * 7 + [_P],
)
GRU2_BWD_CHAIN_LEGACY = CudaKernel(
    "gru2_bwd_chain_legacy", "gru2_bwd_chain_legacy_launch",
    [_P] * 11 + [_I] * 7 + [_P],
)


def gru2_train_fwd_legacy_views(res: torch.Tensor, h_final: torch.Tensor):
    """The legacy GRU forward's result from its one (T, B, 10H) ``res`` and
    ``h_final`` (B, H): ``(ys, h_final, ((r0, z0, n0, hn0, h0_new), (r1, z1,
    n1, hn1, h1_new)))``, the lanes as views of ``res``."""
    lanes = res.split(res.shape[-1] // 10, dim=-1)
    return lanes[9], h_final, (lanes[:5], lanes[5:])


def gru2_train_fwd_legacy(x_tm: torch.Tensor, keep_tm: torch.Tensor,
                          layer0: Params, layer1: Params):
    """Legacy-layout GRU training forward: x_tm (T, B, D), keep_tm (T, B,
    H) -> ``(ys, h_final, ((r0, z0, n0, hn0, h0_new), (r1, z1, n1, hn1,
    h1_new)))``, float32; on the card the series are views of the kernel's
    one ``res`` (T, B, 10H) (``gru2_train_fwd_legacy_views``).

    On a CUDA tensor this launches ``csrc/gru2_train_fwd_legacy.cu`` (one
    cooperative cluster launch for the whole sequence on ``chain_plan_on``'s
    2-layer forward plan: layer 0 on one CTA set, layer 1 on another) and
    counts it in ``GRU2_TRAIN_FWD_LEGACY.launches``; on a CPU tensor it
    runs ``gru2_train_fwd_legacy_reference``.
    """
    if x_tm.device.type == "cpu":
        return gru2_train_fwd_legacy_reference(x_tm, keep_tm, layer0, layer1)
    t_len, batch, _ = x_tm.shape
    h_dim = layer0["w_hh"].shape[0]
    if t_len < 1 or batch < 1:
        raise ValueError(f"gru2_train_fwd_legacy: empty input of shape {tuple(x_tm.shape)}")
    ih0 = _gru_input_projection(x_tm, layer0).contiguous()
    keep = keep_tm.to(torch.float32).contiguous()
    w = _gru_weights("gru2_train_fwd_legacy", h_dim, layer0, layer1)
    _check_shapes("gru2_train_fwd_legacy", keep=(keep, (t_len, batch, h_dim)))
    new = dict(dtype=torch.float32, device=x_tm.device)
    res = torch.empty((t_len, batch, 10 * h_dim), **new)
    h_final = torch.empty((batch, h_dim), **new)
    # the layout holds no state before a step and no x1: the kernel's CTAs
    # exchange h through these scratch series
    h0p, h1p, x1 = (torch.empty((t_len, batch, h_dim), **new) for _ in range(3))
    carry = torch.zeros((2, batch, h_dim), **new)
    check_cuda_f32("gru2_train_fwd_legacy", ih0=ih0, keep=keep, w_hh0=w[0],
                   b_hh0=w[1], w_ih1=w[2], b_ih1=w[3], w_hh1=w[4], b_hh1=w[5])
    plan, flags = _pair_launch("gru2_train_fwd_legacy", 3, batch, h_dim, x_tm.device,
                               forward=True)
    GRU2_TRAIN_FWD_LEGACY(
        ih0.data_ptr(), keep.data_ptr(), *(t.data_ptr() for t in w),
        res.data_ptr(), h_final.data_ptr(), h0p.data_ptr(), h1p.data_ptr(),
        x1.data_ptr(), carry.data_ptr(), flags.data_ptr(), batch, t_len, h_dim,
        plan.upc, plan.ncl, plan.rgroups, plan.kc, stream_of(x_tm),
    )
    return gru2_train_fwd_legacy_views(res, h_final)


def gru2_bwd_chain_legacy(res0, res1, dys, keep_tm: torch.Tensor,
                          dh_final: torch.Tensor, w_hh0: torch.Tensor,
                          w_hh1: torch.Tensor, w_ih1: torch.Tensor):
    """Legacy GRU reverse chain: ``((dih0, dhh0), (dih1, dhh1))``, each
    (T, B, 3H) float32; on the card views of the kernel's one output (T, B,
    12H).  ``res0`` / ``res1`` are the layers' ``(h_prev, r, z, n, hn)``
    series (T, B, H); on the card both layers' r, z, n, hn are packed into
    one (T, B, 8H) as ``gru2_bwd_chain`` reads them; ``dys`` (T, B, H) is
    the sequence output's cotangent, or ``None``, and then the kernel reads
    no stream.

    On a CUDA tensor this launches ``csrc/gru2_bwd_chain_legacy.cu`` (one
    cooperative cluster launch on ``chain_plan_on``'s 2-layer plan) and
    counts it in ``GRU2_BWD_CHAIN_LEGACY.launches``; on a CPU tensor it
    runs ``gru2_bwd_chain_legacy_reference``.
    """
    if res0[0].device.type == "cpu":
        return gru2_bwd_chain_legacy_reference(res0, res1, dys, keep_tm, dh_final,
                                               w_hh0, w_hh1, w_ih1)
    if len(res0) != 5 or len(res1) != 5 or res0[0].dim() != 3:
        raise ValueError("gru2_bwd_chain_legacy: res0 and res1 are 5-tuples of "
                         "(T, B, H) series")
    t_len, batch, h_dim = res0[0].shape
    series, square = (t_len, batch, h_dim), (h_dim, 3 * h_dim)
    tensors = dict(
        h0p=res0[0].to(torch.float32).contiguous(),
        h1p=res1[0].to(torch.float32).contiguous(),
        keep=keep_tm.to(torch.float32).contiguous(),
        dh_final=dh_final.to(torch.float32).contiguous(), w_hh0=w_hh0.contiguous(),
        w_hh1=w_hh1.contiguous(), w_ih1=w_ih1.contiguous())
    shapes = dict(h0p=series, h1p=series, keep=series, dh_final=(batch, h_dim),
                  w_hh0=square, w_hh1=square, w_ih1=square)
    if dys is not None:
        tensors["dys"] = dys.to(torch.float32).contiguous()
        shapes["dys"] = series
    _check_shapes("gru2_bwd_chain_legacy",
                  **{k: (tensors[k], shapes[k]) for k in tensors},
                  **{f"res{i}[{j}]": (res[j], series) for i, res in enumerate((res0, res1))
                     for j in range(1, 5)})
    if t_len < 1 or batch < 1:
        raise ValueError(f"gru2_bwd_chain_legacy: empty residuals {series}")
    tensors["res"] = torch.cat([a.to(torch.float32) for a in (*res0[1:], *res1[1:])],
                               dim=-1)
    device = res0[0].device
    out = torch.empty((t_len, batch, 12 * h_dim), dtype=torch.float32, device=device)
    check_cuda_f32("gru2_bwd_chain_legacy", **tensors)
    ptr = {k: t.data_ptr() for k, t in tensors.items()}
    plan, flags = _pair_launch("gru2_bwd_chain_legacy", 3, batch, h_dim, device,
                               forward=False)
    # the direct parts' carries: layer 0's starts at zero, layer 1's as
    # dh_final
    dh = tensors["dh_final"]
    carry = torch.cat([torch.zeros_like(dh), dh]).contiguous()
    GRU2_BWD_CHAIN_LEGACY(
        ptr["h0p"], ptr["h1p"], ptr["res"], ptr.get("dys"), ptr["keep"], ptr["w_hh0"],
        ptr["w_hh1"], ptr["w_ih1"], out.data_ptr(), carry.data_ptr(), flags.data_ptr(),
        batch, t_len, h_dim, plan.upc, plan.ncl, plan.rgroups, plan.kc, stream_of(out),
    )
    d = out.split(3 * h_dim, dim=-1)
    return (d[0], d[1]), (d[2], d[3])


# ---------------------------------------------------------------------------
# GRU, one layer per launch: training forward, its eval form, reverse chain
# ---------------------------------------------------------------------------


def gru1_train_fwd_reference(ih: torch.Tensor, w_hh: torch.Tensor,
                             b_hh: torch.Tensor):
    """Plain version of one GRU layer's training forward.

    ih (T, B, 3H) the hoisted input projection ``x @ w_ih + b_ih`` ->
    ``(gates (T, B, 4H) = [r | z | n | hn], h_prev (T, B, H), h (B, H))``:
    the gate activations and ``hn = h_prev w_hn + b_hn`` of each step, the
    state before each step, from zero state, and the final h.
    Differentiable, so autograd through it is a plain reference for the
    layered gradient.
    """
    batch, h_dim = ih.shape[1], w_hh.shape[0]
    h = ih.new_zeros((batch, h_dim))
    gates, hps = [], []
    for t in range(ih.shape[0]):
        hps.append(h)
        h, r, z, n, hn = _gru_step(h, ih[t], w_hh, b_hh)
        gates.append(torch.cat([r, z, n, hn], dim=-1))
    return torch.stack(gates), torch.stack(hps), h


def gru1_infer_reference(ih: torch.Tensor, w_hh: torch.Tensor,
                         b_hh: torch.Tensor, want_series: bool) -> torch.Tensor:
    """Plain version of the eval form: the h series (T, B, H) after each
    step, or only the final h (B, H)."""
    _, h_prev, h = gru1_train_fwd_reference(ih, w_hh, b_hh)
    return h_series(h_prev, h) if want_series else h


def gru_bwd_chain_reference(gates: torch.Tensor, h_prev: torch.Tensor,
                            dh_series, dh_final: torch.Tensor,
                            w_hh: torch.Tensor):
    """Plain version of one GRU layer's reverse chain: ``(dih (T, B, 3H),
    dhn (T, B, H))``.

    Walks t = T-1 .. 0 with the carry dh (``dh_final`` at the start):
    ``dh_t = dh + dh_series[t]``, the cell backward, ``dh = dh_t z +
    [dih[:, :2H] | dhn] w_hh^T``.  ``dhh = [dih[:, :2H] | dhn]`` shares its
    first 2H lanes with ``dih``, so only its n lane is returned.
    ``dh_series=None`` means zeros (the top layer of a final-hidden-only
    stack).
    """
    h_dim = w_hh.shape[0]
    dh = dh_final.to(torch.float32)
    dihs, dhns = [], []
    for t in reversed(range(gates.shape[0])):
        dh_t = dh if dh_series is None else dh + dh_series[t]
        dih, dhn, direct = _gru_cell_bwd(dh_t, h_prev[t], *gates[t].split(h_dim, dim=-1))
        dh = direct + torch.cat([dih[:, :2 * h_dim], dhn], dim=-1) @ w_hh.T
        dihs.append(dih)
        dhns.append(dhn)
    return torch.stack(dihs[::-1]), torch.stack(dhns[::-1])


GRU1_TRAIN_FWD = CudaKernel(
    "gru1_fwd", "gru1_fwd_train_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)
GRU1_INFER = CudaKernel(
    "gru1_fwd", "gru1_fwd_infer_launch",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
)
GRU_BWD_CHAIN = CudaKernel(
    "gru_bwd_chain", "gru_bwd_chain_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)


def _gru_layer(name: str, ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor):
    """Shape-checked, contiguous (ih, w_hh, b_hh) and (T, B, H)."""
    t_len, batch, h_dim = _layer_shapes(name, ih, w_hh, gates=3)
    _check_shapes(name, b_hh=(b_hh, (3 * h_dim,)))
    return (ih.contiguous(), w_hh.contiguous(), b_hh.contiguous()), (t_len, batch, h_dim)


def gru1_train_fwd(ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor):
    """One GRU layer's training forward: ih (T, B, 3H), w_hh (H, 3H), b_hh
    (3H,) -> ``(gates, h_prev, h)``, all float32.

    On a CUDA tensor this launches ``csrc/gru1_fwd.cu`` (one cooperative
    cluster launch for the whole sequence on ``chain_plan_on``'s forward
    plan) and counts it in ``GRU1_TRAIN_FWD.launches``; on a CPU tensor it
    runs ``gru1_train_fwd_reference``.
    """
    if ih.device.type == "cpu":
        return gru1_train_fwd_reference(ih, w_hh, b_hh)
    (ih, w_hh, b_hh), (t_len, batch, h_dim) = _gru_layer("gru1_train_fwd", ih, w_hh, b_hh)
    new = dict(dtype=torch.float32, device=ih.device)
    gates = torch.empty((t_len, batch, 4 * h_dim), **new)
    h_prev = torch.empty((t_len, batch, h_dim), **new)
    h = torch.empty((batch, h_dim), **new)
    check_cuda_f32("gru1_train_fwd", ih=ih, w_hh=w_hh, b_hh=b_hh)
    plan, carry, flags = _fwd_launch("gru1_fwd", 3, batch, h_dim, ih.device)
    GRU1_TRAIN_FWD(
        ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), gates.data_ptr(),
        h_prev.data_ptr(), h.data_ptr(), carry.data_ptr(), flags.data_ptr(), batch,
        t_len, h_dim, plan.upc, plan.ncl, plan.rgroups, plan.kc, stream_of(ih),
    )
    return gates, h_prev, h


def _gru1_infer_launch(ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                       want_series: bool) -> torch.Tensor:
    """The CUDA kernel of ``med_torch::gru1_infer``."""
    (ih, w_hh, b_hh), (t_len, batch, h_dim) = _gru_layer("gru1_infer", ih, w_hh, b_hh)
    # the kernel's blocks exchange h through ``out``: the series itself,
    # or two slots used in turn when only the final h is wanted
    slots = t_len if want_series else 2
    out = torch.empty((slots, batch, h_dim), dtype=torch.float32, device=ih.device)
    check_cuda_f32("gru1_infer", ih=ih, w_hh=w_hh, b_hh=b_hh)
    plan, carry, flags = _fwd_launch("gru1_fwd", 3, batch, h_dim, ih.device)
    GRU1_INFER(ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
               carry.data_ptr(), flags.data_ptr(), batch, t_len, h_dim,
               int(want_series), plan.upc, plan.ncl, plan.rgroups, plan.kc,
               stream_of(ih))
    return out if want_series else out[(t_len - 1) % 2].clone()


GRU1_INFER_OP = kernel_op(
    "gru1_infer", "(Tensor ih, Tensor w_hh, Tensor b_hh, bool want_series) -> Tensor",
    cpu=gru1_infer_reference, cuda=_gru1_infer_launch, fake=_layer_infer_fake)


def gru1_infer(ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
               want_series: bool) -> torch.Tensor:
    """Eval form of ``gru1_train_fwd``: ih (T, B, 3H) -> the h series
    (T, B, H) (the next layer's input) or, with ``want_series`` false, the
    final h (B, H).  It stores no gates.

    Calls ``med_torch::gru1_infer``: on a CUDA tensor it launches
    ``csrc/gru1_fwd.cu``'s eval entry (on the training form's plan) and
    counts it in ``GRU1_INFER.launches``; on a CPU tensor it runs
    ``gru1_infer_reference``.
    """
    return GRU1_INFER_OP(ih, w_hh, b_hh, bool(want_series))


def gru_bwd_chain(gates: torch.Tensor, h_prev: torch.Tensor, dh_series,
                  dh_final: torch.Tensor, w_hh: torch.Tensor):
    """One GRU layer's reverse chain: ``(dih (T, B, 3H), dhn (T, B, H))``
    float32.

    ``gates`` (T, B, 4H) and ``h_prev`` (T, B, H) are ``gru1_train_fwd``'s
    residuals, ``dh_series`` (T, B, H) the per-step cotangent from the layer
    above (``None``: zeros, and the kernel reads nothing), ``dh_final``
    (B, H) the final hidden state's.  On a CUDA tensor this launches
    ``csrc/gru_bwd_chain.cu`` (one cooperative cluster launch on
    ``chain_plan_on``'s plan) and counts it in ``GRU_BWD_CHAIN.launches``;
    on a CPU tensor it runs ``gru_bwd_chain_reference``.
    """
    if gates.device.type == "cpu":
        return gru_bwd_chain_reference(gates, h_prev, dh_series, dh_final, w_hh)
    if gates.dim() != 3:
        raise ValueError(
            f"gru_bwd_chain: gates has shape {tuple(gates.shape)}, expected (T, B, 4H)")
    t_len, batch, _ = gates.shape
    h_dim = w_hh.shape[0]
    series = (t_len, batch, h_dim)
    dh = dh_final.to(torch.float32).contiguous()
    gates, h_prev, w_hh = gates.contiguous(), h_prev.contiguous(), w_hh.contiguous()
    shaped = dict(gates=(gates, (t_len, batch, 4 * h_dim)), h_prev=(h_prev, series),
                  dh_final=(dh, (batch, h_dim)), w_hh=(w_hh, (h_dim, 3 * h_dim)))
    tensors = dict(gates=gates, h_prev=h_prev, dh_final=dh, w_hh=w_hh)
    if dh_series is not None:
        dh_series = dh_series.to(torch.float32).contiguous()
        shaped["dh_series"] = (dh_series, series)
        tensors["dh_series"] = dh_series
    _check_shapes("gru_bwd_chain", **shaped)
    if t_len < 1 or batch < 1:
        raise ValueError(f"gru_bwd_chain: empty residuals {tuple(gates.shape)}")
    new = dict(dtype=torch.float32, device=gates.device)
    dih = torch.empty((t_len, batch, 3 * h_dim), **new)
    dhn = torch.empty(series, **new)
    check_cuda_f32("gru_bwd_chain", **tensors)
    plan = chain_plan_on("gru_bwd_chain", 3, h_dim, batch, gates.device)
    # the direct part's carry starts as dh_final; the barrier flags
    carry = dh.clone()
    flags = torch.zeros(CHAIN_FLAGS, dtype=torch.int32, device=gates.device)
    GRU_BWD_CHAIN(
        gates.data_ptr(), h_prev.data_ptr(),
        dh_series.data_ptr() if dh_series is not None else None,
        dh.data_ptr(), w_hh.data_ptr(), dih.data_ptr(), dhn.data_ptr(),
        carry.data_ptr(), flags.data_ptr(), batch, t_len, h_dim,
        plan.upc, plan.ncl, plan.rgroups, plan.kc, stream_of(gates),
    )
    return dih, dhn
