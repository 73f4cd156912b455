"""Gradient of a stacked LSTM's or GRU's final hidden state, with hoisted
weight gradients.

Two routes compute the same function, the counterparts of the JAX
package's ``fused_lstm_final`` routes; ``lstm_route`` picks one from the
depth, the width and the card's SM count, and ``fused_lstm_final`` takes
it:

* ``FusedLSTMFinal`` (2 layers, H up to twice the SM count), the
  residual-native route: the forward is ``lstm2_train_fwd_residuals``
  (saving the residuals), the backward the serial reverse chain
  ``lstm2_bwd_chain``, which emits every step's dgates of both layers.
  With ``remat_gates`` (``runtime.lstm_remat_gates``) the forward stores no
  gates and the backward is ``lstm2_bwd_chain_remat``, which recomputes
  them from the saved input and state series (in either residual dtype);
* ``LayeredLSTMFinal`` (any depth and the wider layers), the layered
  route: per layer, the input projection ``x_l @ w_ih_l + b_l`` as one
  ``torch.matmul``, then ``lstm1_train_fwd``; backward top-down, per layer
  ``lstm_bwd_chain``, then the hop ``(dg_l @ w_ih_l^T) * keep_{l-1}`` into
  the layer below as one ``torch.matmul``.

Both then form the weight gradients as single matrix products over the
flattened (T*B, .) series:

    dW_ih_l = x_l^T dg_l     dW_hh_l = h_prev_l^T dg_l     db_l = sum dg_l

The GRU twins, picked by ``gru_route`` (the same rule) in
``fused_gru_final``, are the counterparts of the JAX package's GRU routes:
``FusedGRUFinal`` (2 layers, H up to twice the SM count) runs
``gru2_train_fwd_residuals``, then one ``gru2_bwd_chain`` launch;
``LayeredGRUFinal`` (any depth and the wider layers, up to 8 units per SM)
runs per layer the input projection and ``gru1_train_fwd``, backward
top-down ``gru_bwd_chain`` and the hop ``(dih_l @ w_ih_l^T) *
keep_{l-1}``.  Their chains emit ``dih`` and only the ``dhn`` lane of
``dhh = [dih[:, :2H] | dhn]``, so

    dW_ih_l = x_l^T dih_l    dW_hh_l = h_prev_l^T [dih_l[:, :2H] | dhn_l]
    db_ih_l = sum dih_l      db_hh_l = [sum dih_l[:, :2H] | sum dhn_l]

``set_res2_mode("off")`` (the JAX package's switch of the same name, a
module global there as here) sends the pair route, and only it, through
the legacy-layout twins: ``LegacyLSTMFinal`` (``lstm2_train_fwd_legacy``,
then ``lstm2_bwd_chain_legacy`` over the shifted h / c series the JAX
package builds from it) and ``LegacyGRUFinal`` (``gru2_train_fwd_legacy``,
then ``gru2_bwd_chain_legacy`` where ``GRU_BWD2_ENABLED`` is set, else two
``gru_bwd_chain`` launches and the hop between them).  They compute the
same function as the residual-native pair; ``remat_gates`` is not read
there, as in the JAX package, whose remat route needs the residual-native
one.

``res_dtype`` (``runtime.lstm_residual_dtype``; the JAX package's
``set_res2_dtype``, here an argument) set to ``torch.bfloat16`` stores the
residual streams in bf16 on the residual-native pairs and the layered
LSTM, as the JAX package does: the pairs' ``packed``, h_prev and x1
series and their chains' outputs, the layered LSTM's g and c_prev (its
h_prev stays float32).  The forward's value stays the float32 one bit for
bit.  The weight gradients are then products of bf16 series read into
float32 (exact products, float32 sums: the JAX package's bf16 x bf16
contraction with float32 accumulation), x rounded to bf16 for dW_ih0 as
the JAX package rounds it.  The gate-rematerialising pair takes it too:
its forward stores the cell states and the h_prev and x1 series in bf16,
and its chain recomputes the gates from them and the bf16 x against the
float32 weights, writing bf16 dgates.  The legacy routes and the layered
GRU ignore it, as the JAX package does.

On the card the recurrences are hand-written kernels; on the CPU the same
Functions run their plain versions.  The keep masks are dropout draws and
get no gradient.

Every route runs the whole sequence at once, at any T: past ``LONG_T``
steps, where the JAX package's layerwise scan recomputes 512-step chunks
in its backward, the port keeps every step's residuals instead.  So past
``LONG_T`` a training forward on the card first checks that the card can
still give what the route holds at its peak (``stack_residual_bytes``,
``check_residual_budget``) and refuses, before it allocates anything, a
stack whose residuals do not fit (chunked recompute is ROADMAP.md Queue 1
item 17).
"""

from __future__ import annotations

from typing import Sequence

import torch

from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import (
    Params,
    gru1_train_fwd,
    gru2_bwd_chain,
    gru2_bwd_chain_legacy,
    gru2_train_fwd_legacy,
    gru2_train_fwd_residuals,
    gru_bwd_chain,
    h_series,
    lstm1_train_fwd,
    lstm2_bwd_chain,
    lstm2_bwd_chain_legacy,
    lstm2_bwd_chain_remat,
    lstm2_train_fwd_legacy,
    lstm2_train_fwd_residuals,
    lstm_bwd_chain,
    residual_dtype,
)

# the card the CPU mirrors when it picks a route: an H100's SM count
H100_SMS = 132

_RES2_MODE = "auto"  # "auto" | "off": set_res2_mode

# The JAX package's module flag, with its default: the legacy GRU backward
# runs the fused 2-layer chain (``gru2_bwd_chain_legacy``) only where it is
# set, else two layered chains (``gru_bwd_chain``) over the same residuals,
# which are faster on the H100 as on the TPU.  It exists to drive the fused
# chain on a training path; whoever sets it restores it.
GRU_BWD2_ENABLED = False


def set_res2_mode(mode: str) -> str:
    """Set the pair route's residual layout and return the previous mode:
    ``"auto"`` the residual-native pair, ``"off"`` the legacy-layout one.
    A module global, as in the JAX package, which has no config key for it:
    whoever sets it restores it."""
    global _RES2_MODE
    if mode not in ("auto", "off"):
        raise ValueError(f"set_res2_mode: {mode!r} is neither 'auto' nor 'off'")
    prev, _RES2_MODE = _RES2_MODE, mode
    return prev


# past this many steps the JAX package runs a stack as its layerwise scan in
# remat'd chunks; here the residual budget is checked first
LONG_T = 2048


def stack_residual_bytes(cell: str, layers: int, hidden: int, d_in: int,
                         batch: int, t_len: int, route: str,
                         remat_gates: bool = False, res_dtype="float32") -> int:
    """The most bytes one training forward + backward of a stack holds on
    the card at once: the residuals it saves, the keep mask, the forward's
    input projection while it runs and the backward's chain outputs, all
    float32 series of (T, B, .), counted from the shapes the Functions of
    this module allocate.  ``cell`` is ``"lstm"`` or ``"gru"``, ``route``
    ``"pair"`` (the residual-native pair, the LSTM's with ``remat_gates``),
    ``"legacy"`` (the pair under ``set_res2_mode("off")``) or ``"layered"``;
    the weights and the weight gradients, a few MB, are not counted.
    ``res_dtype`` "bfloat16" counts the bf16 streams (``_bf16_bytes``).

    In units of ``T B`` floats, with D the input width: the LSTM pair holds
    x D, keep H, packed 10H (2H without the gates), h0p / h1p / x1 3H, then
    dg0 / dg1 8H (the forward's ih0, 4H, is gone by then); the GRU pair x D,
    keep H, packed 8H, 3H, then dih / dhn of both layers 8H.  The legacy
    pairs hold the 12H (GRU 10H) rows, the shifted state series and x1, and
    their chains repack the rows before writing (LSTM 10H + 8H, GRU 8H +
    12H).  The layered route holds each layer's input (D, then H), its
    residuals (LSTM g, h_prev, c_prev 6H; GRU gates, h_prev 5H) and the
    L - 1 keep masks, and its backward two layers' chain outputs and the
    hop (9H) at once."""
    if cell not in ("lstm", "gru") or route not in ("pair", "legacy", "layered"):
        raise ValueError(f"stack_residual_bytes: no {route!r} route of a {cell!r} stack")
    if residual_dtype(res_dtype) == torch.bfloat16 and route != "legacy" and (
            route == "pair" or cell == "lstm"):
        return (_bf16_bytes(cell, layers, hidden, d_in, route, remat_gates)
                * batch * t_len)
    h, d = hidden, d_in
    gates = 4 if cell == "lstm" else 3
    if route == "layered":
        saved = 6 * h if cell == "lstm" else 5 * h
        live = d + (layers - 1) * h  # the input and the keep masks
        peak = 0
        for layer in range(layers):
            # the projection's product and sum, then ih beside the kernel's
            # outputs; between layers the h series and its masked copy
            peak = max(peak, live + max(2 * gates * h, gates * h + saved))
            live += saved
            if layer < layers - 1:
                peak = max(peak, live + 2 * h)
                live += h
        floats = max(peak, live + (9 * h if layers > 1 else 4 * h))
    elif route == "pair":
        packed = (2 if remat_gates else 10) * h if cell == "lstm" else 8 * h
        held = d + h + packed + 3 * h
        # the remat chain reads x padded to whole float4 columns
        pad = -(-d // 4) * 4 if cell == "lstm" and remat_gates and d % 4 else 0
        floats = max(held + gates * h, held + 8 * h + pad)
    else:
        rows = 12 * h if cell == "lstm" else 10 * h
        fwd = d + h + gates * h + rows + 3 * h  # + ih0 and the scratch exchange
        held = d + h + rows + (5 * h if cell == "lstm" else 3 * h)
        floats = max(fwd, held + (18 * h if cell == "lstm" else 20 * h))
    return 4 * floats * batch * t_len


def _bf16_bytes(cell: str, layers: int, h: int, d: int, route: str,
                remat_gates: bool = False) -> int:
    """``stack_residual_bytes`` per (T B) with bf16 residual streams: 2
    bytes a value of a bf16 series, 4 of a float32 one.

    The pairs hold x rounded to bf16 (D), keep (H, float32), packed (LSTM
    10H, 2H with ``remat_gates``, GRU 8H) and h0p / h1p / x1 (3H) in bf16.
    Their forward adds x's float32 copy and ih0 (4D + 4 gates H, float32)
    and its float32 exchange, x1 (H; each layer's own h takes two (B, H)
    slots, not counted); their chain the float32 exchange of layer 1 (LSTM
    dg1 4H, GRU dih1 and dhn1 4H; layer 0's two slots not counted) beside
    the bf16 outputs of both layers (8H), the remat chain also x padded to
    whole 16-byte pieces of 8 bf16 values where D is not a multiple of 8;
    then the weight gradients read a layer's outputs and an h series into
    float32 (5H) beside those outputs.  The layered LSTM holds g and c_prev
    (5H) in bf16, h_prev (H) float32, so a layer's residuals take 14 bytes
    of the float32 route's 24 a unit."""
    gates = 4 if cell == "lstm" else 3
    if route == "layered":
        saved = 14 * h
        live = 4 * (d + (layers - 1) * h)  # the input and the keep masks
        peak = 0
        for layer in range(layers):
            # the projection's product and sum, then ih beside the kernel's
            # outputs; between layers the h series and its masked copy
            peak = max(peak, live + max(8 * gates * h, 4 * gates * h + saved))
            live += saved
            if layer < layers - 1:
                peak = max(peak, live + 8 * h)
                live += 4 * h
        return max(peak, live + (36 * h if layers > 1 else 16 * h))
    remat = cell == "lstm" and remat_gates
    packed = 2 * h if remat else (10 * h if cell == "lstm" else 8 * h)
    held = 2 * d + 4 * h + 2 * (packed + 3 * h)
    fwd = held + 4 * d + 4 * gates * h + 4 * h
    pad = 2 * (-(-d // 8) * 8) if remat and d % 8 else 0
    chain = held + 4 * 4 * h + 2 * 8 * h + pad
    return max(fwd, chain, held + 2 * 8 * h + 4 * 5 * h)


def card_free_bytes(device: torch.device) -> int:
    """What the card can still give this process: the CUDA runtime's free bytes
    and the allocator's reserved but unallocated ones."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def check_residual_budget(cell: str, layers: int, hidden: int, d_in: int, batch: int,
                          t_len: int, route: str, free_bytes: int,
                          remat_gates: bool = False, held: int = 0,
                          res_dtype="float32") -> None:
    """Raise ``NotImplementedError`` where the stack's training residuals
    (``stack_residual_bytes``, less the ``held`` bytes of its inputs the
    caller already holds) exceed ``free_bytes``."""
    need = stack_residual_bytes(cell, layers, hidden, d_in, batch, t_len, route,
                                remat_gates, res_dtype) - held
    if need > free_bytes:
        raise NotImplementedError(
            f"a {layers}-layer {cell.upper()} of {hidden} units over {t_len} steps at "
            f"batch {batch} ({route} route) holds {need / 1e9:.2f} GB of residuals, "
            f"more than the card can still give ({free_bytes / 1e9:.2f} GB): chunked "
            "recompute is not ported yet (ROADMAP.md Queue 1 item 17)"
        )


def _check_long(cell: str, x: torch.Tensor, keep: torch.Tensor, layers: int,
                hidden: int, route: str, remat_gates: bool = False,
                res_dtype=torch.float32) -> None:
    """A training forward on the card past ``LONG_T`` steps checks its
    residual budget before it allocates anything."""
    if x.device.type != "cuda" or x.shape[1] <= LONG_T:
        return
    check_residual_budget(cell, layers, hidden, x.shape[2], x.shape[0], x.shape[1],
                          route, card_free_bytes(x.device), remat_gates,
                          held=keep.numel() * keep.element_size(), res_dtype=res_dtype)


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0] * a.shape[1], -1)


def _flat32(a: torch.Tensor) -> torch.Tensor:
    """A (T, B, .) series flattened to (T*B, .) in float32: a bf16 series
    read into float32, where products of bf16 values are exact, so the
    weight gradients are the JAX package's bf16 x bf16 contractions
    accumulating in float32, with a float32 result."""
    return _flat(a).to(torch.float32)


def _row_sums(a: torch.Tensor) -> torch.Tensor:
    """The sums over the rows of a flattened (T*B, C) series, a bias's
    gradient, as one matrix-vector product: on the card ``a.sum(0)`` holds a
    transient of twice the series (``chip_smoke.py`` ``[lstm2_remat_bf16]``
    prints both), which ``stack_residual_bytes`` does not count."""
    return (a.new_ones(1, a.shape[0]) @ a)[0]


def _layer_grads(x_l, h_prev, dg):
    """One LSTM layer's hoisted weight gradients ``(dW_ih, dW_hh, db)``
    from its input series, its h_prev series and its chain's dgates."""
    dgf = _flat32(dg)
    return _flat32(x_l).T @ dgf, _flat32(h_prev).T @ dgf, _row_sums(dgf)


def lstm_route(num_layers: int, hidden: int, sm_count: int) -> str:
    """``"pair"`` where the 2-layer kernels take the stack (2 layers, at
    most 2 hidden units per CTA of one CTA per SM), else ``"layered"``."""
    if num_layers == 2 and hidden <= 2 * sm_count:
        return "pair"
    return "layered"


# the GRU kernels come in the same two families with the same ceilings
gru_route = lstm_route


def rounds_weight_grads(cell: str, num_layers: int, hidden: int,
                        device: torch.device) -> bool:
    """Whether, under a bf16 compute dtype, the JAX package hands a training
    stack's weight gradients back rounded to the bf16 parameters' dtype:
    its LSTM custom VJP casts them on every route but the residual-native
    pair (the legacy pair under ``set_res2_mode("off")`` and the layered
    route cast); its GRU one forms them in bf16 on its bf16 scan (deeper
    than 2 layers: the port's layered route) and in float32 on both
    pairs."""
    route = lstm_route(num_layers, hidden, sm_count(device))
    if cell == "gru":
        return route != "pair"
    return route != "pair" or _RES2_MODE == "off"


def sm_count(device: torch.device) -> int:
    """The card's SM count, or the H100's for a CPU tensor."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


class FusedLSTMFinal(torch.autograd.Function):
    """(x (B, T, D), keep (T, B, H), remat_gates, res_dtype, w_ih0, w_hh0,
    b0, w_ih1, w_hh1, b1) -> final hidden state of layer 1 (B, H)."""

    @staticmethod
    def forward(ctx, x, keep, remat_gates, res_dtype, w_ih0, w_hh0, b0, w_ih1, w_hh1,
                b1):
        x_tm = x.to(torch.float32).transpose(0, 1).contiguous()
        layer0 = {"w_ih": w_ih0, "w_hh": w_hh0, "b": b0}
        layer1 = {"w_ih": w_ih1, "w_hh": w_hh1, "b": b1}
        packed, h0p, h1p, x1, finals = lstm2_train_fwd_residuals(
            x_tm, keep, layer0, layer1, store_gates=not remat_gates,
            res_dtype=res_dtype)
        ctx.remat_gates = remat_gates
        # x only forms dW_ih0, in the streams' dtype as the JAX package has it
        ctx.save_for_backward(x_tm.to(res_dtype), keep, packed, h0p, h1p, x1,
                              w_ih0, w_hh0, b0, w_ih1, w_hh1, b1)
        return finals[2].clone()

    @staticmethod
    def backward(ctx, dh_final):
        (x_tm, keep, packed, h0p, h1p, x1,
         w_ih0, w_hh0, b0, w_ih1, w_hh1, b1) = ctx.saved_tensors
        if ctx.remat_gates:
            dg0, dg1 = lstm2_bwd_chain_remat(
                packed, keep, x_tm, x1, h0p, h1p, dh_final,
                {"w_ih": w_ih0, "w_hh": w_hh0, "b": b0},
                {"w_ih": w_ih1, "w_hh": w_hh1, "b": b1})
        else:
            dg0, dg1 = lstm2_bwd_chain(packed, keep, dh_final, w_hh0, w_hh1, w_ih1)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dg0.to(torch.float32) @ w_ih0.T).transpose(0, 1)
        return (dx, None, None, None, *_layer_grads(x_tm, h0p, dg0),
                *_layer_grads(x1, h1p, dg1))


class LayeredLSTMFinal(torch.autograd.Function):
    """(x (B, T, D), keep (T, L-1, B, H), res_dtype, w_ih0, w_hh0, b0, ...,
    w_ih_{L-1}, w_hh_{L-1}, b_{L-1}) -> final hidden state of the top layer
    (B, H)."""

    @staticmethod
    def forward(ctx, x, keep, res_dtype, *weights):
        n_layers = len(weights) // 3
        x_l = x.to(torch.float32).transpose(0, 1).contiguous()
        residuals = []
        for layer in range(n_layers):
            w_ih, w_hh, b = weights[3 * layer:3 * layer + 3]
            g, h_prev, c_prev, finals = lstm1_train_fwd(
                torch.matmul(x_l, w_ih) + b, w_hh, res_dtype)
            residuals += [x_l, g, h_prev, c_prev]
            if layer < n_layers - 1:
                x_l = h_series(h_prev, finals) * keep[:, layer]
        ctx.save_for_backward(keep, *residuals, *weights)
        return finals[:, :w_hh.shape[0]].contiguous()

    @staticmethod
    def backward(ctx, dh_final):
        keep, *saved = ctx.saved_tensors
        n_layers = len(saved) // 7
        residuals, weights = saved[:4 * n_layers], saved[4 * n_layers:]
        dh_final = dh_final.to(torch.float32).contiguous()
        grads = [None] * (3 * n_layers)
        dh_series = None  # the top layer's per-step cotangent is zero
        for layer in reversed(range(n_layers)):
            x_l, g, h_prev, c_prev = residuals[4 * layer:4 * layer + 4]
            w_ih, w_hh = weights[3 * layer], weights[3 * layer + 1]
            dhf = dh_final if layer == n_layers - 1 else torch.zeros_like(dh_final)
            dg = lstm_bwd_chain(g, c_prev, dh_series, dhf, w_hh)
            grads[3 * layer:3 * layer + 3] = _layer_grads(x_l, h_prev, dg)
            if layer > 0:
                dh_series = torch.matmul(dg, w_ih.T) * keep[:, layer - 1]
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dg, weights[0].T).transpose(0, 1)
        return (dx, None, None, *grads)


def _shift(a: torch.Tensor) -> torch.Tensor:
    """The series before each step from the series after it: zero, then
    all but the last (the JAX package's ``shift``)."""
    return torch.cat([torch.zeros_like(a[:1]), a[:-1]])


class LegacyLSTMFinal(torch.autograd.Function):
    """(x (B, T, D), keep (T, B, H), w_ih0, w_hh0, b0, w_ih1, w_hh1, b1) ->
    final hidden state of layer 1 (B, H), over the legacy layout."""

    @staticmethod
    def forward(ctx, x, keep, w_ih0, w_hh0, b0, w_ih1, w_hh1, b1):
        x_tm = x.to(torch.float32).transpose(0, 1).contiguous()
        ys, h_final, g0, g1, h0n, c0n, c1n = lstm2_train_fwd_legacy(
            x_tm, keep, {"w_ih": w_ih0, "w_hh": w_hh0, "b": b0},
            {"w_ih": w_ih1, "w_hh": w_hh1, "b": b1})
        # the JAX package's residual structure: the states before each
        # step, and layer 1's input series
        x1 = h0n * keep.to(torch.float32)
        ctx.save_for_backward(x_tm, keep, g0, g1, _shift(c0n), _shift(c1n),
                              _shift(h0n), _shift(ys), x1, w_ih0, w_hh0, w_ih1,
                              w_hh1)
        return h_final

    @staticmethod
    def backward(ctx, dh_final):
        (x_tm, keep, g0, g1, c0p, c1p, h0p, h1p, x1,
         w_ih0, w_hh0, w_ih1, w_hh1) = ctx.saved_tensors
        dg0, dg1 = lstm2_bwd_chain_legacy(g0, g1, c0p, c1p, None, keep, dh_final,
                                          w_hh0, w_hh1, w_ih1)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dg0 @ w_ih0.T).transpose(0, 1)
        return (dx, None, *_layer_grads(x_tm, h0p, dg0), *_layer_grads(x1, h1p, dg1))


def fused_lstm_final(x: torch.Tensor, keep: torch.Tensor,
                     layers: Sequence[Params], remat_gates: bool = False,
                     res_dtype=torch.float32) -> torch.Tensor:
    """x (B, T, D), keep (T, L-1, B, H) the inter-layer keep masks ->
    the top layer's final hidden state (B, H), differentiable in x and
    every layer's parameters.  The route is ``lstm_route``'s; on the pair
    route ``set_res2_mode("off")`` takes the legacy layout, and only the
    residual-native pair reads ``remat_gates``, as in the JAX package.
    ``res_dtype`` (``residual_dtype``'s: "float32", "bfloat16" or the torch
    dtype) is the residual streams' on the residual-native pair, with or
    without ``remat_gates``, and on the layered route; the legacy route
    ignores it.  On the card past ``LONG_T`` steps a stack whose residuals
    do not fit raises (``check_residual_budget``)."""
    res_dtype = residual_dtype(res_dtype)
    weights = [p[name] for p in layers for name in ("w_ih", "w_hh", "b")]
    h_dim = layers[0]["w_hh"].shape[0]
    route = lstm_route(len(layers), h_dim, sm_count(x.device))
    if route == "pair" and _RES2_MODE == "off":
        route = "legacy"
    if route == "legacy":
        res_dtype = torch.float32
    if (route == "pair" and remat_gates and res_dtype == torch.bfloat16
            and x.device.type == "cuda" and h_dim % 8):
        raise NotImplementedError(
            f"the gate-rematerialising pair's bf16 form on the card copies 16-byte "
            f"pieces of the h rows, so H % 8 == 0; H={h_dim} (ROADMAP.md Queue 2, "
            "shape ceilings)")
    _check_long("lstm", x, keep, len(layers), h_dim, route, bool(remat_gates), res_dtype)
    if route == "legacy":
        return LegacyLSTMFinal.apply(x, keep[:, 0], *weights)
    if route == "pair":
        return FusedLSTMFinal.apply(x, keep[:, 0], bool(remat_gates), res_dtype, *weights)
    return LayeredLSTMFinal.apply(x, keep, res_dtype, *weights)


def check_gru_stack(hidden: int, sm_count: int) -> None:
    """Raise unless a GRU kernel takes layers of ``hidden`` units: the
    one-layer kernels hold at most 8 hidden units per CTA of one CTA per
    SM, and the 2-layer ones fewer."""
    if hidden > 8 * sm_count:
        raise NotImplementedError(
            f"a GRU of {hidden} units: the GRU kernels take at most "
            f"{8 * sm_count} on a card of {sm_count} SMs (ROADMAP.md Queue 2, "
            "shape ceilings)"
        )


def _gru_layer_grads(x_l, h_prev, dih, dhn):
    """One GRU layer's hoisted weight gradients ``(dW_ih, dW_hh, db_ih,
    db_hh)`` from its chain's ``dih`` and ``dhn`` (the shared-lane
    assembly of ``dhh``), bf16 series read into float32 (``_flat32``)."""
    h_dim = dhn.shape[-1]
    dih_f, dhn_f, hp_t = _flat32(dih), _flat32(dhn), _flat32(h_prev).T
    db_ih = _row_sums(dih_f)
    return (_flat32(x_l).T @ dih_f,
            torch.cat([hp_t @ dih_f[:, :2 * h_dim], hp_t @ dhn_f], dim=1),
            db_ih, torch.cat([db_ih[:2 * h_dim], _row_sums(dhn_f)]))


class FusedGRUFinal(torch.autograd.Function):
    """(x (B, T, D), keep (T, B, H), res_dtype, w_ih0, w_hh0, b_ih0, b_hh0,
    w_ih1, w_hh1, b_ih1, b_hh1) -> final hidden state of layer 1 (B, H)."""

    @staticmethod
    def forward(ctx, x, keep, res_dtype, w_ih0, w_hh0, b_ih0, b_hh0, w_ih1, w_hh1, b_ih1,
                b_hh1):
        x_tm = x.to(torch.float32).transpose(0, 1).contiguous()
        layer0 = {"w_ih": w_ih0, "w_hh": w_hh0, "b_ih": b_ih0, "b_hh": b_hh0}
        layer1 = {"w_ih": w_ih1, "w_hh": w_hh1, "b_ih": b_ih1, "b_hh": b_hh1}
        packed, h0p, h1p, x1, finals = gru2_train_fwd_residuals(
            x_tm, keep, layer0, layer1, res_dtype)
        # x only forms dW_ih0, in the streams' dtype as the JAX package has it
        ctx.save_for_backward(x_tm.to(res_dtype), keep, packed, h0p, h1p, x1,
                              w_ih0, w_hh0, w_ih1, w_hh1)
        return finals[1].clone()

    @staticmethod
    def backward(ctx, dh_final):
        (x_tm, keep, packed, h0p, h1p, x1,
         w_ih0, w_hh0, w_ih1, w_hh1) = ctx.saved_tensors
        dih0, dhn0, dih1, dhn1 = gru2_bwd_chain(packed, h0p, h1p, keep, dh_final,
                                                w_hh0, w_hh1, w_ih1)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dih0.to(torch.float32) @ w_ih0.T).transpose(0, 1)
        return (dx, None, None, *_gru_layer_grads(x_tm, h0p, dih0, dhn0),
                *_gru_layer_grads(x1, h1p, dih1, dhn1))


class LayeredGRUFinal(torch.autograd.Function):
    """(x (B, T, D), keep (T, L-1, B, H), w_ih0, w_hh0, b_ih0, b_hh0, ...,
    b_hh_{L-1}) -> final hidden state of the top layer (B, H)."""

    @staticmethod
    def forward(ctx, x, keep, *weights):
        n_layers = len(weights) // 4
        x_l = x.to(torch.float32).transpose(0, 1).contiguous()
        residuals = []
        for layer in range(n_layers):
            w_ih, w_hh, b_ih, b_hh = weights[4 * layer:4 * layer + 4]
            gates, h_prev, h = gru1_train_fwd(torch.matmul(x_l, w_ih) + b_ih,
                                              w_hh, b_hh)
            residuals += [x_l, gates, h_prev]
            if layer < n_layers - 1:
                x_l = h_series(h_prev, h) * keep[:, layer]
        ctx.save_for_backward(keep, *residuals, *weights)
        return h

    @staticmethod
    def backward(ctx, dh_final):
        keep, *saved = ctx.saved_tensors
        n_layers = len(saved) // 7
        residuals, weights = saved[:3 * n_layers], saved[3 * n_layers:]
        dh_final = dh_final.to(torch.float32).contiguous()
        grads = [None] * (4 * n_layers)
        dh_series = None  # the top layer's per-step cotangent is zero
        for layer in reversed(range(n_layers)):
            x_l, gates, h_prev = residuals[3 * layer:3 * layer + 3]
            w_ih, w_hh = weights[4 * layer], weights[4 * layer + 1]
            dhf = dh_final if layer == n_layers - 1 else torch.zeros_like(dh_final)
            dih, dhn = gru_bwd_chain(gates, h_prev, dh_series, dhf, w_hh)
            grads[4 * layer:4 * layer + 4] = _gru_layer_grads(x_l, h_prev, dih, dhn)
            if layer > 0:
                dh_series = torch.matmul(dih, w_ih.T) * keep[:, layer - 1]
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dih, weights[0].T).transpose(0, 1)
        return (dx, None, *grads)


class LegacyGRUFinal(torch.autograd.Function):
    """(x (B, T, D), keep (T, B, H), w_ih0, w_hh0, b_ih0, b_hh0, w_ih1,
    w_hh1, b_ih1, b_hh1) -> final hidden state of layer 1 (B, H), over the
    legacy layout."""

    @staticmethod
    def forward(ctx, x, keep, w_ih0, w_hh0, b_ih0, b_hh0, w_ih1, w_hh1, b_ih1, b_hh1):
        x_tm = x.to(torch.float32).transpose(0, 1).contiguous()
        _, h_final, (layer0, layer1) = gru2_train_fwd_legacy(
            x_tm, keep, {"w_ih": w_ih0, "w_hh": w_hh0, "b_ih": b_ih0, "b_hh": b_hh0},
            {"w_ih": w_ih1, "w_hh": w_hh1, "b_ih": b_ih1, "b_hh": b_hh1})
        # the JAX package's residual structure: (h_prev, r, z, n, hn) per
        # layer, and layer 1's input series
        x1 = layer0[4] * keep.to(torch.float32)
        ctx.save_for_backward(x_tm, keep, x1, _shift(layer0[4]), *layer0[:4],
                              _shift(layer1[4]), *layer1[:4], w_ih0, w_hh0,
                              w_ih1, w_hh1)
        return h_final

    @staticmethod
    def backward(ctx, dh_final):
        x_tm, keep, x1, *saved = ctx.saved_tensors
        res0, res1 = saved[:5], saved[5:10]
        w_ih0, w_hh0, w_ih1, w_hh1 = saved[10:]
        chain = (gru2_bwd_chain_legacy if GRU_BWD2_ENABLED
                 else gru_bwd_layered_legacy)
        (dih0, dhh0), (dih1, dhh1) = chain(res0, res1, None, keep, dh_final,
                                           w_hh0, w_hh1, w_ih1)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dih0 @ w_ih0.T).transpose(0, 1)
        grads = []
        for x_l, h_prev, dih, dhh in ((x_tm, res0[0], dih0, dhh0),
                                      (x1, res1[0], dih1, dhh1)):
            dih_f, dhh_f = _flat(dih), _flat(dhh)
            grads += [_flat(x_l).T @ dih_f, _flat(h_prev).T @ dhh_f,
                      _row_sums(dih_f), _row_sums(dhh_f)]
        return (dx, None, *grads)


def gru_bwd_layered_legacy(res0, res1, dys, keep_tm: torch.Tensor,
                           dh_final: torch.Tensor, w_hh0: torch.Tensor,
                           w_hh1: torch.Tensor, w_ih1: torch.Tensor):
    """The legacy GRU backward without the fused chain, the JAX
    package's ``_gru_bwd_layered_pallas``: layer 1's ``gru_bwd_chain``, the
    hop ``(dih1 w_ih1^T) * keep`` into layer 0 as one matmul, layer 0's
    chain.  Takes and returns what ``gru2_bwd_chain_legacy`` does: ``res0``
    / ``res1`` the layers' ``(h_prev, r, z, n, hn)`` series -> ``((dih0,
    dhh0), (dih1, dhh1))`` with the full ``dhh = [dih[..., :2H] | dhn]``."""
    h_dim = w_hh0.shape[0]
    dh_final = dh_final.to(torch.float32).contiguous()

    def layer(res, dh_series, dhf, w_hh):
        dih, dhn = gru_bwd_chain(torch.cat(res[1:], dim=-1), res[0], dh_series,
                                 dhf, w_hh)
        return dih, torch.cat([dih[..., :2 * h_dim], dhn], dim=-1)

    dih1, dhh1 = layer(res1, dys, dh_final, w_hh1)
    hop = torch.matmul(dih1, w_ih1.T) * keep_tm.to(torch.float32)
    return layer(res0, hop, torch.zeros_like(dh_final), w_hh0), (dih1, dhh1)


def fused_gru_final(x: torch.Tensor, keep: torch.Tensor,
                    layers: Sequence[Params], res_dtype=torch.float32) -> torch.Tensor:
    """x (B, T, D), keep (T, L-1, B, H) the inter-layer keep masks -> the
    top layer's final hidden state (B, H), differentiable in x and every
    layer's parameters.  The route is ``gru_route``'s, on the pair route
    ``set_res2_mode("off")`` takes the legacy layout; ``res_dtype`` is the
    residual streams' on the residual-native pair, which alone reads it, as
    in the JAX package.  A width that ``check_gru_stack`` refuses raises,
    on the CPU as on the card, and on the card past ``LONG_T`` steps a
    stack whose residuals do not fit (``check_residual_budget``)."""
    res_dtype = residual_dtype(res_dtype)
    h_dim = layers[0]["w_hh"].shape[0]
    sms = sm_count(x.device)
    check_gru_stack(h_dim, sms)
    weights = [p[name] for p in layers for name in ("w_ih", "w_hh", "b_ih", "b_hh")]
    route = gru_route(len(layers), h_dim, sms)
    if route == "pair" and _RES2_MODE == "off":
        route = "legacy"
    if route != "pair":
        res_dtype = torch.float32
    _check_long("gru", x, keep, len(layers), h_dim, route, res_dtype=res_dtype)
    if route == "legacy":
        return LegacyGRUFinal.apply(x, keep[:, 0], *weights)
    if route == "pair":
        return FusedGRUFinal.apply(x, keep[:, 0], res_dtype, *weights)
    return LayeredGRUFinal.apply(x, keep, *weights)
