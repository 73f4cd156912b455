"""Linear, convolution, LayerNorm and mean in a compute dtype, as flax's
layers run with ``dtype``: float32 is the torch layer itself, bit for
bit; bf16 computes over float32 parameters cast (Linear, convolution) or
read (LayerNorm) at flax's points.  Shared by the encoders, the fusion
library and the classifier's head."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def bf16_scalar(value: float) -> float:
    """``value`` rounded to bf16: a weakly typed constant of a bf16
    computation in JAX takes the array's dtype before the operation."""
    return float(torch.tensor(value, dtype=torch.bfloat16))


def dense(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``linear`` in ``x``'s dtype, as flax's Dense with ``dtype``: in bf16
    the input, weight and bias are bf16, the product (float32 sums) is
    rounded to bf16 and the bias added in bf16.  Any other dtype is
    ``linear(x)``."""
    if x.dtype != torch.bfloat16:
        return linear(x)
    return (torch.matmul(x, linear.weight.to(x.dtype).t())
            + linear.bias.to(x.dtype))


def conv(layer: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` on (B, C, T) ``x`` in ``x``'s dtype, as flax's Conv with
    ``dtype``: in bf16 the convolution of the bf16 input and weight is
    rounded to bf16, then the bf16 bias is added in bf16.  Any other dtype
    is ``layer(x)``."""
    if x.dtype != torch.bfloat16:
        return layer(x)
    return (F.conv1d(x, layer.weight.to(x.dtype), None, layer.stride, layer.padding)
            + layer.bias.to(x.dtype)[:, None])


def conv2d(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` (no bias) on NHWC ``x``, NHWC out, in ``x``'s dtype, as
    flax's 2-D Conv with ``dtype``: in bf16 the convolution of the bf16
    input and weight is rounded to bf16.  The convolution sees
    ``x.permute(0, 3, 1, 2)``, an NCHW view in the channels_last layout,
    so neither side is copied to another layout.

    On the CPU, a bf16 input narrower than the kernel (H or W) runs as the
    float32 convolution of the bf16-rounded input and weight, rounded to
    bf16 once: the same exact products summed in float32.  There torch's
    CPU bf16 kernel reads uninitialised memory in its backward (strided
    3x3 and 7x7 convolutions of 1x1 and 4x1 inputs: gradients of 1e23 or
    NaN, different on every call)."""
    if x.dtype != torch.bfloat16:
        y = F.conv2d(x.permute(0, 3, 1, 2), layer.weight, None, layer.stride, layer.padding)
        return y.permute(0, 2, 3, 1)
    weight = layer.weight.to(x.dtype)
    if x.device.type == "cpu" and min(x.shape[1:3]) < max(layer.kernel_size):
        y = F.conv2d(x.permute(0, 3, 1, 2).float(), weight.float(), None, layer.stride,
                     layer.padding).to(x.dtype)
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, layer.stride, layer.padding)
    return y.permute(0, 2, 3, 1)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``ln`` in ``x``'s dtype, as flax's LayerNorm with ``dtype``: in bf16
    the statistics and the normalisation run in float32 on the upcast
    input and the result is rounded to bf16 once (flax's ``_compute_stats``
    / ``_normalize``; its E[x^2] - mean^2 variance and torch's two-pass one
    differ by float32 round-off, under the bf16 rounding that follows).
    Any other dtype is ``ln(x)``."""
    if x.dtype != torch.bfloat16:
        return ln(x)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int = 1):
    """Mean over ``dim`` honouring an optional (B, T) validity mask.  On
    bf16 the sums run in float32 and are rounded to bf16 once, as
    ``jnp.mean`` (sum and divide in float32) and ``jnp.sum`` (float32 sum)
    do; the masked mean divides its two rounded sums in bf16, as the JAX
    function does."""
    half = x.dtype == torch.bfloat16
    if mask is None:
        return x.float().mean(dim=dim).to(x.dtype) if half else x.mean(dim=dim)
    m = mask.to(x.dtype)[..., None]
    if not half:
        return (x * m).sum(dim=dim) / m.sum(dim=dim).clamp(min=1.0)
    summed = (x * m).float().sum(dim=dim).to(x.dtype)
    return summed / m.float().sum(dim=dim).clamp(min=1.0).to(x.dtype)
