"""ResNet backbones (resnet18 / 34 / 50) for the image CNN encoder.

The JAX package's ``models/resnet.py``, the torchvision topologies without
their ``fc``: a 7x7 stride-2 stem (padding 3) -> BatchNorm -> ReLU -> 3x3
stride-2 max pool (padding 1, padded with -inf) -> four stages of basic or
bottleneck blocks (stride 2 on each stage's first block past stage 0, a
1x1 convolution and BatchNorm on the residual where its shape changes)
-> the mean over H and W.  Module names are the JAX tree's
(``stem_conv``, ``stem_bn``, ``stage{s}_block{b}``, ``conv1..3``,
``bn1..3``, ``downsample_conv``, ``downsample_bn``), so
``utils/weights.py`` maps a JAX tree path for path.

Activations stay NHWC (B, H, W, C) in memory, as in the JAX package:
the convolutions and the pool take an NCHW view in the channels_last
layout (``models/layers.py::conv2d``), which cuDNN reads without a copy.
BatchNorm is ``models/batchnorm.py`` (flax's biased variance and momentum
0.99), over (B, H, W).  The convolutions and the pool run in cuDNN on the
card, as the JAX package's run in XLA: no Pallas kernel of the JAX package
computes them.  A bf16 input runs the whole backbone in bf16 over float32
parameters, as flax's ``dtype=bfloat16`` (``conv2d``, BatchNorm's bf16
form; the mean sums in float32 and rounds once).

``load_torch_resnet_weights`` reads a torchvision-layout ``state_dict``
(a local file or a mapping; nothing is downloaded) into this module's
``state_dict`` keys.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_emotion_detection_tpu_torch.models.batchnorm import (
    BatchNorm,
    use_running_average,
)
from multimodal_emotion_detection_tpu_torch.models.layers import conv2d


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = _conv(in_features, features, 3, strides)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm(features)
        # the residual's shape changes exactly where the channels do
        if in_features != features:
            self.downsample_conv = _conv(in_features, features, 1, strides)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, running: bool) -> torch.Tensor:
        y = torch.relu(self.bn1(conv2d(self.conv1, x), running))
        y = self.bn2(conv2d(self.conv2, y), running)
        return torch.relu(y + _residual(self, x, running))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = _conv(in_features, features, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3, strides)
        self.bn2 = BatchNorm(features)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = BatchNorm(out)
        if in_features != out:
            self.downsample_conv = _conv(in_features, out, 1, strides)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor, running: bool) -> torch.Tensor:
        y = torch.relu(self.bn1(conv2d(self.conv1, x), running))
        y = torch.relu(self.bn2(conv2d(self.conv2, y), running))
        y = self.bn3(conv2d(self.conv3, y), running)
        return torch.relu(y + _residual(self, x, running))


def _residual(block: nn.Module, x: torch.Tensor, running: bool) -> torch.Tensor:
    if not hasattr(block, "downsample_conv"):
        return x
    return block.downsample_bn(conv2d(block.downsample_conv, x), running)


_VARIANTS: Dict[str, tuple] = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


def feature_dim(variant: str) -> int:
    block_cls, _ = _VARIANTS[variant]
    return 512 * block_cls.expansion


class ResNet(nn.Module):
    """(B, H, W, C) -> (B, feature_dim(variant)) pooled features.  The stem
    takes ``in_channels`` channels, fixed at build (flax infers the count
    from the first input); torchvision's weights have 3."""

    def __init__(self, variant: str = "resnet18", in_channels: int = 3):
        super().__init__()
        self.variant = variant
        block_cls, stage_sizes = _VARIANTS[variant]
        self.stem_conv = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(64)
        self.blocks = []
        width = 64
        for stage, num_blocks in enumerate(stage_sizes):
            features = 64 * 2 ** stage
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage}_block{block}"
                self.add_module(name, block_cls(width, features, strides))
                self.blocks.append(name)
                width = features * block_cls.expansion

    def forward(self, x: torch.Tensor, bn_eval: Optional[bool] = None) -> torch.Tensor:
        # the blocks hold no dropout: the module's mode is the BatchNorm
        # mode, which bn_eval overrides (MC dropout)
        running = use_running_average(self.training, bn_eval)
        y = torch.relu(self.stem_bn(conv2d(self.stem_conv, x), running))
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for name in self.blocks:
            y = getattr(self, name)(y, running)
        if y.dtype == torch.bfloat16:
            return y.float().mean(dim=(1, 2)).to(y.dtype)
        return y.mean(dim=(1, 2))


def load_torch_resnet_weights(state_dict, variant: str = "resnet18") -> Dict[str, torch.Tensor]:
    """A torchvision resnet ``state_dict`` (``conv1.weight``, ``bn1.*``,
    ``layer{s+1}.{b}.conv{i}.weight`` / ``bn{i}.*``,
    ``.downsample.0.weight`` / ``.downsample.1.*``), given as a mapping or
    as the path of a local ``torch.save`` file, as this module's
    ``state_dict`` entries.  Both lay a convolution out OIHW, so every
    tensor is taken as it is; ``num_batches_tracked`` and ``fc.*`` are
    left out."""
    sd = (state_dict if isinstance(state_dict, Mapping)
          else torch.load(state_dict, map_location="cpu"))
    out: Dict[str, torch.Tensor] = {}

    def take(src: str, dst: str) -> None:
        out[dst] = torch.as_tensor(sd[src]).detach()

    def bn(src: str, dst: str) -> None:
        for key in ("weight", "bias", "running_mean", "running_var"):
            take(f"{src}.{key}", f"{dst}.{key}")

    take("conv1.weight", "stem_conv.weight")
    bn("bn1", "stem_bn")
    block_cls, stage_sizes = _VARIANTS[variant]
    n_convs = 3 if block_cls is Bottleneck else 2
    for stage, num_blocks in enumerate(stage_sizes):
        for block in range(num_blocks):
            src, dst = f"layer{stage + 1}.{block}", f"stage{stage}_block{block}"
            for i in range(1, n_convs + 1):
                take(f"{src}.conv{i}.weight", f"{dst}.conv{i}.weight")
                bn(f"{src}.bn{i}", f"{dst}.bn{i}")
            if f"{src}.downsample.0.weight" in sd:
                take(f"{src}.downsample.0.weight", f"{dst}.downsample_conv.weight")
                bn(f"{src}.downsample.1", f"{dst}.downsample_bn")
    return out
