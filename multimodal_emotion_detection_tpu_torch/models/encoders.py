"""Per-modality encoders of the ported slice (serving and training).

* ``SequenceEncoder`` — the recurrent branch (an LSTM of 2 or more layers,
  or a 2-layer GRU): final hidden state -> Linear projection;
* ``FrameEncoder`` — per-frame Linear + ReLU, temporal pooling
  (attention / average / max), LayerNorm, Linear projection;
* ``build_encoder`` — the factory, with the JAX package's config keys,
  defaults and modality-name heuristics.

Module and parameter names follow the JAX package's parameter tree, so a
converted JAX checkpoint loads key for key.  Dropout acts only in training
mode, with masks drawn from the forward's ``Noise``; in eval mode it is
the identity.  Encoder kinds outside the slice raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.models.noise import Noise, dropout
from multimodal_emotion_detection_tpu_torch.models.recurrent import (
    FusedStackedRNN,
)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int = 1):
    """Mean over ``dim`` honouring an optional (B, T) validity mask."""
    if mask is None:
        return x.mean(dim=dim)
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=dim) / m.sum(dim=dim).clamp(min=1.0)


def masked_max(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int = 1):
    if mask is None:
        return x.amax(dim=dim)
    very_neg = torch.finfo(x.dtype).min
    m = mask.to(torch.bool)[..., None]
    return torch.where(m, x, torch.full_like(x, very_neg)).amax(dim=dim)


class AttentionPool(nn.Module):
    """Learned scalar score per frame -> softmax over time -> weighted sum."""

    def __init__(self, dim: int):
        super().__init__()
        self.attention = nn.Linear(dim, 1)

    def forward(self, frames: torch.Tensor, mask: Optional[torch.Tensor] = None):
        scores = self.attention(frames)[..., 0]
        if mask is not None:
            scores = torch.where(mask.to(torch.bool), scores,
                                 torch.full_like(scores, -1e9))
        weights = torch.softmax(scores, dim=1)  # (B, T)
        return torch.einsum("bt,bth->bh", weights, frames)


class SequenceEncoder(nn.Module):
    """Time series (B, T, D) -> L-layer LSTM (L >= 2) or 2-layer GRU
    (``encoder_type``) final hidden -> Linear."""

    # past this length the JAX package switches to the layerwise scan
    MAX_FUSED_LEN = 2048

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, dropout: float = 0.1,
                 encoder_type: str = "lstm"):
        super().__init__()
        # the JAX package drops out between layers only
        self.rnn = FusedStackedRNN(input_dim, hidden_dim, num_layers,
                                   dropout=dropout if num_layers > 1 else 0.0,
                                   cell_type=encoder_type)
        self.projection = nn.Linear(hidden_dim, output_dim)

    def forward(self, sequence: torch.Tensor,
                noise: Optional[Noise] = None) -> torch.Tensor:
        if sequence.shape[1] > self.MAX_FUSED_LEN:
            kind = self.rnn.cell_type.upper()
            item = 6 if kind == "GRU" else 3
            raise NotImplementedError(
                f"sequence of {sequence.shape[1]} steps: the layerwise "
                f"chunked-remat {kind} (StackedRNN, e.g. model.frontend.audio="
                f"raw) is not ported yet (ROADMAP.md Queue 1 item {item})"
            )
        return self.projection(self.rnn(sequence.to(torch.float32), noise))


class FrameEncoder(nn.Module):
    """Per-frame MLP + dropout + temporal pooling + dropout + LayerNorm +
    projection."""

    def __init__(self, frame_dim: int, hidden_dim: int, output_dim: int,
                 temporal_pooling: str = "attention", dropout: float = 0.1):
        super().__init__()
        if temporal_pooling not in ("attention", "average", "max"):
            raise ValueError(f"Unknown pooling: {temporal_pooling}")
        self.temporal_pooling = temporal_pooling
        self.dropout = float(dropout)
        self.frame_mlp = nn.Linear(frame_dim, hidden_dim)
        if temporal_pooling == "attention":
            self.pool = AttentionPool(hidden_dim)
        self.proj_ln = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.projection = nn.Linear(hidden_dim, output_dim)

    def forward(self, frames: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None) -> torch.Tensor:
        p = self.dropout if self.training else 0.0
        x = dropout(torch.relu(self.frame_mlp(frames.to(torch.float32))), p, noise)
        if self.temporal_pooling == "attention":
            pooled = self.pool(x, mask)
        elif self.temporal_pooling == "average":
            pooled = masked_mean(x, mask, dim=1)
        else:
            pooled = masked_max(x, mask, dim=1)
        return self.projection(self.proj_ln(dropout(pooled, p, noise)))


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

_SEQUENCE_MODALITIES = {
    "imu", "mocap", "audio", "accelerometer", "gyro", "magnetometer",
    "imu_hand", "imu_chest", "imu_ankle",
}


def build_encoder(
    modality: str,
    input_dim: int,
    output_dim: int,
    encoder_config: Optional[Dict[str, Any]] = None,
) -> nn.Module:
    """Route a per-modality config dict to an encoder module.

    Same keys, defaults and heuristics as the JAX factory ('video'/'frames'
    -> frame, audio/imu/... -> sequence, else mlp; hidden_dim defaults to
    2*output_dim; dropout defaults to 0.1).  Route keys of the TPU build
    (``scan_unroll``, ``inference_kernel``, ``use_flash``) are accepted and
    do not route: the device does.
    """
    cfg = dict(encoder_config or {})
    enc_type = cfg.pop("type", None)
    in_dim = cfg.pop("input_dim", input_dim)
    dt_over = cfg.pop("dtype", None)
    if dt_over not in (None, "float32"):
        raise NotImplementedError(
            f"model.encoders.{modality}.dtype={dt_over!r}: only float32 "
            "is ported (ROADMAP.md Queue 1 item 13)"
        )

    if enc_type is None:
        mod = modality.lower()
        if mod in {"video", "frames"}:
            enc_type = "frame"
        elif mod in _SEQUENCE_MODALITIES:
            enc_type = "sequence"
        else:
            enc_type = "mlp"

    hidden = cfg.pop("hidden_dim", None)
    hidden = hidden if hidden is not None else output_dim * 2
    rate = cfg.pop("dropout", 0.1)
    if enc_type == "frame":
        return FrameEncoder(
            frame_dim=in_dim,
            hidden_dim=hidden,
            output_dim=output_dim,
            temporal_pooling=cfg.pop("temporal_pooling", "attention"),
            dropout=rate,
        )
    if enc_type == "sequence":
        kind = cfg.pop("encoder_type", "lstm")
        if kind not in ("lstm", "gru"):
            raise NotImplementedError(
                f"model.encoders.{modality}.encoder_type={kind!r} is not "
                "ported yet (ROADMAP.md Queue 1 item 8)"
            )
        if not cfg.pop("fused", True):
            item = 6 if kind == "gru" else 3
            raise NotImplementedError(
                f"model.encoders.{modality}.fused=false: the layerwise "
                f"{kind.upper()} is not ported yet (ROADMAP.md Queue 1 item {item})"
            )
        return SequenceEncoder(
            input_dim=in_dim,
            hidden_dim=hidden,
            output_dim=output_dim,
            num_layers=cfg.pop("num_layers", 2),
            dropout=rate,
            encoder_type=kind,
        )
    if enc_type in ("mlp", "pretrained_cnn"):
        raise NotImplementedError(
            f"encoder type {enc_type!r} for modality '{modality}' is not "
            "ported yet (ROADMAP.md Queue 1 item 8)"
        )
    raise ValueError(f"Unknown encoder type '{enc_type}' for modality '{modality}'")
