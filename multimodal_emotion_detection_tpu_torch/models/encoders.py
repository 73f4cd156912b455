"""Per-modality encoders of the ported slices (serving and training).

* ``SequenceEncoder`` — the recurrent branch (an LSTM or a GRU of any
  depth): final hidden state -> Linear projection; the transformer branch:
  Linear in-projection + learned positions -> post-LN
  ``TransformerBlock`` s (attention through the flash kernels) -> mean over
  time -> Linear projection; and the CNN branch: Conv1d k5 -> BatchNorm ->
  ReLU -> Dropout -> Conv1d k3 -> BatchNorm -> ReLU -> mean over time ->
  Dropout -> Linear projection;
* ``FrameEncoder`` — per-frame Linear + ReLU, temporal pooling
  (attention / average / max), LayerNorm, Linear projection;
* ``SimpleMLPEncoder`` — [Linear -> BatchNorm -> ReLU -> Dropout] x n ->
  Linear, mean over time for a (B, T, D) input;
* ``ImageCNNEncoder`` — a ResNet backbone (``models/resnet.py``) over
  (B, H, W, C) images or (B, T, H, W, C) frames folded into the batch,
  temporal pooling, dropout, LayerNorm, Linear projection;
* ``build_encoder`` — the factory, with the JAX package's config keys,
  defaults and modality-name heuristics.

Module and parameter names follow the JAX package's parameter tree, so a
converted JAX checkpoint loads key for key.  Dropout acts only in training
mode, with masks (and the attention kernels' Philox seeds) drawn from the
forward's ``Noise``; in eval mode it is the identity.  BatchNorm
(``models/batchnorm.py``) normalises with the batch statistics in
training mode and the running ones in eval mode, unless ``bn_eval`` says
otherwise (``bn_eval=True``: running statistics in a training-mode
forward, as MC dropout asks); every encoder takes ``bn_eval``, and those
without BatchNorm ignore it.  ``lengths`` into an LSTM or GRU encoder
raises ``NotImplementedError`` naming the ``ROADMAP.md`` items that port
it.

A per-encoder ``dtype: bfloat16`` (the JAX factory's mixed-precision
override), or the model's compute dtype it overrides
(``runtime.compute_dtype``, handed in as ``build_encoder``'s ``dtype``),
runs every encoder here in bf16 with float32 parameters, as flax does with
``dtype=bfloat16``: every Linear casts its input, weight and bias to bf16
and returns bf16 (``dense``), the position table is cast before the
lookup, LayerNorm and BatchNorm take their statistics and normalise in
float32 and round the result to bf16 once (``layer_norm``,
``models/batchnorm.py``; flax's ``_compute_stats`` / ``_normalize``), the
CNN's and the ResNet's convolutions run on bf16 input, weight and bias
(``conv``, ``conv2d``), GELU, ReLU, softmax, dropout and the pooling act
on bf16, attention runs the flash kernels' bf16 forms, and the LSTM and
GRU hand their recurrent kernels bf16-rounded operands
(``models/recurrent.py``).  Reductions sum
in float32 and round once (``masked_mean``), as ``jnp.sum`` / ``jnp.mean``
do for bf16.  Each encoder returns its output in its own dtype; the
classifier casts it to the model's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_emotion_detection_tpu_torch.models.batchnorm import (
    BatchNorm,
    use_running_average,
)
from multimodal_emotion_detection_tpu_torch.models.layers import (
    conv,
    dense,
    layer_norm,
    masked_mean,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise, dropout
from multimodal_emotion_detection_tpu_torch.models.recurrent import (
    FusedStackedRNN,
)
from multimodal_emotion_detection_tpu_torch.models.resnet import ResNet, feature_dim
from multimodal_emotion_detection_tpu_torch.ops.flash_attention import (
    MASKED,
    flash_attention,
)


ENCODER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        scores = dense(self.attention, frames)[..., 0]
        if mask is not None:
            scores = torch.where(mask.to(torch.bool), scores,
                                 torch.full_like(scores, -1e9))
        weights = torch.softmax(scores, dim=1)  # (B, T)
        return torch.einsum("bt,bth->bh", weights, frames)


class SelfAttention(nn.Module):
    """Multi-head self-attention through the flash kernels, the
    counterpart of the JAX package's ``_FlashSelfAttention``.

    ``query`` / ``key`` / ``value`` are the JAX DenseGeneral (D -> H, Dh)
    projections as Linear (D -> H*Dh), ``out`` the DenseGeneral (H, Dh) ->
    D as Linear (H*Dh -> D); ``utils/weights.py`` maps the JAX tensors.
    """

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor],
                rate: float, seed: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, dim = x.shape

        def heads(proj):  # (B, T, H*Dh) -> (B, H, T, Dh)
            return dense(proj, x).view(b, t, self.num_heads, -1).transpose(1, 2)

        o = flash_attention(heads(self.query), heads(self.key), heads(self.value),
                            bias, dropout_rate=rate, dropout_seed=seed)
        return dense(self.out, o.transpose(1, 2).reshape(b, t, dim))


class TransformerBlock(nn.Module):
    """Post-LN encoder layer (torch ``nn.TransformerEncoderLayer``
    semantics): x = LN(x + MHA(x)); x = LN(x + Linear(drop(GELU(Linear(x))))),
    GELU the exact erf form, LayerNorm eps 1e-5.  In training mode the
    attention probabilities drop out inside the kernel (seeded from the
    forward's ``Noise``) and the feed-forward hidden layer takes a keep
    mask; the residual branches have no dropout, as in the JAX block.  It
    runs in its input's dtype: float32, or bf16 over float32 parameters
    (``dense``, ``layer_norm``, the flash kernels' bf16 forms)."""

    def __init__(self, hidden_dim: int, num_heads: int = 4, dropout: float = 0.1):
        super().__init__()
        self.dropout = float(dropout)
        self.self_attn = SelfAttention(hidden_dim, num_heads)
        self.ln1 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.ffn_in = nn.Linear(hidden_dim, 4 * hidden_dim)
        self.ffn_out = nn.Linear(4 * hidden_dim, hidden_dim)
        self.ln2 = nn.LayerNorm(hidden_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None) -> torch.Tensor:
        p = self.dropout if self.training else 0.0
        seed = None
        if p > 0.0:
            if noise is None:
                raise ValueError("a training forward with dropout needs a Noise source")
            seed = noise.seed(x.device)
        x = layer_norm(self.ln1, x + self.self_attn(x, bias, p, seed))
        h = dropout(F.gelu(dense(self.ffn_in, x), approximate="none"), p, noise)
        return layer_norm(self.ln2, x + dense(self.ffn_out, h))


class SequenceEncoder(nn.Module):
    """Time series (B, T, D) -> L-layer LSTM or GRU final hidden, L
    post-LN transformer blocks mean-pooled over time, or two convolutions
    with BatchNorm mean-pooled over time (``encoder_type``) -> Linear.  The
    CNN's convolutions pad as flax's ``"SAME"`` does ((2, 2) for k5, (1, 1)
    for k3) and run in cuDNN, as the JAX package's run in XLA's conv.  The JAX package's fused recurrent module and its layerwise
    ``StackedRNN`` (``fused: false``, depth 1, and every T past 2,048
    steps, e.g. the raw waveform's 48,000, in remat'd chunks of 512) compute
    the same function on the same parameter tree, so every T runs the same
    kernels here, over the whole sequence at once; a training forward whose
    residuals the card cannot hold is refused
    (``ops.lstm_vjp.check_residual_budget``)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, dropout: float = 0.1,
                 encoder_type: str = "lstm", max_len: int = 4096,
                 attention_block: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder_type = encoder_type
        self.compute_dtype = dtype
        if encoder_type == "transformer":
            self.max_len = max_len
            self.attention_block = attention_block
            self.num_layers = num_layers
            self.input_proj = nn.Linear(input_dim, hidden_dim)
            self.pos_embedding = nn.Embedding(max_len, hidden_dim)
            for i in range(num_layers):
                self.add_module(f"block_{i}", TransformerBlock(hidden_dim, 4, dropout))
        elif encoder_type == "cnn":
            self.dropout = float(dropout)
            self.conv1 = nn.Conv1d(input_dim, hidden_dim, 5, padding=2)
            self.bn1 = BatchNorm(hidden_dim)
            self.conv2 = nn.Conv1d(hidden_dim, hidden_dim, 3, padding=1)
            self.bn2 = BatchNorm(hidden_dim)
        else:
            # the JAX package drops out between layers only
            self.rnn = FusedStackedRNN(input_dim, hidden_dim, num_layers,
                                       dropout=dropout if num_layers > 1 else 0.0,
                                       cell_type=encoder_type, dtype=dtype)
        self.projection = nn.Linear(hidden_dim, output_dim)

    def _transformer(self, x: torch.Tensor, noise: Optional[Noise],
                     lengths: Optional[torch.Tensor]) -> torch.Tensor:
        batch, seq_len, _ = x.shape
        valid = None
        if lengths is not None:
            # (B, T) True where a step lies within its row's length
            valid = (torch.arange(seq_len, device=x.device)[None]
                     < lengths.to(x.device)[:, None])
        # O(T^2) attention is impossible at raw-waveform lengths: past
        # max_len, attend in local blocks folded into the batch, then pool
        # over the whole sequence
        blockwise = seq_len > self.max_len
        t = seq_len
        if blockwise:
            block = self.attention_block
            t = seq_len + (-seq_len) % block
            x = F.pad(x, (0, 0, 0, t - seq_len))
            if valid is None:
                valid = torch.ones((batch, seq_len), dtype=torch.bool, device=x.device)
            valid = F.pad(valid, (0, t - seq_len))
        positions = torch.arange(t, device=x.device).clamp(max=self.max_len - 1)
        # the position table in x's dtype before the lookup, as flax's Embed
        pos = self.pos_embedding.weight.to(x.dtype)[positions]
        h = dense(self.input_proj, x) + pos[None]
        block_valid = valid
        if blockwise:
            h = h.reshape(batch * (t // block), block, -1)
            block_valid = valid.reshape(-1, block).clone()
            # a fully padded block would softmax over nothing: keep one
            # sentinel key valid (its outputs are masked out in pooling)
            block_valid[:, 0] |= ~block_valid.any(dim=1)
        # the key mask as the flash kernels' additive key bias
        bias = (None if block_valid is None
                else torch.where(block_valid, 0.0, MASKED).to(torch.float32))
        for i in range(self.num_layers):
            h = getattr(self, f"block_{i}")(h, bias, noise)
        if blockwise:
            h = h.reshape(batch, t, -1)
        return masked_mean(h, valid, dim=1)

    def _cnn(self, x: torch.Tensor, noise: Optional[Noise],
             bn_eval: Optional[bool]) -> torch.Tensor:
        p = self.dropout if self.training else 0.0
        running = use_running_average(self.training, bn_eval)
        # the convolutions take (B, C, T); BatchNorm and the dropout masks
        # see (B, T, C), the JAX layout
        h = conv(self.conv1, x.transpose(1, 2)).transpose(1, 2)
        h = dropout(torch.relu(self.bn1(h, running)), p, noise)
        h = conv(self.conv2, h.transpose(1, 2)).transpose(1, 2)
        h = masked_mean(torch.relu(self.bn2(h, running)), None, dim=1)
        return dropout(h, p, noise)

    def forward(self, sequence: torch.Tensor, noise: Optional[Noise] = None,
                bn_eval: Optional[bool] = None,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``lengths`` (B,): each row's valid steps.  The transformer masks
        the keys past them and pools over the valid steps; the CNN ignores
        them, as the JAX encoder does."""
        if lengths is not None and self.encoder_type in ("lstm", "gru"):
            raise NotImplementedError(
                "sequence lengths into the LSTM / GRU encoders (the final hidden "
                "state at each row's last valid step) are not ported yet "
                "(ROADMAP.md Queue 1 items 3 / 6)")
        if self.encoder_type == "cnn":
            # in the compute dtype, as the JAX encoders cast to theirs (the
            # weights' dtype where that is float32: a float64 copy's)
            x = sequence.to(self.compute_dtype if self.compute_dtype == torch.bfloat16
                            else self.conv1.weight.dtype)
            return dense(self.projection, self._cnn(x, noise, bn_eval))
        x = sequence.to(self.compute_dtype)
        if self.encoder_type == "transformer":
            return dense(self.projection, self._transformer(x, noise, lengths))
        return dense(self.projection, self.rnn(x, noise))


class FrameEncoder(nn.Module):
    """Per-frame MLP + dropout + temporal pooling + dropout + LayerNorm +
    projection."""

    def __init__(self, frame_dim: int, hidden_dim: int, output_dim: int,
                 temporal_pooling: str = "attention", dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if temporal_pooling not in ("attention", "average", "max"):
            raise ValueError(f"Unknown pooling: {temporal_pooling}")
        self.temporal_pooling = temporal_pooling
        self.compute_dtype = dtype
        self.dropout = float(dropout)
        self.frame_mlp = nn.Linear(frame_dim, hidden_dim)
        if temporal_pooling == "attention":
            self.pool = AttentionPool(hidden_dim)
        self.proj_ln = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.projection = nn.Linear(hidden_dim, output_dim)

    def forward(self, frames: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None,
                bn_eval: Optional[bool] = None) -> torch.Tensor:
        del bn_eval  # no BatchNorm here; the encoders share one interface
        p = self.dropout if self.training else 0.0
        x = dense(self.frame_mlp, frames.to(self.compute_dtype))
        x = dropout(torch.relu(x), p, noise)
        if self.temporal_pooling == "attention":
            pooled = self.pool(x, mask)
        elif self.temporal_pooling == "average":
            pooled = masked_mean(x, mask, dim=1)
        else:
            pooled = masked_max(x, mask, dim=1)
        return dense(self.projection, layer_norm(self.proj_ln, dropout(pooled, p, noise)))


class SimpleMLPEncoder(nn.Module):
    """[Linear -> BatchNorm -> ReLU -> Dropout] x ``num_layers`` -> Linear
    ``out``; a (B, T, D) input is encoded per step, then mean-pooled over
    time.  BatchNorm reduces over every axis but the features."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, dropout: float = 0.1,
                 batch_norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.num_layers = num_layers
        self.batch_norm = batch_norm
        self.dropout = float(dropout)
        for i in range(num_layers):
            self.add_module(f"dense_{i}",
                            nn.Linear(input_dim if i == 0 else hidden_dim, hidden_dim))
            if batch_norm:
                self.add_module(f"bn_{i}", BatchNorm(hidden_dim))
        self.out = nn.Linear(hidden_dim if num_layers else input_dim, output_dim)

    def forward(self, features: torch.Tensor, noise: Optional[Noise] = None,
                bn_eval: Optional[bool] = None) -> torch.Tensor:
        p = self.dropout if self.training else 0.0
        running = use_running_average(self.training, bn_eval)
        # the weights' dtype where the compute dtype is float32 (a float64
        # copy's)
        x = features.to(self.compute_dtype if self.compute_dtype == torch.bfloat16
                        else self.out.weight.dtype)
        for i in range(self.num_layers):
            x = dense(getattr(self, f"dense_{i}"), x)
            if self.batch_norm:
                x = getattr(self, f"bn_{i}")(x, running)
            x = dropout(torch.relu(x), p, noise)
        x = dense(self.out, x)
        return masked_mean(x, None, dim=1) if features.ndim == 3 else x


class ImageCNNEncoder(nn.Module):
    """ResNet backbone over (B, H, W, C) images -> dropout -> LayerNorm ->
    projection, or over (B, T, H, W, C) frames folded to (B*T, H, W, C)
    -> temporal pooling (attention / average / max, under ``mask``) ->
    dropout -> LayerNorm -> projection.  The backbone's stem takes
    ``in_channels`` channels (the config's ``in_channels``, 3 by default:
    RGB, torchvision's layout, which ``weights_path`` grafts; 1 for gray
    frames), where flax takes the count from the first input.  An
    attention pool's parameters exist whatever the rank; the JAX tree has
    them only where the encoder was built on frames."""

    def __init__(self, backbone: str = "resnet18", output_dim: int = 128,
                 temporal_pooling: str = "average", dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__()
        self.temporal_pooling = temporal_pooling
        self.compute_dtype = dtype
        self.dropout = float(dropout)
        self.backbone = ResNet(backbone, in_channels)
        width = feature_dim(backbone)
        if temporal_pooling == "attention":
            self.pool = AttentionPool(width)
        self.proj_ln = nn.LayerNorm(width, eps=1e-5)
        self.projection = nn.Linear(width, output_dim)

    def forward(self, frames: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None,
                bn_eval: Optional[bool] = None) -> torch.Tensor:
        if frames.ndim not in (4, 5):
            raise ValueError(f"Expected rank-4/5 frames, got shape {tuple(frames.shape)}")
        if frames.shape[-1] != self.backbone.stem_conv.in_channels:
            raise ValueError(f"frames of shape {tuple(frames.shape)}: the backbone takes "
                             f"{self.backbone.stem_conv.in_channels} channels last "
                             f"(model.encoders.<modality>.in_channels)")
        p = self.dropout if self.training else 0.0
        running = use_running_average(self.training, bn_eval)
        # the weights' dtype where the compute dtype is float32 (a float64
        # copy's)
        dtype = (self.compute_dtype if self.compute_dtype == torch.bfloat16
                 else self.projection.weight.dtype)
        if frames.ndim == 4:
            pooled = self.backbone(frames.to(dtype), bn_eval=running)
        else:
            b, t = frames.shape[:2]
            flat = frames.reshape((b * t,) + tuple(frames.shape[2:])).to(dtype)
            feats = self.backbone(flat, bn_eval=running).reshape(b, t, -1)
            if self.temporal_pooling == "attention":
                pooled = self.pool(feats, mask)
            elif self.temporal_pooling == "average":
                pooled = masked_mean(feats, mask, dim=1)
            elif self.temporal_pooling == "max":
                pooled = masked_max(feats, mask, dim=1)
            else:
                raise ValueError(f"Unknown pooling: {self.temporal_pooling}")
        pooled = dropout(pooled, p, noise)
        return dense(self.projection, layer_norm(self.proj_ln, pooled))


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
    dtype: torch.dtype = torch.float32,
) -> nn.Module:
    """Route a per-modality config dict to an encoder module.

    Same keys, defaults and heuristics as the JAX factory ('video'/'frames'
    -> frame, audio/imu/... -> sequence, else mlp; hidden_dim defaults to
    2*output_dim, max(output_dim, 64) for mlp; dropout defaults to 0.1).
    Keys a branch does not read are ignored, as there (``type: mlp`` over
    a dict that still names an ``encoder_type``).  Route keys of the TPU
    build (``scan_unroll``, ``fused``, ``inference_kernel``, ``use_flash``)
    are accepted and do not route: the device does.  ``dtype`` is the
    model's compute dtype; the config's ``dtype`` key overrides it.
    ``pretrained_cnn`` reads ``in_channels``, the frames' channel count,
    which flax takes from the first input (the JAX factory ignores it).
    """
    cfg = dict(encoder_config or {})
    enc_type = cfg.pop("type", None)
    in_dim = cfg.pop("input_dim", input_dim)
    dt_over = cfg.pop("dtype", None)
    if dt_over is not None:
        if dt_over not in ENCODER_DTYPES:
            raise ValueError(f"model.encoders.{modality}.dtype={dt_over!r}: neither "
                             f"of {sorted(ENCODER_DTYPES)}")
        dtype = ENCODER_DTYPES[dt_over]

    if enc_type is None:
        mod = modality.lower()
        if mod in {"video", "frames"}:
            enc_type = "frame"
        elif mod in _SEQUENCE_MODALITIES:
            enc_type = "sequence"
        else:
            enc_type = "mlp"

    hidden = cfg.pop("hidden_dim", None)
    if hidden is None:
        hidden = max(output_dim, 64) if enc_type == "mlp" else output_dim * 2
    rate = cfg.pop("dropout", 0.1)
    kind = cfg.pop("encoder_type", "lstm") if enc_type == "sequence" else enc_type
    if enc_type == "frame":
        return FrameEncoder(
            frame_dim=in_dim,
            hidden_dim=hidden,
            output_dim=output_dim,
            temporal_pooling=cfg.pop("temporal_pooling", "attention"),
            dropout=rate,
            dtype=dtype,
        )
    if enc_type == "sequence":
        if kind not in ("lstm", "gru", "transformer", "cnn"):
            raise ValueError(f"Unknown encoder type: {kind}")
        return SequenceEncoder(
            input_dim=in_dim,
            hidden_dim=hidden,
            output_dim=output_dim,
            num_layers=cfg.pop("num_layers", 2),
            dropout=rate,
            encoder_type=kind,
            dtype=dtype,
        )
    if enc_type == "mlp":
        return SimpleMLPEncoder(
            input_dim=in_dim,
            hidden_dim=hidden,
            output_dim=output_dim,
            num_layers=cfg.pop("num_layers", 2),
            dropout=rate,
            batch_norm=cfg.pop("batch_norm", True),
            dtype=dtype,
        )
    if enc_type == "pretrained_cnn":
        # weights_path is read after the weights are made, not here
        # (classifier.load_pretrained_encoder_weights, from the trainer)
        cfg.pop("weights_path", None)
        return ImageCNNEncoder(
            backbone=cfg.pop("backbone", "resnet18"),
            output_dim=output_dim,
            temporal_pooling=cfg.pop("temporal_pooling", "average"),
            dropout=rate,
            dtype=dtype,
            in_channels=cfg.pop("in_channels", 3),
        )
    raise ValueError(f"Unknown encoder type '{enc_type}' for modality '{modality}'")
