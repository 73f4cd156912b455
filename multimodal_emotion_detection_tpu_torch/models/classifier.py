"""The end-to-end multimodal classifier: frontend -> encoders -> fusion.

The forward of the JAX package's ``MultimodalClassifier``: each modality's
features go through its encoder (audio through the log-mel / MFCC frontend
first; with ``video_frontend='resize'`` raw (B, T, H, W[, 3]) video frames
through BGR -> gray, the area resize to ``video_hw`` and /255 to
(B, T, h*w), on the input's device, ``ops/resize.py``), then

* ``train_fusion='concat'`` (the default): the embeddings concatenated in
  config modality order, then Linear -> ReLU -> Linear;
* ``train_fusion='library'``: the fusion ``build_fusion_model`` names by
  ``fusion_type`` (early, late, hybrid or uncertainty-weighted late), given
  the availability mask, or all ones where the mask is ignored.  A fusion
  that returns ``(logits, aux)`` gives its logits; ``return_aux=True``
  returns ``(logits, aux)`` with the embeddings under ``aux["encoded"]``.

``dtype`` is the model's compute dtype (``runtime.compute_dtype``),
handed to every encoder, the fusion and the concat head, as the JAX
package's ``MultimodalClassifier(dtype=...)``: in bf16 they compute in bf16
over float32 parameters and the logits are bf16.  A per-encoder ``dtype``
overrides it inside its encoder; each embedding is cast to the model's
dtype before the fusion or the head (a float32 model's stays in its
parameters' dtype, float64 in a float64 copy).

``use_modality_mask=False`` (the default) ignores the availability mask,
as the reference forward does; ``True`` zeroes a missing modality's
features before its encoder and hands the mask to the fusion.  In training
mode every dropout mask comes from the forward's ``noise``; the concat head
has no dropout.  ``bn_eval`` sets every BatchNorm's mode (see
``models/encoders.py``): None follows the module's mode, True reads the
running statistics in a training-mode forward (MC dropout).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.models.batchnorm import BatchNorm
from multimodal_emotion_detection_tpu_torch.models.encoders import (
    ENCODER_DTYPES,
    build_encoder,
)
from multimodal_emotion_detection_tpu_torch.models.fusion import build_fusion_model
from multimodal_emotion_detection_tpu_torch.models.layers import dense
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.models.recurrent import (
    FusedStackedRNN,
    _CellParams,
)
from multimodal_emotion_detection_tpu_torch.ops.logmel import (
    LogMelParams,
    log_mel_spectrogram,
    mfcc,
)
from multimodal_emotion_detection_tpu_torch.ops.lstm_kernel import residual_dtype
from multimodal_emotion_detection_tpu_torch.ops.resize import area_resize, bgr_to_gray


class MultimodalClassifier(nn.Module):
    def __init__(
        self,
        modalities: Tuple[str, ...],
        encoder_configs: Dict[str, Dict[str, Any]],
        num_classes: int = 8,
        output_dim: int = 128,
        hidden_dim: int = 256,
        num_heads: int = 4,
        dropout: float = 0.3,
        fusion_type: str = "early",
        train_fusion: str = "concat",  # 'concat' | 'library'
        use_modality_mask: bool = False,
        audio_frontend: Optional[LogMelParams] = None,  # None -> raw waveform
        frontend_kind: str = "logmel",  # 'logmel' | 'mfcc'
        frontend_n_mfcc: int = 40,
        video_frontend: str = "none",  # 'none' | 'resize'
        video_hw: Tuple[int, int] = (64, 64),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.modalities = tuple(modalities)
        self.train_fusion = train_fusion
        self.use_modality_mask = use_modality_mask
        self.audio_frontend = audio_frontend
        self.frontend_kind = frontend_kind
        self.frontend_n_mfcc = frontend_n_mfcc
        self.video_frontend = video_frontend
        self.video_hw = tuple(video_hw)
        for modality in self.modalities:
            cfg = dict(encoder_configs.get(modality, {}))
            if modality == "audio" and audio_frontend is not None:
                # the frontend's width overrides the encoder input dim
                cfg["input_dim"] = (
                    frontend_n_mfcc if frontend_kind == "mfcc"
                    else audio_frontend.n_mels
                )
            # registered under the JAX tree's names: <modality>_encoder
            self.add_module(
                f"{modality}_encoder",
                build_encoder(
                    modality=modality,
                    input_dim=cfg.get("input_dim", 64),
                    output_dim=output_dim,
                    encoder_config=cfg,
                    dtype=dtype,
                ),
            )
        if train_fusion == "library":
            self.fusion = build_fusion_model(
                fusion_type,
                modality_dims={m: output_dim for m in self.modalities},
                num_classes=num_classes,
                hidden_dim=hidden_dim,
                num_heads=num_heads,
                dropout=dropout,
                dtype=dtype,
            )
        else:
            self.head_in = nn.Linear(output_dim * len(self.modalities), hidden_dim)
            self.head_out = nn.Linear(hidden_dim, num_classes)

    def _apply_frontend(self, modality: str, features: torch.Tensor) -> torch.Tensor:
        if modality == "audio" and self.audio_frontend is not None:
            if self.frontend_kind == "mfcc":
                return mfcc(features, self.audio_frontend,
                            n_mfcc=self.frontend_n_mfcc)
            return log_mel_spectrogram(features, self.audio_frontend)
        if (modality == "video" and self.video_frontend == "resize"
                and features.ndim >= 4):
            # (B, T, H, W[, 3]) raw frames (any dtype) -> gray -> area
            # resize -> [0, 1] -> (B, T, h*w), float32
            x = features
            if x.ndim == 5 and x.shape[-1] == 3:
                x = bgr_to_gray(x)
            h, w = self.video_hw
            x = area_resize(x, h, w) / 255.0
            return x.reshape(x.shape[0], x.shape[1], h * w)
        return features

    def encode(
        self,
        features: Dict[str, torch.Tensor],
        mask: Optional[torch.Tensor] = None,
        noise: Optional[Noise] = None,
        bn_eval: Optional[bool] = None,
    ) -> Dict[str, torch.Tensor]:
        """Per-modality embeddings (B, output_dim)."""
        encoded = {}
        for i, modality in enumerate(self.modalities):
            if modality not in features:
                continue
            x = self._apply_frontend(modality, features[modality])
            if self.use_modality_mask and mask is not None:
                m = mask[:, i].reshape((-1,) + (1,) * (x.ndim - 1))
                x = x * m.to(x.dtype)
            out = getattr(self, f"{modality}_encoder")(x, noise=noise, bn_eval=bn_eval)
            # a per-encoder dtype stays inside the encoder: its output
            # rejoins the model's dtype here, as in the JAX package
            if self.compute_dtype == torch.bfloat16:
                encoded[modality] = out.to(torch.bfloat16)
            else:
                encoded[modality] = out.float() if out.dtype == torch.bfloat16 else out
        return encoded

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        mask: Optional[torch.Tensor] = None,
        noise: Optional[Noise] = None,
        return_aux: bool = False,
        bn_eval: Optional[bool] = None,
    ):
        encoded = self.encode(features, mask, noise, bn_eval=bn_eval)
        aux: Dict[str, Any] = {}
        if self.train_fusion == "library":
            if self.use_modality_mask and mask is not None:
                fusion_mask = mask
            else:
                # the mask-ignoring mode: every modality is available (the
                # uncertainty fusion needs a mask, so all ones, not None)
                lead = next(iter(encoded.values()))
                fusion_mask = torch.ones((lead.shape[0], len(self.modalities)),
                                         dtype=torch.float32, device=lead.device)
            output = self.fusion(encoded, fusion_mask, noise=noise)
            if isinstance(output, tuple):
                logits, fusion_aux = output
                aux = (fusion_aux if isinstance(fusion_aux, dict)
                       else {"per_modality_logits": fusion_aux})
            else:
                logits = output
        else:
            ordered = [encoded[m] for m in self.modalities if m in encoded]
            if not ordered:
                raise ValueError("No modalities were encoded")
            fused = torch.cat(ordered, dim=-1)
            logits = dense(self.head_out, torch.relu(dense(self.head_in, fused)))
        if return_aux:
            aux["encoded"] = encoded
            return logits, aux
        return logits


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights with the JAX package's initialisers: LSTM
    tensors U(-1/sqrt(H), 1/sqrt(H)); Linear and Conv1d weights
    lecun-normal over the fan-in (in, in x k for a convolution; truncated
    at 2 sigma), biases zero; LayerNorm and BatchNorm scale 1, bias 0;
    BatchNorm running mean 0, variance 1; Embedding rows normal with
    variance 1/width."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, _CellParams):
                module.reset_parameters(generator)
            elif isinstance(module, nn.Embedding):
                nn.init.normal_(module.weight, 0.0,
                                1.0 / math.sqrt(module.embedding_dim),
                                generator=generator)
            elif isinstance(module, (nn.Linear, nn.Conv1d)):
                fan_in = module.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, BatchNorm):
                module.reset_parameters()
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
    return model


def logmel_params_from_config(fe) -> LogMelParams:
    """FrontendConfig -> LogMelParams."""
    return LogMelParams(
        sample_rate=fe.sample_rate,
        n_fft=fe.n_fft,
        hop_length=fe.hop_length,
        win_length=fe.win_length,
        n_mels=fe.n_mels,
        fmin=fe.fmin,
        fmax=fe.fmax,
        log_epsilon=fe.log_epsilon,
    )


def classifier_from_config(config) -> MultimodalClassifier:
    """Build the model from a ``Config``.  Its parameters mean
    nothing until a checkpoint or ``init_weights`` fills them."""
    model_cfg = config.model
    fe = model_cfg.frontend
    frontend = None
    encoder_configs = {
        name: dict(cfg) for name, cfg in dict(model_cfg.encoders).items()
    }
    if fe.audio in ("logmel", "mfcc"):
        if fe.cache:
            # features were computed once per split: the encoder reads
            # them directly (the same parameter tree, no frontend)
            width = fe.n_mfcc if fe.audio == "mfcc" else fe.n_mels
            encoder_configs.setdefault("audio", {})["input_dim"] = width
        else:
            frontend = logmel_params_from_config(fe)
    model = MultimodalClassifier(
        modalities=tuple(config.dataset.modalities),
        encoder_configs=encoder_configs,
        num_classes=config.dataset.num_classes,
        output_dim=model_cfg.output_dim,
        hidden_dim=model_cfg.hidden_dim,
        num_heads=model_cfg.num_heads,
        dropout=model_cfg.dropout,
        fusion_type=model_cfg.fusion_type,
        train_fusion=model_cfg.train_fusion,
        use_modality_mask=model_cfg.use_modality_mask,
        audio_frontend=frontend,
        frontend_kind=fe.audio if fe.audio != "raw" else "logmel",
        frontend_n_mfcc=fe.n_mfcc,
        video_frontend=fe.video,
        video_hw=(fe.video_height, fe.video_width),
        dtype=ENCODER_DTYPES[config.runtime.compute_dtype],
    )
    try:
        res_dtype = residual_dtype(config.runtime.lstm_residual_dtype)
    except ValueError as exc:
        raise ValueError(f"runtime.lstm_residual_dtype: {exc}") from None
    for module in model.modules():
        if isinstance(module, FusedStackedRNN):
            module.remat_gates = bool(config.runtime.lstm_remat_gates)
            module.residual_dtype = res_dtype
    return model
