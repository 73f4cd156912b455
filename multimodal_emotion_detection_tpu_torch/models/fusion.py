"""Fusion strategies: early, late, hybrid and uncertainty-weighted late.

The JAX package's ``models/fusion.py``: missing modalities are zero-filled
and masked rather than skipped, so one graph covers every availability
pattern, and ``build_fusion_model`` takes the reference's config strings.
Submodules and parameters carry the JAX tree's names (``proj_audio``,
``post_ln``, ``fusion_logits``, ``audio_cls_hidden``, ...), so a JAX fusion's
weights load key for key through ``utils/weights.py``.

Each fusion takes the model's compute dtype (``dtype``): in bf16 the
features, the masks and every Linear, LayerNorm, softmax, dropout and sum
run in bf16 at flax's points (``models/layers.py``), over float32
parameters, and the logits come out in bf16.

Every forward takes ``(modality_features, modality_mask, noise)``; dropout
acts only in training mode, with masks drawn from ``noise``.  No kernel runs
here: stock ops over M modality tokens, as plain XLA in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.models.attention import (
    NEG_LARGE,
    CrossModalAttention,
)
from multimodal_emotion_detection_tpu_torch.models.layers import (
    bf16_scalar,
    dense,
    layer_norm,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise, dropout


def _ordered_stack(modality_features: Dict[str, torch.Tensor], names: List[str],
                   dims: Dict[str, int], dtype: torch.dtype = torch.float32
                   ) -> Tuple[List[torch.Tensor], List[bool]]:
    """Features in ``names`` order in ``dtype``, zeros for a modality
    absent from the dict; and which were present.  The flags stay on the host: a tensor
    made from them would be copied to the device, and that copy waits for
    every kernel queued before it."""
    first = next(iter(modality_features.values()))
    b, device = first.shape[0], first.device
    feats, present = [], []
    for name in names:
        x = modality_features.get(name)
        if x is not None:
            feats.append(x.to(dtype))
            present.append(True)
        else:
            feats.append(torch.zeros((b, dims[name]), dtype=dtype, device=device))
            present.append(False)
    return feats, present


class EarlyFusion(nn.Module):
    """Concat -> [Linear -> LayerNorm -> ReLU -> dropout] x 2 -> Linear.

    A mask zeroes the missing modalities' features first, or with
    ``learned_missing`` puts a learned token (``missing_<name>``, zeros at
    init) in their place.
    """

    def __init__(self, modality_dims: Dict[str, int], num_classes: int = 11,
                 hidden_dim: int = 256, dropout: float = 0.1, num_heads: int = 4,
                 learned_missing: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        del num_heads  # accepted as the factory passes it; unused
        self.compute_dtype = dtype
        self.modality_dims = dict(modality_dims)
        self.dropout = float(dropout)
        self.learned_missing = learned_missing
        if learned_missing:
            for name, dim in self.modality_dims.items():
                self.register_parameter(f"missing_{name}", nn.Parameter(torch.zeros(dim)))
        width = sum(self.modality_dims.values())
        for i in range(2):
            self.add_module(f"dense_{i}", nn.Linear(width if i == 0 else hidden_dim,
                                                    hidden_dim))
            self.add_module(f"ln_{i}", nn.LayerNorm(hidden_dim, eps=1e-5))
        self.head = nn.Linear(hidden_dim, num_classes)

    def forward(self, modality_features: Dict[str, torch.Tensor],
                modality_mask: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None) -> torch.Tensor:
        names = list(self.modality_dims)
        dt = self.compute_dtype
        feats, _ = _ordered_stack(modality_features, names, self.modality_dims, dt)
        if modality_mask is not None:
            mask = modality_mask.to(dt)
            for i, name in enumerate(names):
                m = mask[:, i:i + 1]
                if self.learned_missing:
                    token = getattr(self, f"missing_{name}").to(dt)
                    feats[i] = m * feats[i] + (1.0 - m) * token[None, :]
                else:
                    feats[i] = m * feats[i]
        h = torch.cat(feats, dim=-1)
        p = self.dropout if self.training else 0.0
        for i in range(2):
            h = layer_norm(getattr(self, f"ln_{i}"), dense(getattr(self, f"dense_{i}"), h))
            h = dropout(torch.relu(h), p, noise)
        return dense(self.head, h)


class LateFusion(nn.Module):
    """A classifier per modality (``<name>_dense`` -> ReLU -> dropout ->
    ``<name>_head``), fused by the learned weights softmax(``fusion_logits``)
    renormalised over the available modalities.  Returns ``(fused logits,
    {name: per-modality logits})``; a modality absent from the dict
    contributes zero logits."""

    def __init__(self, modality_dims: Dict[str, int], num_classes: int = 11,
                 hidden_dim: int = 256, dropout: float = 0.1, num_heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        del num_heads  # accepted as the factory passes it; unused
        self.compute_dtype = dtype
        self.modality_dims = dict(modality_dims)
        self.dropout = float(dropout)
        for name, dim in self.modality_dims.items():
            self.add_module(f"{name}_dense", nn.Linear(dim, hidden_dim))
            self.add_module(f"{name}_head", nn.Linear(hidden_dim, num_classes))
        self.fusion_logits = nn.Parameter(torch.zeros(len(self.modality_dims)))

    def forward(self, modality_features: Dict[str, torch.Tensor],
                modality_mask: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        names = list(self.modality_dims)
        dt = self.compute_dtype
        feats, present = _ordered_stack(modality_features, names, self.modality_dims, dt)
        p = self.dropout if self.training else 0.0
        per_modality: Dict[str, torch.Tensor] = {}
        for i, name in enumerate(names):
            h = dropout(torch.relu(dense(getattr(self, f"{name}_dense"), feats[i])), p,
                        noise)
            logit = dense(getattr(self, f"{name}_head"), h) * float(present[i])
            per_modality[name] = logit
        stacked = torch.stack(list(per_modality.values()), dim=1)  # (B, M, C)
        base_w = torch.softmax(self.fusion_logits.to(dt), dim=0)
        if modality_mask is not None:
            w = base_w[None, :] * modality_mask.to(dt)
            w = w / w.sum(dim=1, keepdim=True).clamp(min=_tiny(1e-8, dt))
        else:
            w = base_w[None, :].expand(stacked.shape[0], len(names))
        return (w[..., None] * stacked).sum(dim=1), per_modality


class HybridFusion(nn.Module):
    """Project each modality (``proj_<name>``) -> ``pre_ln`` over the M
    tokens -> each token attends to all of them (``attn_<name>``, invalid
    keys masked) -> residual + the one shared ``post_ln`` -> a content
    gate (``gate_in`` -> ReLU -> dropout -> ``gate_out``, hidden width
    max(32, hidden_dim // 2)) scored over the available modalities ->
    weighted sum -> ``classifier``."""

    def __init__(self, modality_dims: Dict[str, int], num_classes: int = 11,
                 hidden_dim: int = 256, num_heads: int = 4, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.modality_dims = dict(modality_dims)
        self.dropout = float(dropout)
        for name, dim in self.modality_dims.items():
            self.add_module(f"proj_{name}", nn.Linear(dim, hidden_dim))
        self.pre_ln = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.post_ln = nn.LayerNorm(hidden_dim, eps=1e-5)
        for name in self.modality_dims:
            self.add_module(f"attn_{name}", CrossModalAttention(
                hidden_dim, hidden_dim, hidden_dim, num_heads, dropout, dtype))
        gate_hidden = max(32, hidden_dim // 2)
        self.gate_in = nn.Linear(hidden_dim, gate_hidden)
        self.gate_out = nn.Linear(gate_hidden, 1)
        self.classifier = nn.Linear(hidden_dim, num_classes)

    def forward(self, modality_features: Dict[str, torch.Tensor],
                modality_mask: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None, return_attention: bool = False):
        names = list(self.modality_dims)
        dt = self.compute_dtype
        feats, present = _ordered_stack(modality_features, names, self.modality_dims, dt)
        b = feats[0].shape[0]
        mask_f = (torch.ones((b, len(names)), dtype=dt, device=feats[0].device)
                  if modality_mask is None else modality_mask.to(dt))
        if not all(present):  # modalities absent from the dict are invalid too
            mask_f = torch.stack([mask_f[:, i] * float(p) for i, p in enumerate(present)],
                                 dim=1)
        invalid = mask_f <= 0  # (B, M)

        z = torch.stack([dense(getattr(self, f"proj_{name}"), feats[i])
                         for i, name in enumerate(names)], dim=1)  # (B, M, D)
        z = layer_norm(self.pre_ln, z)
        attended, attn_info = [], {}
        for i, name in enumerate(names):
            out, attn_w = getattr(self, f"attn_{name}")(
                z[:, i:i + 1], z, z, mask=invalid, noise=noise)
            attended.append(layer_norm(self.post_ln, out[:, 0] + z[:, i]))
            attn_info[name] = attn_w
        h_att = torch.stack(attended, dim=1)  # (B, M, D)

        p = self.dropout if self.training else 0.0
        g = dropout(torch.relu(dense(self.gate_in, h_att)), p, noise)
        scores = dense(self.gate_out, g)[..., 0].masked_fill(invalid, NEG_LARGE)
        weights = torch.softmax(scores, dim=-1)
        weights = torch.where(torch.isfinite(weights), weights, torch.zeros_like(weights))
        weights = weights / weights.sum(dim=-1, keepdim=True).clamp(min=_tiny(1e-8, dt))
        logits = dense(self.classifier, (weights[..., None] * h_att).sum(dim=1))
        if return_attention:
            return logits, {"fusion_weights": weights,
                            "per_modality_attention": attn_info, "H_att": h_att}
        return logits


def _tiny(value: float, dtype: torch.dtype) -> float:
    """A small constant of a computation in ``dtype``: rounded to bf16
    there, as JAX rounds a weakly typed constant to the array's dtype."""
    return bf16_scalar(value) if dtype == torch.bfloat16 else value


def compute_adaptive_weights(modality_features: Dict[str, torch.Tensor],
                             modality_mask: torch.Tensor,
                             modality_names: List[str]) -> torch.Tensor:
    """Availability-masked softmax of each modality's feature norm over
    sqrt(width), (B, M); a row with nothing available gets zeros."""
    scores = torch.stack([
        torch.linalg.vector_norm(modality_features[n], dim=-1)
        / modality_features[n].shape[-1] ** 0.5 for n in modality_names], dim=1)
    weights = torch.softmax(
        scores.masked_fill(~(modality_mask > 0), float("-inf")), dim=-1)
    return torch.where(torch.isfinite(weights), weights, torch.zeros_like(weights))


def uncertainty_weighted_fusion(logits: torch.Tensor, uncertainties: torch.Tensor,
                                modality_mask: torch.Tensor, epsilon: float = 1e-6
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weights proportional to 1 / (u + eps) over the available modalities
    (logits (B, M, C), uncertainties (B, M) positive, mask (B, M)); returns
    ``(fused logits (B, C), weights (B, M))``."""
    eps = _tiny(epsilon, logits.dtype)
    inv_w = 1.0 / (uncertainties + eps) * modality_mask.to(logits.dtype)
    weights = inv_w / (inv_w.sum(dim=1, keepdim=True) + eps)
    return (weights[..., None] * logits).sum(dim=1), weights


class LateFusionWithUncertainty(nn.Module):
    """A classifier head (``<name>_cls_*``) and a softplus scalar
    uncertainty head (``<name>_unc_*``) per modality, fused by inverse
    uncertainty.  Each head is dropout -> [``_hidden`` -> ReLU -> dropout,
    where ``hidden_dim`` > 0] -> ``_out``, the two heads drawing their own
    masks.  The mask (B, M) is required.  Returns ``(fused logits,
    {"per_modality_logits", "fusion_weights", "uncertainties"})``."""

    def __init__(self, modality_dims: Dict[str, int], num_classes: int,
                 hidden_dim: int = 0, num_heads: int = 0, dropout: float = 0.0,
                 epsilon: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        del num_heads  # accepted as the factory passes it; unused
        self.compute_dtype = dtype
        self.modality_dims = dict(modality_dims)
        self.hidden_dim = hidden_dim
        self.dropout = float(dropout)
        self.epsilon = epsilon
        for name, dim in self.modality_dims.items():
            for prefix, out in ((f"{name}_cls", num_classes), (f"{name}_unc", 1)):
                if hidden_dim > 0:
                    self.add_module(f"{prefix}_hidden", nn.Linear(dim, hidden_dim))
                self.add_module(f"{prefix}_out",
                                nn.Linear(hidden_dim if hidden_dim > 0 else dim, out))

    def _head(self, x: torch.Tensor, prefix: str, p: float,
              noise: Optional[Noise]) -> torch.Tensor:
        h = dropout(x, p, noise)
        if self.hidden_dim > 0:
            h = dropout(torch.relu(dense(getattr(self, f"{prefix}_hidden"), h)), p, noise)
        return dense(getattr(self, f"{prefix}_out"), h)

    def forward(self, encoded_features: Dict[str, torch.Tensor],
                modality_mask: Optional[torch.Tensor],
                noise: Optional[Noise] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        if modality_mask is None:
            raise ValueError("LateFusionWithUncertainty needs a modality_mask (B, M)")
        names = list(self.modality_dims)
        feats, _ = _ordered_stack(encoded_features, names, self.modality_dims,
                                  self.compute_dtype)
        p = self.dropout if self.training else 0.0
        logits, uncert = [], []
        for i, name in enumerate(names):
            logits.append(self._head(feats[i], f"{name}_cls", p, noise))
            uncert.append(nn.functional.softplus(
                self._head(feats[i], f"{name}_unc", p, noise))[..., 0])
        stacked = torch.stack(logits, dim=1)  # (B, M, C)
        uncert = torch.stack(uncert, dim=1)  # (B, M)
        fused, weights = uncertainty_weighted_fusion(stacked, uncert, modality_mask,
                                                     self.epsilon)
        return fused, {"per_modality_logits": stacked, "fusion_weights": weights,
                       "uncertainties": uncert}


_UNCERTAINTY_ALIASES = {
    "uncertainty", "uwf", "uncertainty_weighted", "uncertainty_weighted_late",
}


def build_fusion_model(fusion_type: str, modality_dims: Dict[str, int],
                       num_classes: int, **kwargs) -> nn.Module:
    """The fusion named by the reference's config strings: 'early', 'late',
    'hybrid', or an uncertainty alias."""
    if fusion_type in _UNCERTAINTY_ALIASES:
        return LateFusionWithUncertainty(
            modality_dims=modality_dims,
            num_classes=num_classes,
            hidden_dim=kwargs.get("hidden_dim", 0),
            num_heads=kwargs.get("num_heads", 0),
            dropout=kwargs.get("dropout", 0.0),
            epsilon=kwargs.get("epsilon", 1e-6),
            dtype=kwargs.get("dtype", torch.float32),
        )
    fusion_classes = {"early": EarlyFusion, "late": LateFusion, "hybrid": HybridFusion}
    if fusion_type not in fusion_classes:
        raise ValueError(f"Unknown fusion type: {fusion_type}")
    return fusion_classes[fusion_type](modality_dims=modality_dims,
                                       num_classes=num_classes, **kwargs)
