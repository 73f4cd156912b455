"""Attention over modality tokens and time steps, for the fusion library.

The JAX package's ``models/attention.py``, with its mask conventions and
return values: every cross-modal direction always computes, and per-sample
key masks zero out the messages of missing modalities, so one graph covers
every availability pattern.  Module and parameter names follow the JAX
tree (``q_in_ln``, ``q_proj``, ``{a}_to_{b}``, ...), so a JAX fusion's
weights load key for key through ``utils/weights.py``.

``CrossModalAttention`` takes the model's compute dtype (the hybrid
fusion's): in bf16 its LayerNorms, projections, score products, softmax
and dropout run in bf16 at flax's points (``models/encoders.py``'s
``layer_norm`` and ``dense``; the 1/sqrt(head width) scale rounded to bf16
first, as a weakly typed constant is).

Dropout acts only in training mode, with masks drawn from the forward's
``Noise``.  No kernel runs here: M is the number of modalities (2 in every
shipped config), so the products and softmaxes are small stock ops, as they
are plain XLA in the JAX package.  ``visualize_attention`` draws the
modality x modality heatmap that ``tools/visualize.py`` writes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.models.layers import (
    bf16_scalar,
    dense,
    layer_norm,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise, dropout

NEG_LARGE = -1e4  # an fp16/bf16-safe "minus infinity"


def normalize_key_mask(mask: torch.Tensor, batch: int, t_k: int) -> torch.Tensor:
    """A key mask as boolean INVALID of shape (B, Tk).

    Accepts (B,), (B, 1) or (B, Tk); a boolean mask means True = invalid, a
    numeric one 1 = valid (so it is inverted).
    """
    invalid = mask if mask.dtype == torch.bool else mask <= 0
    if invalid.ndim == 1:
        return invalid[:, None].expand(batch, t_k)
    if invalid.ndim == 2:
        if invalid.shape[1] == 1:
            return invalid.expand(batch, t_k)
        if invalid.shape[1] != t_k:
            raise ValueError(f"Mask width {invalid.shape[1]} != Tk {t_k}")
        return invalid
    raise ValueError(f"Mask must be [B] or [B,Tk], got {tuple(invalid.shape)}")


class CrossModalAttention(nn.Module):
    """Multi-head cross-modal attention with separate query and key widths.

    Inputs may be (B, D) or (B, T, D); returns ``(out, attn)``, out (B, D)
    where the query was 2-D and Tq == 1, else (B, Tq, D), and attn (B, H,
    Tq, Tk).  Input LayerNorms (eps 1e-5) even out the modalities' scales;
    masked keys score ``NEG_LARGE``, and a row with every key masked gets
    zero attention, not NaN.  The attention probabilities drop out.
    """

    def __init__(self, query_dim: int, key_dim: int, hidden_dim: int,
                 num_heads: int = 4, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.dropout = float(dropout)
        self.q_in_ln = nn.LayerNorm(query_dim, eps=1e-5)
        self.k_in_ln = nn.LayerNorm(key_dim, eps=1e-5)
        self.v_in_ln = nn.LayerNorm(key_dim, eps=1e-5)
        self.q_proj = nn.Linear(query_dim, hidden_dim)
        self.k_proj = nn.Linear(key_dim, hidden_dim)
        self.v_proj = nn.Linear(key_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        heads, head_dim = self.num_heads, self.hidden_dim // self.num_heads
        squeeze_out = query.ndim == 2
        query = query[:, None] if query.ndim == 2 else query
        key = key[:, None] if key.ndim == 2 else key
        value = value[:, None] if value.ndim == 2 else value
        b, t_q, _ = query.shape
        t_k = key.shape[1]

        dt = self.compute_dtype
        q = dense(self.q_proj, layer_norm(self.q_in_ln, query.to(dt)))
        k = dense(self.k_proj, layer_norm(self.k_in_ln, key.to(dt)))
        v = dense(self.v_proj, layer_norm(self.v_in_ln, value.to(dt)))
        q = q.reshape(b, t_q, heads, head_dim).transpose(1, 2)
        k = k.reshape(b, t_k, heads, head_dim).transpose(1, 2)
        v = v.reshape(b, t_k, heads, head_dim).transpose(1, 2)

        scores = torch.einsum("bhqd,bhkd->bhqk", q, k)
        if dt == torch.bfloat16:
            scores = scores * bf16_scalar(1.0 / math.sqrt(head_dim))
        else:
            scores = scores / math.sqrt(head_dim)
        invalid = None
        if mask is not None:
            invalid = normalize_key_mask(mask, b, t_k)
            scores = scores.masked_fill(invalid[:, None, None, :], NEG_LARGE)
        attn = torch.softmax(scores, dim=-1)
        if invalid is not None:
            all_masked = invalid.all(dim=-1)
            attn = attn.masked_fill(all_masked[:, None, None, None], 0.0)

        p = self.dropout if self.training else 0.0
        attn = dropout(attn, p, noise)
        context = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        out = dense(self.out_proj, context.transpose(1, 2).reshape(b, t_q, self.hidden_dim))
        if squeeze_out and t_q == 1:
            out = out[:, 0]
        return out, attn


class TemporalAttention(nn.Module):
    """Self-attention over time steps, plus attention-based pooling.

    ``mask`` (B, S) marks VALID steps with True / 1, the opposite of
    ``CrossModalAttention``'s key mask; masked keys score -inf.  Returns
    ``(attended (B, S, hidden), weights (B, H, S, S))``.
    """

    def __init__(self, feature_dim: int, hidden_dim: int = 256,
                 num_heads: int = 4, dropout: float = 0.1):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.dropout = float(dropout)
        self.q_proj = nn.Linear(feature_dim, hidden_dim)
        self.k_proj = nn.Linear(feature_dim, hidden_dim)
        self.v_proj = nn.Linear(feature_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, sequence: torch.Tensor, mask: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = sequence.shape
        h, hd = self.num_heads, self.hidden_dim // self.num_heads
        x = sequence.to(torch.float32)

        def to_heads(t):
            return t.reshape(b, s, h, hd).transpose(1, 2)

        q, k, v = to_heads(self.q_proj(x)), to_heads(self.k_proj(x)), to_heads(self.v_proj(x))
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * hd ** -0.5
        if mask is not None:
            valid = mask.to(torch.bool)
            logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
        weights = torch.softmax(logits, dim=-1)
        p = self.dropout if self.training else 0.0
        weights = dropout(weights, p, noise)
        context = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        if mask is not None:
            context = context * mask.to(context.dtype)[:, None, :, None]
        context = context.transpose(1, 2).reshape(b, s, self.hidden_dim)
        return self.out_proj(context), weights

    @staticmethod
    def pool_sequence(sequence: torch.Tensor,
                      attention_weights: torch.Tensor) -> torch.Tensor:
        """Key-importance pooling: attention averaged over heads and
        queries gives weights over keys, which sum the sequence."""
        importance = attention_weights.mean(dim=1).mean(dim=1)  # (B, S)
        importance = importance / (importance.sum(dim=1, keepdim=True) + 1e-9)
        return torch.einsum("bs,bsd->bd", importance, sequence)


class PairwiseModalityAttention(nn.Module):
    """All-directional cross-modal message passing.

    For M modalities, M*(M-1) directional ``CrossModalAttention`` s named
    ``{a}_to_{b}``; each modality sums its incoming messages, adds its own
    projection (``self_proj_{name}``), takes ``out_ln`` and is zeroed where
    it is missing.  Returns ``(attended {name: (B, hidden)}, attention maps
    {"{a}_to_{b}": (B, H, 1, 1)})``.
    """

    def __init__(self, modality_dims: Dict[str, int], hidden_dim: int = 256,
                 num_heads: int = 4, dropout: float = 0.1):
        super().__init__()
        self.modality_dims = dict(modality_dims)
        self.hidden_dim = hidden_dim
        self.dropout = float(dropout)
        names = list(self.modality_dims)
        for i, a in enumerate(names):
            for bb in names[i + 1:]:
                for src, dst in ((a, bb), (bb, a)):
                    self.add_module(f"{src}_to_{dst}", CrossModalAttention(
                        self.modality_dims[src], self.modality_dims[dst],
                        hidden_dim, num_heads, dropout))
        self.out_ln = nn.LayerNorm(hidden_dim, eps=1e-5)
        for name in names:
            self.add_module(f"self_proj_{name}",
                            nn.Linear(self.modality_dims[name], hidden_dim))

    def forward(self, modality_features: Dict[str, torch.Tensor],
                modality_mask: Optional[torch.Tensor] = None,
                noise: Optional[Noise] = None):
        names = list(self.modality_dims)
        first = next(iter(modality_features.values()))
        b, device = first.shape[0], first.device
        if modality_mask is not None:
            avail = {name: (modality_mask[:, i] if modality_mask.dtype == torch.bool
                            else modality_mask[:, i] > 0)
                     for i, name in enumerate(names)}
        else:
            avail = {name: torch.ones(b, dtype=torch.bool, device=device)
                     for name in names}

        messages: Dict[str, list] = {name: [] for name in names}
        attention_maps: Dict[str, torch.Tensor] = {}
        for i, a in enumerate(names):
            for bb in names[i + 1:]:
                # src attends to dst's features; keys invalid where dst is missing
                for src, dst in ((a, bb), (bb, a)):
                    x_src, x_dst = modality_features[src], modality_features[dst]
                    out, att = getattr(self, f"{src}_to_{dst}")(
                        x_src, x_dst, x_dst, mask=~avail[dst], noise=noise)
                    messages[src].append(out)
                    attention_maps[f"{src}_to_{dst}"] = att

        p = self.dropout if self.training else 0.0
        attended: Dict[str, torch.Tensor] = {}
        for name in names:
            msg_sum = (sum(messages[name]) if messages[name]
                       else torch.zeros((b, self.hidden_dim), device=device))
            msg_sum = dropout(msg_sum, p, noise)
            self_feat = getattr(self, f"self_proj_{name}")(
                modality_features[name].to(torch.float32))
            agg = self.out_ln(self_feat + msg_sum)
            attended[name] = agg * avail[name].to(agg.dtype)[:, None]
        return attended, attention_maps


def visualize_attention(attention_weights, modality_names: Sequence[str],
                        save_path: Optional[str] = None) -> None:
    """Modality x modality heatmap of batch/head-averaged attention: every
    leading axis of ``attention_weights`` is averaged away down to 2-D.
    Returns without drawing where matplotlib is not installed."""
    import numpy as np

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return

    attn = np.asarray(attention_weights)
    while attn.ndim > 2:
        attn = attn.mean(axis=0)
    n = len(modality_names)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(attn, cmap="viridis")
    fig.colorbar(im, ax=ax)
    ax.set_xticks(range(n))
    ax.set_yticks(range(min(n, attn.shape[0])))
    ax.set_xticklabels(modality_names, rotation=45, ha="right")
    ax.set_yticklabels(modality_names[: attn.shape[0]])
    ax.set_xlabel("Key modality")
    ax.set_ylabel("Query modality")
    ax.set_title("Cross-modal attention")
    if n <= 8:
        for i in range(attn.shape[0]):
            for j in range(attn.shape[1]):
                ax.text(j, i, f"{attn[i, j]:.2f}", ha="center", va="center",
                        color="white", fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    plt.close(fig)
