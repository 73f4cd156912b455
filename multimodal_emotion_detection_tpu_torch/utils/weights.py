"""Map a JAX parameter tree onto the port's ``state_dict``.

The port's modules carry the JAX tree's names, so each key is the JAX path
joined by dots (``audio_encoder.rnn.layer_0.w_ih``).  Some leaves change
name or layout on the way:

* a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in);
* a multi-head DenseGeneral becomes a Linear over the flattened heads: the
  attention's ``query`` / ``key`` / ``value`` kernel (D, H, Dh) a weight
  (H*Dh, D) and its bias (H, Dh) a bias (H*Dh,), the ``out`` kernel
  (H, Dh, D) a weight (D, H*Dh);
* a Conv ``kernel`` (k, in, out) of a ``conv*`` module becomes a Conv1d
  ``weight`` (out, in, k), and a 2-D Conv ``kernel`` (kh, kw, in, out)
  (HWIO) of a module named ``conv*`` or ``*conv`` (the ResNet's
  ``conv1..3``, ``stem_conv``, ``downsample_conv``) a Conv2d ``weight``
  (out, in, kh, kw) (OIHW);
* a LayerNorm or BatchNorm ``scale`` becomes ``weight``, an Embed
  ``embedding`` ``weight``;
* the ``batch_stats`` collection's BatchNorm ``mean`` and ``var`` become
  the buffers ``running_mean`` and ``running_var``.

A 3-D or 4-D kernel is told apart by its module's name, not its shape:
one of any other module raises.

``jax_params_from_state_dict`` maps the other way, for the parameters
alone (the JAX layout is what ``utils/quantize.py`` quantizes in).  A
flattened multi-head projection does not say how many heads it had, so
it takes them by attention module (``attention_heads(model)``).

Recurrent tensors keep their JAX names and layout: an LSTM layer's
``w_ih`` (D, 4H), ``w_hh`` (H, 4H) and one fused ``b``, gates i, f, g, o; a
GRU layer's ``w_ih`` (D, 3H), ``w_hh`` (H, 3H), ``b_ih`` and ``b_hh``, gates
r, z, n.  So a JAX classifier with any ported encoder maps key for key
(``tests/test_torch_port_gru_config.py`` and
``tests/test_torch_port_transformer_config.py`` load JAX classifiers' trees
with ``strict=True``), and so does one with library fusion: its 1-D
parameters (``LateFusion``'s ``fusion_logits``, ``EarlyFusion``'s
``missing_<m>``) keep name and layout, ``HybridFusion``'s one ``post_ln`` is
one module in both trees (``tests/test_torch_port_fusion.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


_DENSE_GENERAL = ("query", "key", "value", "out")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _is_conv(module: str) -> bool:
    return module.startswith("conv") or module.endswith("conv")


def _kernel(prefix: str, arr: np.ndarray) -> np.ndarray:
    """A flax kernel at module path ``prefix`` as the torch weight."""
    module = prefix.rstrip(".").rpartition(".")[2]
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3 and module in _DENSE_GENERAL:
        # contract the heads of an output projection, split the heads of
        # an input one
        flat = (arr.reshape(-1, arr.shape[-1]) if module == "out"
                else arr.reshape(arr.shape[0], -1))
        return flat.T
    if arr.ndim == 3 and module.startswith("conv"):
        return arr.transpose(2, 1, 0)
    if arr.ndim == 4 and _is_conv(module):
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    raise ValueError(
        f"{prefix}kernel has shape {arr.shape}; only 2-D Dense kernels, 3-D "
        f"DenseGeneral kernels of {'/'.join(_DENSE_GENERAL)}, 3-D Conv "
        "kernels of conv* modules and 4-D Conv kernels of conv* / *conv "
        "modules are mapped")


def state_dict_from_jax_params(
    params: Mapping[str, Any],
    batch_stats: Optional[Mapping[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """``params``: nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, variables["params"])``; ``batch_stats``,
    where the model has BatchNorm, the same of ``variables["batch_stats"]``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str, stats: bool) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.", stats)
                continue
            arr = np.asarray(value, dtype=np.float32)
            if stats:
                if key not in _STATS:
                    raise ValueError(f"{prefix}{key}: batch_stats holds only "
                                     "BatchNorm mean and var")
                key = _STATS[key]
            elif key == "kernel":
                key, arr = "weight", _kernel(prefix, arr)
            elif key == "bias" and arr.ndim == 2:
                arr = arr.reshape(-1)
            elif key in ("scale", "embedding"):
                key = "weight"
            out[prefix + key] = torch.tensor(np.ascontiguousarray(arr))

    walk(params, "", False)
    if batch_stats is not None:
        walk(batch_stats, "", True)
    return out


def attention_heads(model: nn.Module) -> Dict[str, int]:
    """``{module path: heads}`` of every attention in ``model`` whose
    ``query`` / ``key`` / ``value`` / ``out`` are JAX DenseGenerals."""
    return {name: module.num_heads for name, module in model.named_modules()
            if hasattr(module, "query") and hasattr(module, "num_heads")}


def _nest(tree: Dict[str, Any], path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def jax_params_from_state_dict(
    state_dict: Mapping[str, torch.Tensor],
    heads: Optional[Mapping[str, int]] = None,
) -> Dict[str, Any]:
    """The inverse of ``state_dict_from_jax_params`` for the parameters:
    the JAX ``params`` tree as nested dicts of float32 numpy arrays.
    BatchNorm's running statistics are left out.  ``heads`` maps the path
    of each DenseGeneral attention to its head count
    (``attention_heads(model)``); a ``query`` / ``key`` / ``value`` /
    ``out`` tensor under any other path raises."""
    heads = dict(heads or {})
    out: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        *modules, key = name.split(".")
        if key in _STATS.values():
            continue
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        module = modules[-1] if modules else ""
        parent = ".".join(modules[:-1])
        general = module in _DENSE_GENERAL and parent in heads
        if module in _DENSE_GENERAL and not general and arr.ndim == 2 and module != "out":
            raise ValueError(f"{name}: a DenseGeneral projection needs its head "
                             "count (heads=attention_heads(model))")
        if key == "weight" and module.endswith("embedding"):
            key = "embedding"
        elif key == "weight" and arr.ndim == 1:
            key = "scale"
        elif key == "weight":
            key = "kernel"
            if general:
                h = heads[parent]
                arr = (arr.T.reshape(h, -1, arr.shape[0]) if module == "out"
                       else arr.T.reshape(arr.shape[1], h, -1))
            elif arr.ndim == 3 and module.startswith("conv"):
                arr = arr.transpose(2, 1, 0)
            elif arr.ndim == 4 and _is_conv(module):
                arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"{name} has shape {arr.shape}: no JAX kernel maps to it")
        elif key == "bias" and general and module != "out":
            arr = arr.reshape(heads[parent], -1)
        _nest(out, [*modules, key], np.ascontiguousarray(arr))
    return out
