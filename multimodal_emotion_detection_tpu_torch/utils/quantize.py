"""Weight-only quantization for serving artifacts, as the JAX package
quantizes.

Per-output-channel symmetric int8 quantization of the parameter tree:
every float tensor with at least 2 axes and ``min_size`` elements is
stored as int8 codes plus one float32 scale per channel of its LAST axis,
in the JAX package's layout (a Dense kernel (in, out), a DenseGeneral
projection (D, H, Dh), a Conv kernel (k, in, out), the recurrent tensors
as they are).  The port's tensors are laid out otherwise, so a model's
``state_dict`` is first mapped to that layout
(``utils/weights.py::jax_params_from_state_dict``) and the result mapped
back (``state_dict_from_jax_params``); the codes, scales and byte counts
are then the JAX package's, bit for bit.  Smaller leaves (biases, norm
scales) stay float32.

A tree here is nested dicts of numpy arrays.  numpy has no bfloat16, so
the bf16 modes return float32 arrays that hold the values rounded once to
bfloat16 (round to nearest even): the model computes in float32 on them,
as the JAX modules cast bf16 parameters to their float32 compute dtype.

Error bound: ``|w - deq(w)| <= scale/2 = max|w_channel| / 254``
elementwise.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.utils.weights import (
    attention_heads,
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)

# Leaves smaller than this stay unquantized (biases, norm params).
DEFAULT_MIN_SIZE = 1024
FORMAT = "int8-weight-only-v1"


def _quantize_leaf(w: np.ndarray) -> Dict[str, np.ndarray]:
    """Symmetric per-last-axis-channel int8 codes + f32 scales."""
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale.astype(np.float32)}


def round_bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded once to bfloat16, as float32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def _is_q(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict) and not _is_q(tree):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def quantize_tree(params: Any, min_size: int = DEFAULT_MIN_SIZE
                  ) -> Tuple[Any, Dict[str, int]]:
    """Returns ``(qtree, stats)``: ``qtree`` mirrors ``params`` with every
    qualifying leaf replaced by ``{"q", "scale"}``; ``stats`` the bytes
    before (float32-equivalent) and after."""
    stats = {"bytes_f32": 0, "bytes_quantized": 0}

    def leaf(arr):
        arr = np.asarray(arr)
        is_float = np.issubdtype(arr.dtype, np.floating)
        stats["bytes_f32"] += 4 * arr.size if is_float else arr.nbytes
        if is_float and arr.ndim >= 2 and arr.size >= min_size:
            entry = _quantize_leaf(arr)
            stats["bytes_quantized"] += entry["q"].nbytes + entry["scale"].nbytes
            return entry
        stats["bytes_quantized"] += arr.nbytes
        return arr

    qtree = _map(leaf, params)
    return qtree, {k: int(v) for k, v in stats.items()}


def dequantize_tree(qtree: Any, dtype: str = "float32") -> Any:
    """Inverse of ``quantize_tree``: codes times scales in float32,
    rounded to bfloat16 where ``dtype`` is ``"bfloat16"``; other leaves as
    they are."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dequantize to float32 or bfloat16, not {dtype!r}")

    def leaf(node):
        if not _is_q(node):
            return np.asarray(node)
        deq = np.asarray(node["q"], np.float32) * np.asarray(node["scale"], np.float32)
        return round_bf16(deq) if dtype == "bfloat16" else deq

    return _map(leaf, qtree)


def quantize_params_for_eval(params: Any, mode: str,
                             min_size: int = DEFAULT_MIN_SIZE) -> Any:
    """Round-trip ``params`` through the serving representation.

    ``mode``: 'int8' (weight-only PTQ round trip), 'int8-bf16' (the
    dequantized weights rounded to bf16), 'bfloat16' (every float leaf
    rounded to bf16) or 'none'."""
    if mode in (None, "none"):
        return params
    if mode == "bfloat16":
        return _map(lambda a: round_bf16(a) if np.issubdtype(np.asarray(a).dtype, np.floating)
                    else np.asarray(a), params)
    if mode in ("int8", "int8-bf16"):
        qtree, _ = quantize_tree(params, min_size=min_size)
        return dequantize_tree(qtree, "bfloat16" if mode == "int8-bf16" else "float32")
    raise ValueError(f"unknown quantization mode: {mode!r}")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and not _is_q(v):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        *parents, key = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = v
    return tree


def write_artifact(path, qtree: Any, meta: Dict[str, Any] | None = None) -> int:
    """Write an already quantized tree as the port's artifact:
    ``torch.save({"format", "quantized": {JAX path: {"q", "scale"} or
    array}, "meta"})``, the path's keys joined by '/'.  Returns the file's
    size in bytes."""
    def tensor(a):
        return torch.from_numpy(np.array(a))

    payload = {
        "format": FORMAT,
        "quantized": {p: ({"q": tensor(v["q"]), "scale": tensor(v["scale"])}
                          if _is_q(v) else tensor(v))
                      for p, v in _flatten(qtree).items()},
        "meta": dict(meta or {}),
    }
    torch.save(payload, str(path))
    return Path(path).stat().st_size


def save_quantized(path, params: Any, meta: Dict[str, Any] | None = None,
                   min_size: int = DEFAULT_MIN_SIZE) -> Dict[str, int]:
    """Quantize ``params`` (a JAX-layout tree) and write the serving
    artifact; returns the byte stats with ``bytes_file``."""
    qtree, stats = quantize_tree(params, min_size=min_size)
    stats["bytes_file"] = write_artifact(path, qtree, meta)
    return stats


def read_artifact(path) -> Tuple[Any, Dict[str, Any]]:
    """``(qtree, meta)`` of a ``save_quantized`` artifact, the codes as
    written."""
    payload = torch.load(str(path), map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"not an int8 serving artifact: {path}")
    flat = {p: ({"q": v["q"].numpy(), "scale": v["scale"].numpy()}
                if isinstance(v, dict) else v.numpy())
            for p, v in payload["quantized"].items()}
    return _unflatten(flat), payload.get("meta", {})


def load_quantized(path, dtype: str = "float32") -> Tuple[Any, Dict[str, Any]]:
    """Load a ``save_quantized`` artifact -> (params, meta), the params a
    JAX-layout tree dequantized to ``dtype``."""
    qtree, meta = read_artifact(path)
    return dequantize_tree(qtree, dtype), meta


def model_params(model: nn.Module) -> Dict[str, Any]:
    """``model``'s parameters as the JAX-layout tree."""
    return jax_params_from_state_dict(model.state_dict(), attention_heads(model))


def load_params(model: nn.Module, params: Any) -> nn.Module:
    """Load a JAX-layout parameter tree into ``model``'s parameters; its
    buffers (BatchNorm's running statistics) stay as they are."""
    missing, unexpected = model.load_state_dict(
        state_dict_from_jax_params(params), strict=False)
    params_missing = [k for k in missing if not k.endswith(("running_mean", "running_var"))]
    if unexpected or params_missing:
        raise ValueError(f"the tree does not fit the model: missing {params_missing}, "
                         f"unexpected {unexpected}")
    return model
