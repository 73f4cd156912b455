"""Map a JAX parameter tree onto the port's ``state_dict``.

The port's modules carry the JAX tree's names, so each key is the JAX path
joined by dots (``audio_encoder.rnn.layer_0.w_ih``).  Some leaves change
name or layout on the way:

* a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in);
* a multi-head DenseGeneral becomes a Linear over the flattened heads: the
  attention's ``query`` / ``key`` / ``value`` kernel (D, H, Dh) a weight
  (H*Dh, D) and its bias (H, Dh) a bias (H*Dh,), the ``out`` kernel
  (H, Dh, D) a weight (D, H*Dh);
* a LayerNorm ``scale`` becomes ``weight``, an Embed ``embedding``
  ``weight``.

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

from typing import Any, Dict, Mapping

import numpy as np
import torch


def state_dict_from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``params``: nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, variables["params"])``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if key == "kernel":
                if arr.ndim == 3:
                    # DenseGeneral: contract the heads of an output
                    # projection, split the heads of an input one
                    arr = (arr.reshape(-1, arr.shape[-1]) if prefix.endswith("out.")
                           else arr.reshape(arr.shape[0], -1))
                elif arr.ndim != 2:
                    raise ValueError(
                        f"{prefix}kernel has shape {arr.shape}; only 2-D "
                        "Dense and 3-D DenseGeneral kernels are mapped"
                    )
                key, arr = "weight", arr.T
            elif key == "bias" and arr.ndim == 2:
                arr = arr.reshape(-1)
            elif key in ("scale", "embedding"):
                key = "weight"
            out[prefix + key] = torch.tensor(arr)

    walk(params, "")
    return out
