"""Map a JAX parameter tree onto the port's ``state_dict``.

The port's modules carry the JAX tree's names, so each key is the JAX path
joined by dots (``audio_encoder.rnn.layer_0.w_ih``).  Two leaves change
name or layout on the way:

* a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in);
* a LayerNorm ``scale`` becomes ``weight``.

Recurrent tensors keep their JAX names and layout: an LSTM layer's
``w_ih`` (D, 4H), ``w_hh`` (H, 4H) and one fused ``b``, gates i, f, g, o; a
GRU layer's ``w_ih`` (D, 3H), ``w_hh`` (H, 3H), ``b_ih`` and ``b_hh``, gates
r, z, n.  So a JAX classifier with either encoder maps key for key
(``tests/test_torch_port_gru_config.py`` loads a JAX GRU classifier's
tree with ``strict=True``).
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
                if arr.ndim != 2:
                    raise ValueError(
                        f"{prefix}kernel has shape {arr.shape}; only 2-D "
                        "Dense kernels are mapped"
                    )
                key, arr = "weight", arr.T
            elif key == "scale":
                key = "weight"
            out[prefix + key] = torch.tensor(arr)

    walk(params, "")
    return out
