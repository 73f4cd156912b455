"""Import reference (torch / Lightning) checkpoints into the port.

The reference saves Lightning checkpoints whose ``state_dict`` keys follow
its LightningModule attribute layout (the reference's train.py:50-85 and
encoders.py):

    encoders.<m>.rnn.weight_ih_l{k} / weight_hh_l{k} / bias_*_l{k}  # LSTM / GRU
    encoders.<m>.conv{1,2}.weight / bias                # CNN Conv1d
    encoders.<m>.bn{1,2}.weight / bias / running_mean / running_var
    encoders.<m>.input_proj / pos_embedding             # transformer
    encoders.<m>.transformer.layers.{i}.self_attn.in_proj_weight / ...
    encoders.<m>.projection.{weight,bias}
    encoders.video.frame_mlp.0.{weight,bias}            # Linear
    encoders.video.attention.{weight,bias}              # attention-pool score
    encoders.video.projection.0.{weight,bias}           # LayerNorm
    encoders.video.projection.1.{weight,bias}           # Linear
    fusion_head.0.{weight,bias} / fusion_head.2.{weight,bias}

``import_reference_state_dict`` maps those tensors onto a port
``MultimodalClassifier`` (the template) and returns a ``state_dict`` that
loads into it with ``strict=True``, so a trained reference model serves
without retraining:

* an LSTM / GRU layer's ``weight_ih_l{k}`` (G*H, D) and ``weight_hh_l{k}``
  become ``w_ih`` (D, G*H) and ``w_hh`` (H, G*H), the port's layout (the
  gate order is torch's in both); an LSTM's two biases are summed into its
  one ``b``, a GRU keeps ``b_ih`` and ``b_hh`` apart (its reset gate
  applies inside);
* Linear, Conv1d, LayerNorm and Embedding tensors keep torch's layout;
  BatchNorm's scale and bias map, and so do its ``running_mean`` /
  ``running_var`` into the port's BatchNorm buffers, so an eval forward
  normalises with the trained statistics;
* a transformer layer's ``in_proj_weight`` / ``in_proj_bias`` split into
  ``query`` / ``key`` / ``value``, ``out_proj`` maps to ``out``, ``norm1`` /
  ``norm2`` to ``ln1`` / ``ln2`` and ``linear1`` / ``linear2`` to
  ``ffn_in`` / ``ffn_out``.

Every other tensor of the template keeps its value.  A mapped tensor whose
shape differs from the template's raises.  The JAX package's
``utils/torch_import.py``: the result equals
``utils/weights.py::state_dict_from_jax_params`` of JAX's import of the
same dict, tensor by tensor and bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn


def _t(tensor) -> torch.Tensor:
    return torch.as_tensor(tensor).detach().to("cpu")


def load_lightning_state_dict(
    ckpt_path: str, allow_pickle: bool = False
) -> Dict[str, Any]:
    """Read a Lightning ``.ckpt`` (or raw state_dict file) with torch.

    Loads with ``weights_only=True`` (tensor-only deserialisation, no
    arbitrary pickled code).  Some older Lightning checkpoints embed
    non-tensor objects (callbacks, hparams namespaces) that require full
    unpickling; pass ``allow_pickle=True`` ONLY for checkpoints you trust:
    full unpickling executes arbitrary code from the file.
    """
    try:
        obj = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise ValueError(
                f"{ckpt_path} is not loadable as a weights-only checkpoint. "
                "If you trust its origin, retry with allow_pickle=True "
                "(full unpickling can execute code embedded in the file)."
            )
        obj = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    return obj.get("state_dict", obj) if isinstance(obj, dict) else obj


def import_reference_state_dict(
    state_dict: Dict[str, Any],
    template: nn.Module,
    modalities=("audio", "video"),
) -> Dict[str, torch.Tensor]:
    """Map a reference state_dict onto ``template`` (a port
    ``MultimodalClassifier`` built with the matching configuration); the
    returned ``state_dict`` has the template's keys, shapes and dtypes."""
    sd = {k: _t(v) for k, v in state_dict.items()}
    out = {k: v.detach().clone() for k, v in template.state_dict().items()}

    def put(key: str, value: torch.Tensor) -> None:
        if key not in out:
            raise KeyError(f"the template has no tensor {key}")
        if tuple(value.shape) != tuple(out[key].shape):
            raise ValueError(f"{key}: the reference tensor has shape "
                             f"{tuple(value.shape)}, the template "
                             f"{tuple(out[key].shape)}")
        out[key] = value.to(out[key].dtype).contiguous()

    def copy(dst: str, src: str, names=("weight", "bias")) -> None:
        for name in names:
            put(f"{dst}.{name}", sd[f"{src}.{name}"])

    for modality in modalities:
        enc = f"{modality}_encoder"
        if not any(k.startswith(enc + ".") for k in out):
            continue
        base = f"encoders.{modality}"

        if f"{base}.rnn.weight_ih_l0" in sd:  # SequenceEncoder lstm / gru
            layer = 0
            while f"{base}.rnn.weight_ih_l{layer}" in sd:
                node = f"{enc}.rnn.layer_{layer}"
                put(f"{node}.w_ih", sd[f"{base}.rnn.weight_ih_l{layer}"].T)
                put(f"{node}.w_hh", sd[f"{base}.rnn.weight_hh_l{layer}"].T)
                b_ih = sd[f"{base}.rnn.bias_ih_l{layer}"]
                b_hh = sd[f"{base}.rnn.bias_hh_l{layer}"]
                if f"{node}.b" in out:  # LSTM: fused bias
                    put(f"{node}.b", b_ih + b_hh)
                else:  # GRU keeps both (reset gate is applied inside)
                    put(f"{node}.b_ih", b_ih)
                    put(f"{node}.b_hh", b_hh)
                layer += 1
            copy(f"{enc}.projection", f"{base}.projection")

        elif f"{base}.conv1.weight" in sd:  # SequenceEncoder cnn
            for conv in ("conv1", "conv2"):
                copy(f"{enc}.{conv}", f"{base}.{conv}")
            for bn in ("bn1", "bn2"):
                copy(f"{enc}.{bn}", f"{base}.{bn}",
                     ("weight", "bias", "running_mean", "running_var"))
            copy(f"{enc}.projection", f"{base}.projection")

        elif f"{base}.input_proj.weight" in sd:  # SequenceEncoder transformer
            copy(f"{enc}.input_proj", f"{base}.input_proj")
            put(f"{enc}.pos_embedding.weight", sd[f"{base}.pos_embedding.weight"])
            i = 0
            while f"{base}.transformer.layers.{i}.self_attn.in_proj_weight" in sd:
                lyr = f"{base}.transformer.layers.{i}"
                blk = f"{enc}.block_{i}"
                w_in = sd[f"{lyr}.self_attn.in_proj_weight"]  # (3E, E)
                b_in = sd[f"{lyr}.self_attn.in_proj_bias"]
                e = w_in.shape[1]
                for j, name in enumerate(("query", "key", "value")):
                    put(f"{blk}.self_attn.{name}.weight", w_in[j * e:(j + 1) * e])
                    put(f"{blk}.self_attn.{name}.bias", b_in[j * e:(j + 1) * e])
                copy(f"{blk}.self_attn.out", f"{lyr}.self_attn.out_proj")
                copy(f"{blk}.ln1", f"{lyr}.norm1")
                copy(f"{blk}.ln2", f"{lyr}.norm2")
                copy(f"{blk}.ffn_in", f"{lyr}.linear1")
                copy(f"{blk}.ffn_out", f"{lyr}.linear2")
                i += 1
            copy(f"{enc}.projection", f"{base}.projection")

        elif f"{base}.frame_mlp.0.weight" in sd:  # FrameEncoder
            copy(f"{enc}.frame_mlp", f"{base}.frame_mlp.0")
            if f"{base}.attention.weight" in sd:
                copy(f"{enc}.pool.attention", f"{base}.attention")
            copy(f"{enc}.proj_ln", f"{base}.projection.0")
            copy(f"{enc}.projection", f"{base}.projection.1")

    if "fusion_head.0.weight" in sd:  # concat head (the reference's train.py:81-85)
        copy("head_in", "fusion_head.0")
        copy("head_out", "fusion_head.2")
    return out


def import_reference_checkpoint(
    ckpt_path: str,
    template: nn.Module,
    modalities=("audio", "video"),
) -> Dict[str, torch.Tensor]:
    """``import_reference_state_dict`` of ``load_lightning_state_dict``
    (weights only: a checkpoint that needs ``allow_pickle`` goes through
    the two calls)."""
    return import_reference_state_dict(
        load_lightning_state_dict(ckpt_path), template, modalities,
    )
