"""Convert a JAX checkpoint (``.ckpt``) into a PyTorch-port checkpoint,
or a JAX int8 serving artifact into the port's.

    python scripts/jax_ckpt_to_torch.py outputs/<run>/best.ckpt model.pt
    python scripts/jax_ckpt_to_torch.py --artifact model_int8.msgpack model_int8.pt

Reads the msgpack TrainState the JAX package saves, takes its ``params``
and, for a model with BatchNorm, its ``model_state["batch_stats"]`` (the
running statistics, as buffers), and writes them in the port's format (``torch.save({"state_dict",
"meta"})``), with the JSON sidecar's meta (epoch, step, val_loss) when
there is one.  The port's predict CLI then serves it:

    python -m multimodal_emotion_detection_tpu_torch.tools.predict \
        --checkpoint model.pt --config configs/base.yaml ...

With ``--artifact`` it reads the msgpack artifact the JAX package's
``tools.quantize`` writes and writes the port's (``utils/quantize.py``,
``torch.save``) with the same int8 codes, scales and unquantized leaves
bit for bit, in the same JAX layout, and the same meta; the port's predict
serves it with ``--quantized-artifact``.

This script is the one place that reads both frameworks' formats; it
needs flax, the port does not.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
from flax import serialization

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multimodal_emotion_detection_tpu_torch.training.checkpoints import (  # noqa: E402
    save_checkpoint,
)
from multimodal_emotion_detection_tpu_torch.utils.quantize import (  # noqa: E402
    FORMAT,
    write_artifact,
)
from multimodal_emotion_detection_tpu_torch.utils.weights import (  # noqa: E402
    state_dict_from_jax_params,
)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _codes(tree):
    """The JAX artifact's ``{"::int8::": {"q", "scale"}}`` leaves as the
    port's ``{"q", "scale"}``."""
    if isinstance(tree, dict):
        if set(tree) == {"::int8::"}:
            return {k: np.asarray(v) for k, v in tree["::int8::"].items()}
        return {k: _codes(v) for k, v in tree.items()}
    return np.asarray(tree)


def convert_artifact(src: Path, out: Path) -> Path:
    payload = serialization.msgpack_restore(src.read_bytes())
    if payload.get("format") != FORMAT:
        raise ValueError(f"not an int8 serving artifact: {src}")
    meta = dict(payload.get("meta") or {})
    meta["converted_from"] = src.name
    size = write_artifact(out, _codes(payload["quantized"]), meta)
    print(f"Wrote {out} ({size} bytes)")
    return out


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--artifact", action="store_true",
                        help="convert a tools.quantize msgpack artifact")
    parser.add_argument("jax_checkpoint")
    parser.add_argument("out")
    args = parser.parse_args(argv)

    src = Path(args.jax_checkpoint)
    if args.artifact:
        return convert_artifact(src, Path(args.out))
    state = serialization.msgpack_restore(src.read_bytes())
    batch_stats = (state.get("model_state") or {}).get("batch_stats")
    state_dict = state_dict_from_jax_params(
        _to_numpy(state["params"]),
        _to_numpy(batch_stats) if batch_stats else None)
    sidecar = src.with_suffix(src.suffix + ".json")
    meta = json.loads(sidecar.read_text()) if sidecar.exists() else {}
    meta["converted_from"] = src.name
    out = Path(args.out)
    save_checkpoint(out, state_dict, meta)
    print(f"Wrote {out} ({len(state_dict)} tensors)")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
