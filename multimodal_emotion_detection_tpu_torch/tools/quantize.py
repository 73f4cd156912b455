"""Checkpoint -> int8 serving-artifact CLI (weight-only PTQ).

    python -m multimodal_emotion_detection_tpu_torch.tools.quantize \
        --checkpoint outputs/<run>/best.ckpt [--config configs/base.yaml] \
        [--out model_int8.pt] [--min-size N] [overrides...]

Loads a port checkpoint, quantizes its parameters per output channel to
int8 in the JAX package's layout (``utils/quantize.py``: the codes,
scales and byte counts are the JAX package's) and writes the artifact
(``torch.save``; the JAX package writes msgpack, which
``scripts/jax_ckpt_to_torch.py --artifact`` converts).  Prints the byte
stats and the compression.  Serve it with ``tools.predict
--quantized-artifact model_int8.pt``.  It builds the model on the CUDA
card; ``runtime.platform=cpu`` builds it on the CPU, and without a card
and without that override it raises.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Quantize a checkpoint")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", default=None)
    parser.add_argument("--out", default="model_int8.pt")
    parser.add_argument("--min-size", type=int, default=None,
                        help="smallest leaf (elements) to quantize "
                             "(default: utils.quantize.DEFAULT_MIN_SIZE)")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.tools._restore import restore_model
    from multimodal_emotion_detection_tpu_torch.utils.quantize import (
        DEFAULT_MIN_SIZE,
        model_params,
        save_quantized,
    )
    from multimodal_emotion_detection_tpu_torch.utils.runtime import (
        device_from_config,
    )

    config = load_config(args.config, args.overrides)
    config.model.frontend.cache = False
    model, meta = restore_model(config, args.checkpoint, device_from_config(config))

    min_size = DEFAULT_MIN_SIZE if args.min_size is None else args.min_size
    stats = save_quantized(args.out, model_params(model), meta=meta,
                           min_size=min_size)
    stats["compression"] = round(
        stats["bytes_f32"] / max(1, stats["bytes_quantized"]), 3)
    print(json.dumps(stats, indent=2))
    print(f"Wrote int8 serving artifact to {args.out}")
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
