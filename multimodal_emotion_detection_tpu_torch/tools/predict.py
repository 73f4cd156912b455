"""Inference / robustness-evaluation CLI (the serving path), on the card.

    python -m multimodal_emotion_detection_tpu_torch.tools.predict \
        --checkpoint model.pt [--config configs/base.yaml] [--split test] \
        [--missing keep_idx,keep_idx] [--mc-dropout S] \
        [--quantize-weights int8|int8-bf16|bfloat16 [--quantize-min-size N] |
         --quantized-artifact model_int8.pt] [--out preds/] [overrides...]

Loads a port checkpoint (``scripts/jax_ckpt_to_torch.py`` converts a JAX
one), runs the inference forward over a split and writes ``logits.npy``,
``predictions.npy``, ``labels.npy`` and ``metrics.json`` as the JAX
package's predict does.  It runs on the CUDA card; ``runtime.platform=cpu``
runs it on the CPU instead, and without a card and without that override
it raises.  ``--missing i[,j]`` keeps only the listed modality indices.
``--mc-dropout S`` runs S dropout samples per batch as one forward over S·B
rows (``uncertainty.mc_dropout_predict``, every batch drawing from a
generator seeded with ``seed``, as the JAX package reuses one key), writes
their mean logits in place of the forward's and ``uncertainty.npy``.
``--quantized-artifact`` serves the parameters of a ``tools.quantize``
artifact with the checkpoint's buffers (BatchNorm's running statistics);
``--quantize-weights`` round-trips the checkpoint's parameters through a
serving representation in memory (``utils/quantize.py``).  Either way the
model computes in float32 on the rounded weights, through the same
kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Inference / robustness eval")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", default=None)
    parser.add_argument("--split", default="test",
                        choices=["train", "val", "test"])
    parser.add_argument("--mc-dropout", type=int, default=0)
    parser.add_argument("--missing", default=None,
                        help="comma-separated modality indices to KEEP")
    parser.add_argument("--quantize-weights", default="none",
                        choices=["none", "int8", "int8-bf16", "bfloat16"],
                        help="round-trip params through the serving "
                             "quantization before eval (accuracy A/B)")
    parser.add_argument("--quantize-min-size", type=int, default=None,
                        help="smallest leaf (elements) to quantize")
    parser.add_argument("--quantized-artifact", default=None,
                        help="load params from a tools.quantize artifact "
                             "instead of the checkpoint's params")
    parser.add_argument("--out", default="./predictions")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.data.masking import (
        simulate_missing_modalities,
    )
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise
    from multimodal_emotion_detection_tpu_torch.tools._restore import (
        restore_for_eval,
    )
    from multimodal_emotion_detection_tpu_torch.training.steps import forward
    from multimodal_emotion_detection_tpu_torch.uncertainty.calibration import (
        compute_calibration_metrics,
    )
    from multimodal_emotion_detection_tpu_torch.uncertainty.mc_dropout import (
        mc_dropout_predict,
    )
    from multimodal_emotion_detection_tpu_torch.utils.runtime import (
        device_from_config,
    )

    config = load_config(args.config, args.overrides)
    # the loader feeds RAW features, so the frontend runs inside the
    # forward even if training cached features per split
    config.model.frontend.cache = False
    device = device_from_config(config)

    model, meta, loader = restore_for_eval(
        config, args.checkpoint, args.split, device)
    print(f"Restored {args.checkpoint} (meta: {meta}) on {device}")

    if args.quantized_artifact is not None:
        from multimodal_emotion_detection_tpu_torch.utils.quantize import (
            load_params,
            load_quantized,
        )

        qparams, qmeta = load_quantized(args.quantized_artifact)
        load_params(model, qparams)
        print(f"Loaded int8 serving artifact {args.quantized_artifact} "
              f"(meta: {qmeta})")
    elif args.quantize_weights != "none":
        from multimodal_emotion_detection_tpu_torch.utils.quantize import (
            DEFAULT_MIN_SIZE,
            load_params,
            model_params,
            quantize_params_for_eval,
        )

        load_params(model, quantize_params_for_eval(
            model_params(model), args.quantize_weights,
            min_size=(DEFAULT_MIN_SIZE if args.quantize_min_size is None
                      else args.quantize_min_size)))
        print(f"Quantized weights in-memory: {args.quantize_weights}")

    keep = (
        [int(i) for i in args.missing.split(",")]
        if args.missing is not None else None
    )
    logits_list, labels_list, unc_list = [], [], []
    for features, labels, mask in loader:
        if keep is not None:
            features, mask = simulate_missing_modalities(features, mask, keep)
        if args.mc_dropout > 0:
            noise = Noise(torch.Generator(device=device).manual_seed(config.seed))
            logits, unc = mc_dropout_predict(model, features, args.mc_dropout,
                                             noise=noise, mask=mask)
            unc_list.append(unc.cpu().numpy())
        else:
            logits = forward(model, features, mask)
        # float32, as the JAX tool writes them (bf16 logits under bf16 compute)
        logits_list.append(logits.float().cpu().numpy())
        labels_list.append(labels.numpy())

    logits = np.concatenate(logits_list)[: loader.num_samples]
    labels = np.concatenate(labels_list)[: loader.num_samples]
    preds = logits.argmax(-1)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "logits.npy", logits)
    np.save(out_dir / "predictions.npy", preds)
    np.save(out_dir / "labels.npy", labels)
    if unc_list:
        np.save(out_dir / "uncertainty.npy",
                np.concatenate(unc_list)[: loader.num_samples])

    metrics = compute_calibration_metrics(
        logits, labels, config.evaluation.num_calibration_bins
    )
    metrics["split"] = args.split
    metrics["missing_pattern"] = keep
    metrics["mc_dropout_samples"] = args.mc_dropout
    metrics["quantize_weights"] = (
        "int8-artifact" if args.quantized_artifact is not None
        else args.quantize_weights
    )
    (out_dir / "metrics.json").write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics, indent=2))
    print(f"Wrote predictions to {out_dir}")
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
