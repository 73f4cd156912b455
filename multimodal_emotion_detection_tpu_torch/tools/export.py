"""Ahead-of-time model export for serving (torch.export).

    python -m multimodal_emotion_detection_tpu_torch.tools.export \
        --checkpoint outputs/<run>/best.ckpt --out model.pt2 \
        [--config configs/base.yaml] [--batch 32] [overrides...]

Exports the eval-mode inference forward (dropout off, no mask, the
parameters baked in) at the static batch of the first ``--batch`` clips of
the test split with ``torch.export`` and writes it with
``torch.export.save``.  ``load_exported(path).module()(features)`` is the
whole server: it needs ``multimodal_emotion_detection_tpu_torch.ops``,
which registers the kernels' custom ops, and not the model code.  Each
kernel is one op node of the graph, so on the card the program launches
the same kernels as the eager forward.  The trace fixes the recurrent
route by the card's SM count, so a file exported on the card serves on a
card of that class.  Like the other tools it runs on the CUDA card;
``runtime.platform=cpu`` exports on the CPU (the plain versions behind the
same ops), and without a card and without that override it raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
from torch import nn


class Serve(nn.Module):
    """The served function: ``features`` -> logits of the eval-mode model."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model.eval()

    def forward(self, features):
        return self.model(features)


def load_exported(path) -> torch.export.ExportedProgram:
    """The program ``export_model`` wrote, its custom ops registered first."""
    import multimodal_emotion_detection_tpu_torch.ops  # noqa: F401

    return torch.export.load(str(path))


def export_model(config, checkpoint: str, batch_size: int, out_path: str) -> Path:
    from multimodal_emotion_detection_tpu_torch.tools._restore import (
        restore_for_eval,
    )
    from multimodal_emotion_detection_tpu_torch.utils.runtime import (
        device_from_config,
    )

    device = device_from_config(config)
    model, _, loader = restore_for_eval(config, checkpoint, "test", device)
    batch_size = min(batch_size, loader.num_samples)
    sample = {m: torch.from_numpy(np.ascontiguousarray(a[:batch_size])).to(device)
              for m, a in loader.arrays.features.items()}
    serve = Serve(model)
    with torch.no_grad():
        exported = torch.export.export(serve, (sample,))
    # the sample would be saved beside the weights (the flagship's b32
    # sample is 18.7 MB, 2.3 times its weights); serving does not read it
    exported.example_inputs = None
    out = Path(out_path)
    torch.export.save(exported, str(out))
    print(f"Exported {out.stat().st_size:,} bytes of torch.export program to {out}")

    # round-trip sanity: load the file and run it on the sample batch
    restored = load_exported(out).module()
    with torch.inference_mode():
        ref = serve(sample).float().cpu().numpy()
        got = restored(sample).float().cpu().numpy()
    err = float(np.abs(ref - got).max())
    rel = err / max(float(np.abs(ref).max()), 1e-12)
    print(f"Round-trip check: max |Δlogits| = {err:.2e} (rel {rel:.2e})")
    # the JAX package's gate: its deserialized program is compiled anew,
    # so it allows bf16 compute a rounding envelope; here the loaded
    # program runs the same ops, and the gate is a ceiling
    tol = 1e-5 if config.runtime.compute_dtype == "float32" else 1.5e-2
    assert rel < tol, (
        f"exported model diverges from the live model (rel {rel:.2e} >= {tol})"
    )
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="AOT export for serving")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", default=None)
    parser.add_argument("--out", default="model.pt2")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from multimodal_emotion_detection_tpu_torch.config import load_config

    config = load_config(args.config, args.overrides)
    # the served program takes RAW features, so the frontend runs inside
    # it even if the training run cached features per split (the
    # checkpoint is the same either way: the frontend has no parameters)
    config.model.frontend.cache = False
    return export_model(config, args.checkpoint, args.batch, args.out)


if __name__ == "__main__":
    main(sys.argv[1:])
