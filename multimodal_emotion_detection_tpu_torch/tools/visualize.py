"""Attention visualization CLI: cross-modal fusion weights from a
checkpoint.

    python -m multimodal_emotion_detection_tpu_torch.tools.visualize \
        --checkpoint outputs/<run>/best.ckpt [--config configs/av_hybrid.yaml] \
        [--out attention.png] [overrides...]

Runs the model over the first test batch (every modality available).  On
``model.train_fusion=library`` with ``model.fusion_type=hybrid`` it runs
the hybrid fusion again with ``return_attention`` on the encoded features
and renders the modality x modality heatmap of its cross-attention
(query modality x key modality, averaged over batch, heads and the one
query); otherwise it plots the batch mean of the fusion's weights where
the fusion gives them.  It runs on the CUDA card; ``runtime.platform=cpu``
runs it on the CPU, and without a card and without that override it
raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn


def attention_matrix(model: nn.Module, batch: Dict[str, torch.Tensor],
                     mask: torch.Tensor, modalities: Sequence[str]
                     ) -> Optional[np.ndarray]:
    """The heatmap's matrix: (M, M) for a hybrid fusion (row i: modality
    i's attention over the keys, averaged over batch, heads and query),
    else the (1, M) batch mean of the fusion weights; None where the model
    gives neither."""
    from multimodal_emotion_detection_tpu_torch.models.fusion import HybridFusion

    model.eval()
    with torch.inference_mode():
        _, aux = model(batch, mask, return_aux=True)
        if isinstance(getattr(model, "fusion", None), HybridFusion):
            _, info = model.fusion(aux["encoded"], mask, return_attention=True)
            rows = [info["per_modality_attention"][m].mean(dim=(0, 1, 2))
                    for m in modalities]
            # query x key modality, float32 also under bf16 compute
            return torch.stack(rows).float().cpu().numpy()
        weights = aux.get("fusion_weights")
        if weights is None:
            return None
        return weights.mean(dim=0, keepdim=True).float().cpu().numpy()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Attention visualization")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", default=None)
    parser.add_argument("--out", default="attention.png")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.data.loader import (
        SYNTHETIC_KEYS,
        create_dataloaders,
    )
    from multimodal_emotion_detection_tpu_torch.models.attention import (
        visualize_attention,
    )
    from multimodal_emotion_detection_tpu_torch.tools._restore import restore_model
    from multimodal_emotion_detection_tpu_torch.utils.runtime import (
        device_from_config,
    )

    config = load_config(args.config, args.overrides)
    # the loader feeds RAW features, so the frontend runs inside the
    # forward even if training cached features per split
    config.model.frontend.cache = False
    device = device_from_config(config)
    ds = config.dataset
    test_loader = create_dataloaders(
        dataset_name=ds.name, data_dir=ds.data_dir, modalities=ds.modalities,
        batch_size=ds.batch_size, seed=config.seed, mmap=ds.mmap, device=device,
        **{k: getattr(ds, k) for k in SYNTHETIC_KEYS})[2]
    model, _ = restore_model(config, args.checkpoint, device)

    feats_all, _ = test_loader.device_arrays()
    b = min(test_loader.batch_size, test_loader.num_samples)
    batch = {m: a[:b] for m, a in feats_all.items()}
    modalities = list(ds.modalities)
    mask = torch.ones((b, len(modalities)), dtype=torch.float32, device=device)
    attn = attention_matrix(model, batch, mask, modalities)
    if attn is None:
        print("This configuration exposes no fusion attention; use "
              "model.train_fusion=library model.fusion_type=hybrid")
        return None

    visualize_attention(attn, modalities, save_path=args.out)
    print(f"Saved attention heatmap to {args.out}")
    return args.out


if __name__ == "__main__":
    main(sys.argv[1:])
