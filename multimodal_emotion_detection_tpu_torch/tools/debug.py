"""Debug harness: the four training-sanity probes of the JAX package's
``tools.debug``, on the card.

    python -m multimodal_emotion_detection_tpu_torch.tools.debug \
        [--config configs/x.yaml] [overrides...]

1. label-distribution audit per split;
2. head-only overfit-one-batch: the encoders frozen (no update, no weight
   decay; their parameters take no gradient, so their backward does not
   run), Adam at lr 1e-2 with the global-norm clip 1.0 over the head's
   gradients, dropout off; PASS if accuracy > 0.98 within <= 200 steps;
3. encoder-output and fused-logit statistics of one deterministic forward;
4. gradient-magnitude statistics (global norm per top-level module) from
   one backward pass in training mode.

Models are built from ``config`` with ``init_weights`` from ``seed``
unless one is passed in.  It runs on the CUDA card; ``runtime.platform=cpu``
runs it on the CPU, where every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import copy
import sys
from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
    init_weights,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise


def inspect_label_distribution(loaders: Dict[str, object]) -> Dict[str, Dict]:
    out = {}
    for split, loader in loaders.items():
        counts = Counter(int(x) for x in loader.arrays.labels)
        total = sum(counts.values())
        dist = {k: counts[k] / total for k in sorted(counts)}
        print(f"[labels] {split}: n={total} dist=" + ", ".join(
            f"{k}:{v:.3f}" for k, v in dist.items()
        ))
        out[split] = dist
    return out


def _seeded_model(config, device: torch.device) -> nn.Module:
    return init_weights(classifier_from_config(config),
                        torch.Generator().manual_seed(config.seed)).to(device)


def _first_batch(loader):
    """The split's first ``min(batch_size, N)`` rows, on its device."""
    feats, labels = loader.device_arrays()
    b = min(loader.batch_size, loader.num_samples)
    return {m: a[:b] for m, a in feats.items()}, labels[:b]


def overfit_one_batch(
    config, train_loader, max_steps: int = 200, lr: float = 1e-2,
    freeze_encoders: bool = True, target_acc: float = 0.98,
    model: Optional[nn.Module] = None,
) -> bool:
    from multimodal_emotion_detection_tpu_torch.training.steps import train_step

    cfg = copy.deepcopy(config)
    cfg.model.dropout = 0.0
    for enc in cfg.model.encoders.values():
        enc["dropout"] = 0.0
    if model is None:
        model = _seeded_model(cfg, train_loader.device)
    head = []
    for name, p in model.named_parameters():
        # the top-level ``<modality>_encoder`` modules, as the JAX probe's
        # optax mask labels them
        frozen = freeze_encoders and name.split(".", 1)[0].endswith("_encoder")
        p.requires_grad_(not frozen)
        if not frozen:
            head.append(p)
    optimizer = torch.optim.Adam(head, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    feats_all, labels_all = train_loader.device_arrays()
    b = min(train_loader.batch_size, train_loader.num_samples)
    device = train_loader.device
    idx = torch.arange(b, device=device)
    valid = torch.ones((b,), dtype=torch.float32, device=device)
    generator = torch.Generator(device=device)
    acc = 0.0
    for i in range(max_steps):
        generator.manual_seed(0)
        metrics = train_step(model, optimizer, feats_all, labels_all, idx, valid,
                             lr=lr, clip_norm=1.0, modality_dropout=0.0,
                             noise=Noise(generator))
        acc = float(metrics["acc"])
        if acc > target_acc:
            print(f"[overfit] PASS at step {i + 1}: acc={acc:.4f}")
            return True
    print(f"[overfit] FAIL after {max_steps} steps: acc={acc:.4f}")
    return False


def activation_stats(config, train_loader, model: Optional[nn.Module] = None
                     ) -> Dict[str, Dict[str, float]]:
    if model is None:
        model = _seeded_model(config, train_loader.device)
    batch, _ = _first_batch(train_loader)
    model.eval()
    with torch.inference_mode():
        logits, aux = model(batch, return_aux=True)
    stats = {}
    for name, tensor in {**aux["encoded"], "logits": logits}.items():
        arr = tensor.float().cpu().numpy()  # bf16 under bf16 compute
        stats[name] = {
            "mean": float(arr.mean()), "std": float(arr.std()),
            "min": float(arr.min()), "max": float(arr.max()),
        }
        print(f"[activations] {name}: " + ", ".join(
            f"{k}={v:.4f}" for k, v in stats[name].items()
        ))
    return stats


def gradient_stats(config, train_loader, model: Optional[nn.Module] = None
                   ) -> Dict[str, float]:
    if model is None:
        model = _seeded_model(config, train_loader.device)
    batch, labels = _first_batch(train_loader)
    model.train()
    model.zero_grad(set_to_none=True)
    generator = torch.Generator(device=train_loader.device).manual_seed(1)
    logits = model(batch, noise=Noise(generator))
    F.cross_entropy(logits, labels.long()).backward()
    out = {}
    for top, module in model.named_children():
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        norm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads)))
        out[top] = norm
        print(f"[grads] {top}: global_norm={norm:.6f}")
    zero = [k for k, v in out.items() if v == 0.0]
    if zero:
        print(f"[grads] WARNING: zero gradients in {zero}")
    return out


def main(argv=None):
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.data.loader import (
        SYNTHETIC_KEYS,
        create_dataloaders,
    )
    from multimodal_emotion_detection_tpu_torch.utils.runtime import (
        device_from_config,
    )

    argv = list(sys.argv[1:] if argv is None else argv)
    config_path = None
    if argv and argv[0] == "--config":
        config_path = argv[1]
        argv = argv[2:]
    config = load_config(config_path, argv)
    # these probes feed RAW features to the model, so the frontend runs in
    # the forward even if the training run cached features per split (the
    # checkpoint is identical either way: the frontend has no parameters)
    config.model.frontend.cache = False
    device = device_from_config(config)

    train_loader, val_loader, test_loader = create_dataloaders(
        dataset_name=config.dataset.name,
        data_dir=config.dataset.data_dir,
        modalities=config.dataset.modalities,
        batch_size=config.dataset.batch_size,
        seed=config.seed,
        device=device,
        **{k: getattr(config.dataset, k) for k in SYNTHETIC_KEYS},
    )
    print("=" * 60)
    inspect_label_distribution(
        {"train": train_loader, "val": val_loader, "test": test_loader}
    )
    print("=" * 60)
    ok = overfit_one_batch(config, train_loader)
    print("=" * 60)
    activation_stats(config, train_loader)
    print("=" * 60)
    gradient_stats(config, train_loader)
    print("=" * 60)
    print(f"debug harness complete; overfit_one_batch {'PASS' if ok else 'FAIL'}")
    return ok


if __name__ == "__main__":
    main()
