"""Grid sweep CLI: lr x model.dropout x modality_dropout, on the card.

    python -m multimodal_emotion_detection_tpu_torch.tools.sweep \
        [--config configs/base.yaml] [--out grid_sweep_results] \
        [--vmap-lrs 5e-4,1e-3,2e-3] [--vmap-grid] [overrides...]

The JAX package's sweep.  By default it runs the reference's 3x2x2 grid
one training run after another through the port's ``train.run``, tags
each run ``lr{..}_drop{..}_mDrop{..}`` and harvests ``results.json``,
``confusion_matrix.{npy,png}``, ``best.ckpt``, the newest
``csv_logs/version_*/metrics.csv`` and a ``hyperparams.txt`` manifest into
``<out>/<tag>/``, then ``sweep_summary.json``.  ``--vmap-lrs`` trains one
member per learning rate side by side on the same batches
(``parallel/vmap_sweep.py``; ``vmap_sweep_results.json``); ``--vmap-grid``
the whole grid as one such program per model dropout, its lr x
modality-dropout members side by side (``vmap_grid_results.json``), and
``--vmap-lrs`` then replaces the grid's lr axis.  It runs on the CUDA
card; ``runtime.platform=cpu`` runs it on the CPU, and without a card and
without that override it raises.
"""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path
from typing import List, Sequence


def format_tag(lr: float, dropout: float, m_dropout: float) -> str:
    def fmt(x: float) -> str:
        # the reference's tag scheme keeps the full decimal form with '.'
        # replaced by 'p' (grid_sweep_results/lr0p0005_drop0p0_mDrop0p0)
        return str(float(x)).replace(".", "p").replace("-", "m")

    return f"lr{fmt(lr)}_drop{fmt(dropout)}_mDrop{fmt(m_dropout)}"


HARVESTED = ("results.json", "confusion_matrix.npy", "confusion_matrix.png",
             "best.ckpt")


def run_sweep(
    base_config,
    learning_rates: Sequence[float] = (5e-4, 1e-3, 2e-3),
    dropouts: Sequence[float] = (0.0, 0.1),
    modality_dropouts: Sequence[float] = (0.0, 0.05),
    out_root: str = "grid_sweep_results",
    overrides: List[str] | None = None,
) -> List[dict]:
    from multimodal_emotion_detection_tpu_torch.train import run as train_run

    out_dir = Path(out_root)
    out_dir.mkdir(parents=True, exist_ok=True)
    all_results = []
    total = len(learning_rates) * len(dropouts) * len(modality_dropouts)
    i = 0
    for lr in learning_rates:
        for dropout in dropouts:
            for m_drop in modality_dropouts:
                i += 1
                tag = format_tag(lr, dropout, m_drop)
                print(f"\n=== sweep {i}/{total}: {tag} ===")
                cfg = copy.deepcopy(base_config)
                cfg.training.learning_rate = lr
                cfg.model.dropout = dropout
                cfg.training.augmentation.modality_dropout = m_drop
                cfg.experiment.name = f"{base_config.experiment.name}_{tag}"

                result = train_run(cfg, overrides=overrides)
                result["tag"] = tag

                run_dir = Path(cfg.experiment.save_dir) / cfg.experiment.name
                dest = out_dir / tag
                dest.mkdir(parents=True, exist_ok=True)
                for artifact in HARVESTED:
                    src = run_dir / artifact
                    if src.exists():
                        shutil.copy(str(src), str(dest / artifact))
                # newest metrics.csv
                csvs = sorted(run_dir.glob("csv_logs/version_*/metrics.csv"))
                if csvs:
                    shutil.copy(str(csvs[-1]), str(dest / "metrics.csv"))
                # the manifest mirrors the reference's field set
                enc = {k: dict(v) for k, v in dict(cfg.model.encoders).items()}
                a = enc.get("audio", {})
                v = enc.get("video", {})
                (dest / "hyperparams.txt").write_text(
                    f"experiment.name = {cfg.experiment.name}\n"
                    f"learning_rate   = {lr}\n"
                    f"model.dropout   = {dropout}\n"
                    f"modality_dropout= {m_drop}\n"
                    f"model.output_dim= {cfg.model.output_dim}\n"
                    f"model.hidden_dim= {cfg.model.hidden_dim}\n"
                    f"audio.hidden_dim= {a.get('hidden_dim')}\n"
                    f"audio.output_dim= {a.get('output_dim', cfg.model.output_dim)}\n"
                    f"audio.num_layers= {a.get('num_layers')}\n"
                    f"video.hidden_dim= {v.get('hidden_dim')}\n"
                    f"video.output_dim= {v.get('output_dim', cfg.model.output_dim)}\n"
                )
                all_results.append(result)

    summary = out_dir / "sweep_summary.json"
    summary.write_text(json.dumps(all_results, indent=2, default=float))
    print(f"\nSweep complete; summary at {summary}")
    best = min(all_results, key=lambda r: r.get("best_val_loss", 1e9))
    print(f"Best: {best['tag']} val_loss={best['best_val_loss']:.4f}")
    return all_results


def _loaders(config):
    """The train and val loaders on the config's device (the members are
    placed there).  They feed RAW features, so the frontend runs inside
    every step even if the config caches it per split."""
    from multimodal_emotion_detection_tpu_torch.data.loader import (
        SYNTHETIC_KEYS,
        create_dataloaders,
    )
    from multimodal_emotion_detection_tpu_torch.utils.runtime import (
        device_from_config,
    )

    config.model.frontend.cache = False
    device = device_from_config(config)
    ds = config.dataset
    train_loader, val_loader, _ = create_dataloaders(
        dataset_name=ds.name, data_dir=ds.data_dir, modalities=ds.modalities,
        batch_size=ds.batch_size, seed=config.seed, mmap=ds.mmap, device=device,
        **{k: getattr(ds, k) for k in SYNTHETIC_KEYS})
    return train_loader, val_loader


def run_vmapped_lr_sweep(config, lrs, out_root="grid_sweep_results"):
    """One member per learning rate, side by side
    (``parallel/vmap_sweep.vmapped_lr_sweep``), at the config's dropouts."""
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
    )
    from multimodal_emotion_detection_tpu_torch.parallel.vmap_sweep import (
        vmapped_lr_sweep,
    )

    train_loader, val_loader = _loaders(config)
    results = vmapped_lr_sweep(
        classifier_from_config(config), train_loader, val_loader, lrs,
        epochs=config.training.max_epochs,
        modality_dropout=config.training.augmentation.modality_dropout,
        clip_norm=config.training.gradient_clip_norm,
        weight_decay=config.training.weight_decay,
        seed=config.seed,
    )
    out_dir = Path(out_root)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "vmap_sweep_results.json").write_text(json.dumps(results, indent=2))
    for r in results:
        print(f"lr={r['learning_rate']:g}: best_val_loss="
              f"{r['best_val_loss']:.4f} @ epoch {r['best_epoch']}")
    return results


def run_vmapped_grid_sweep(
    config,
    learning_rates: Sequence[float] = (5e-4, 1e-3, 2e-3),
    dropouts: Sequence[float] = (0.0, 0.1),
    modality_dropouts: Sequence[float] = (0.0, 0.05),
    out_root: str = "grid_sweep_results",
):
    """The whole grid as one program per model dropout, its lr x
    modality-dropout members side by side
    (``parallel/vmap_sweep.vmapped_grid_sweep``)."""
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
    )
    from multimodal_emotion_detection_tpu_torch.parallel.vmap_sweep import (
        vmapped_grid_sweep,
    )

    train_loader, val_loader = _loaders(config)

    def model_factory(model_dropout):
        cfg = copy.deepcopy(config)
        cfg.model.dropout = model_dropout
        return classifier_from_config(cfg)

    results = vmapped_grid_sweep(
        model_factory, train_loader, val_loader,
        lrs=learning_rates,
        model_dropouts=dropouts,
        modality_dropouts=modality_dropouts,
        epochs=config.training.max_epochs,
        clip_norm=config.training.gradient_clip_norm,
        weight_decay=config.training.weight_decay,
        seed=config.seed,
    )
    out_dir = Path(out_root)
    out_dir.mkdir(parents=True, exist_ok=True)
    for r in results:
        r["tag"] = format_tag(r["learning_rate"], r["model_dropout"],
                              r["modality_dropout"])
        print(f"{r['tag']}: best_val_loss={r['best_val_loss']:.4f} "
              f"@ epoch {r['best_epoch']}")
    (out_dir / "vmap_grid_results.json").write_text(json.dumps(results, indent=2))
    return results


def main(argv=None):
    from multimodal_emotion_detection_tpu_torch.config import load_config

    argv = list(sys.argv[1:] if argv is None else argv)
    config_path, out_root = None, "grid_sweep_results"
    vmap_lrs = None
    vmap_grid = False
    rest = []
    it = iter(argv)
    for a in it:
        if a == "--config":
            config_path = next(it)
        elif a == "--out":
            out_root = next(it)
        elif a == "--vmap-lrs":
            vmap_lrs = [float(x) for x in next(it).split(",")]
        elif a == "--vmap-grid":
            vmap_grid = True
        else:
            rest.append(a)
    cfg = load_config(config_path, rest)
    if vmap_grid:
        # --vmap-lrs composes: it replaces the grid's lr axis
        kw = {"learning_rates": vmap_lrs} if vmap_lrs else {}
        return run_vmapped_grid_sweep(cfg, out_root=out_root, **kw)
    if vmap_lrs:
        return run_vmapped_lr_sweep(cfg, vmap_lrs, out_root=out_root)
    return run_sweep(cfg, out_root=out_root, overrides=rest)


if __name__ == "__main__":
    main()
