"""Training entry point, on the card.

    python -m multimodal_emotion_detection_tpu_torch.train \
        [--config configs/base.yaml] [--resume] [overrides...]

The JAX package's training CLI: print the config, snapshot it, build the
loaders and the model, fit (early stopping, top-k checkpoints, resume from
``last.ckpt``), test the best checkpoint, write the confusion matrix and a
final test row in ``metrics.csv``; then, for an uncertainty fusion, the
calibration report (``./analysis/calibration_diagram.png``, relative to
the working directory, and ``<outputs.experiments_dir>/uncertainty.json``),
else copy the best checkpoint to ``best.ckpt`` and write ``results.json``.
It runs on the CUDA card; ``runtime.platform=cpu`` runs it on the CPU
instead, where every kernel wrapper runs its plain version.
Keys of the TPU build that choose a route (``runtime.lstm_kernels``,
``epoch_scan``, ``epoch_pregather``, ``donate_state``, the encoders'
``scan_unroll`` and ``inference_kernel``) are accepted and do not route.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from multimodal_emotion_detection_tpu_torch.config import (
    Config,
    config_to_dict,
    config_to_yaml,
    load_config,
    snapshot_config,
)

def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Multimodal emotion detection training (PyTorch port)")
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config (defaults to built-in base config)")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from last.ckpt if present")
    parser.add_argument("overrides", nargs="*",
                        help="key.path=value config overrides")
    return parser.parse_args(argv)


def run(config: Config, overrides=None, resume: bool = False) -> dict:
    from multimodal_emotion_detection_tpu_torch.data.loader import (
        SYNTHETIC_KEYS,
        create_dataloaders,
    )
    from multimodal_emotion_detection_tpu_torch.models.fusion import (
        _UNCERTAINTY_ALIASES,
    )
    from multimodal_emotion_detection_tpu_torch.training.evaluate import (
        class_names_for,
        confusion_matrix,
        macro_f1,
        save_confusion_matrix,
        write_results_json,
        write_uncertainty_json,
    )
    from multimodal_emotion_detection_tpu_torch.training.loop import Trainer
    from multimodal_emotion_detection_tpu_torch.uncertainty.calibration import (
        CalibrationMetrics,
        per_bin_accuracy,
    )

    print("=" * 80)
    print("Configuration:")
    print(config_to_yaml(config))
    print("=" * 80)

    save_dir = Path(config.experiment.save_dir) / config.experiment.name
    save_dir.mkdir(parents=True, exist_ok=True)
    snapshot_config(config, save_dir, overrides)

    print("\nCreating model...")
    trainer = Trainer(config, save_dir=save_dir)
    print("\nCreating dataloaders...")
    train_loader, val_loader, test_loader = create_dataloaders(
        dataset_name=config.dataset.name,
        data_dir=config.dataset.data_dir,
        modalities=config.dataset.modalities,
        batch_size=config.dataset.batch_size,
        num_workers=config.dataset.num_workers,
        seed=config.seed,
        device_resident=config.dataset.device_resident,
        mmap=config.dataset.mmap,
        device=trainer.device,
        **{k: getattr(config.dataset, k) for k in SYNTHETIC_KEYS},
    )
    print(f"Train batches: {len(train_loader)}")
    print(f"Val batches: {len(val_loader)}")
    print(f"Test batches: {len(test_loader)}")
    trainer._build(train_loader)
    print(f"Total parameters: {trainer.num_params:,}")

    print("\nStarting training...")
    trainer.fit(train_loader, val_loader, resume=resume)

    print("\nTesting best model...")
    best_model = trainer.load_best()
    best_path = trainer.checkpoints.best_model_path
    print(f"Loading best model from: {best_path}")
    test_metrics, logits, preds, labels = trainer.test(test_loader, model=best_model)
    for name, value in test_metrics.items():
        print(f"{name}: {value:.4f}")
    # the reference's trainer.test logs a final test row into the same CSV
    trainer.csv_logger.log_metrics(dict(test_metrics), step=trainer.step)

    cm = confusion_matrix(labels, preds, config.dataset.num_classes)
    save_confusion_matrix(
        cm, save_dir,
        class_names_for(config.dataset.name, config.dataset.num_classes))
    print(f"Saved confusion matrix to {save_dir / 'confusion_matrix.npy'}")
    test_metrics["test/macro_f1"] = macro_f1(cm)

    results = dict(test_metrics)
    if config.model.fusion_type.lower() in _UNCERTAINTY_ALIASES:
        print("\nComputing calibration metrics (uncertainty fusion detected)...")
        num_bins = config.evaluation.num_calibration_bins
        nll = CalibrationMetrics.negative_log_likelihood(logits, labels)
        probs = np.exp(logits - logits.max(axis=-1, keepdims=True))
        probs /= probs.sum(axis=-1, keepdims=True)
        confs = probs.max(axis=-1)
        ece = CalibrationMetrics.expected_calibration_error(
            confs, preds, labels, num_bins=num_bins)
        bins_list, acc_per_bin = per_bin_accuracy(confs, preds, labels, num_bins)
        CalibrationMetrics.reliability_diagram(
            confs, preds, labels, num_bins=num_bins,
            save_path=str(Path("./analysis") / "calibration_diagram.png"))
        print("Reliability diagram created")
        out = write_uncertainty_json(
            Path(config.outputs.experiments_dir), config.dataset.name,
            ece, nll, bins_list, acc_per_bin)
        print(f"Saved uncertainty report to: {out}")
        results.update({"ece": ece, "nll": nll})
    else:
        best_copy = trainer.checkpoints.copy_best(save_dir / "best.ckpt")
        if best_copy:
            print(f"Copied best checkpoint to: {best_copy}")
        results_file = write_results_json(
            save_dir, best_path, trainer.checkpoints.best_model_score,
            config_to_dict(config))
        print(f"\nTraining complete! Results saved to: {results_file}")
        print(f"Best model: {best_path}")
        print(f"Best validation loss: {trainer.checkpoints.best_model_score:.4f}")

    results["best_val_loss"] = float(trainer.checkpoints.best_model_score)
    return results


def main(argv=None):
    args = parse_args(argv)
    config = load_config(args.config, args.overrides)
    return run(config, overrides=args.overrides, resume=args.resume)


if __name__ == "__main__":
    main(sys.argv[1:])
