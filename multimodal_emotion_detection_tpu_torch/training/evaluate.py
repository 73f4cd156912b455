"""Test-time aggregation and the end-of-run artifacts.

The JAX package's contract: ``confusion_matrix.npy`` always, and
``confusion_matrix.png`` where matplotlib is installed; ``results.json``
with the best checkpoint's path, its validation loss and the resolved
config; for uncertainty fusion ``uncertainty.json``, the calibration
report.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

RAVDESS_CLASS_NAMES = [
    "neutral", "calm", "happy", "sad", "angry", "fearful", "disgust",
    "surprised",
]


def confusion_matrix(labels: np.ndarray, preds: np.ndarray,
                     num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (labels.astype(int), preds.astype(int)), 1)
    return cm


def macro_f1(cm: np.ndarray) -> float:
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.clip(denom, 1, None), 0.0)
    return float(f1.mean())


def class_names_for(dataset_name: str, num_classes: int) -> List[str]:
    if dataset_name == "ravdess" and num_classes == 8:
        return list(RAVDESS_CLASS_NAMES)
    return [f"C{i}" for i in range(num_classes)]


def save_confusion_matrix(cm: np.ndarray, save_root: Path,
                          class_names: Optional[List[str]] = None) -> None:
    save_root = Path(save_root)
    save_root.mkdir(parents=True, exist_ok=True)
    np.save(save_root / "confusion_matrix.npy", cm)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    n = cm.shape[0]
    names = class_names or [f"C{i}" for i in range(n)]
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(cm, interpolation="nearest", cmap="Blues")
    fig.colorbar(im, ax=ax)
    ax.set(
        xticks=np.arange(n), yticks=np.arange(n),
        xticklabels=names, yticklabels=names,
        ylabel="True label", xlabel="Predicted label",
        title="Confusion Matrix",
    )
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right",
             rotation_mode="anchor")
    thresh = cm.max() / 2.0 if cm.max() > 0 else 0.5
    for i in range(n):
        for j in range(n):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black",
                    fontsize=8)
    fig.tight_layout()
    fig.savefig(save_root / "confusion_matrix.png", dpi=200)
    plt.close(fig)


def write_results_json(save_dir: Path, best_model_path: Optional[Path],
                       best_val_loss: float, config_dict: Dict) -> Path:
    results = {
        "best_model_path": str(best_model_path) if best_model_path else "",
        "best_val_loss": float(best_val_loss),
        "config": config_dict,
    }
    out = Path(save_dir) / "results.json"
    out.write_text(json.dumps(results, indent=2))
    return out


def write_uncertainty_json(
    experiments_dir: Path,
    dataset_name: str,
    ece: float,
    nll: float,
    bins: List[float],
    accuracy_per_bin: List[Optional[float]],
) -> Path:
    experiments_dir = Path(experiments_dir)
    experiments_dir.mkdir(parents=True, exist_ok=True)
    out_obj = {
        "dataset": str(dataset_name),
        "calibration_metrics": {
            "ece": round(float(ece), 3),
            "nll": round(float(nll), 3),
            "bins": bins,
            "accuracy_per_bin": accuracy_per_bin,
        },
    }
    out = experiments_dir / "uncertainty.json"
    out.write_text(json.dumps(out_obj, indent=2))
    return out
