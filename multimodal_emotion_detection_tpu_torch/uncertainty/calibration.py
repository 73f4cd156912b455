"""Calibration metrics: ECE / MCE / NLL / accuracy, the reliability
diagram and per-bin accuracy, on host-side logits.

Uniform bins over [0, 1], the right edge included only in the last bin;
ECE = sum over non-empty bins of |accuracy - confidence| * n_bin / N.
Numpy, in float64: these run once over a split's aggregated logits.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np


def _softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


class CalibrationMetrics:
    @staticmethod
    def bin_stats(
        confidences: np.ndarray,
        predictions: np.ndarray,
        labels: np.ndarray,
        num_bins: int = 15,
    ) -> Tuple[List[int], List[float], List[float]]:
        """Per non-empty bin: (size, avg confidence, accuracy)."""
        conf = np.clip(np.asarray(confidences, dtype=np.float64), 0.0, 1.0)
        preds = np.asarray(predictions).astype(np.int64)
        targs = np.asarray(labels).astype(np.int64)
        edges = np.linspace(0.0, 1.0, num_bins + 1)
        sizes, avg_confs, accs = [], [], []
        for b in range(num_bins):
            lo, hi = edges[b], edges[b + 1]
            if b < num_bins - 1:
                in_bin = (conf >= lo) & (conf < hi)
            else:
                in_bin = (conf >= lo) & (conf <= hi)
            if in_bin.any():
                sizes.append(int(in_bin.sum()))
                avg_confs.append(float(conf[in_bin].mean()))
                accs.append(float((preds[in_bin] == targs[in_bin]).mean()))
        if not sizes:
            return [0], [0.0], [0.0]
        return sizes, avg_confs, accs

    @staticmethod
    def expected_calibration_error(
        confidences, predictions, labels, num_bins: int = 15
    ) -> float:
        sizes, avg_confs, accs = CalibrationMetrics.bin_stats(
            confidences, predictions, labels, num_bins
        )
        n = float(sum(sizes))
        if n == 0:
            return 0.0
        return float(
            sum(abs(a - c) * (s / n) for s, c, a in zip(sizes, avg_confs, accs))
        )

    @staticmethod
    def maximum_calibration_error(
        confidences, predictions, labels, num_bins: int = 15
    ) -> float:
        _, avg_confs, accs = CalibrationMetrics.bin_stats(
            confidences, predictions, labels, num_bins
        )
        if not avg_confs:
            return 0.0
        return float(max(abs(a - c) for c, a in zip(avg_confs, accs)))

    @staticmethod
    def negative_log_likelihood(logits: np.ndarray, labels: np.ndarray) -> float:
        logits = np.asarray(logits, dtype=np.float64)
        labels = np.asarray(labels).astype(np.int64)
        z = logits - logits.max(axis=-1, keepdims=True)
        log_probs = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
        return float(-log_probs[np.arange(len(labels)), labels].mean())

    @staticmethod
    def reliability_diagram(
        confidences: np.ndarray,
        predictions: np.ndarray,
        labels: np.ndarray,
        num_bins: int = 15,
        save_path: Optional[str] = None,
    ) -> None:
        """Bin-wise accuracy against confidence, with the ECE in the title,
        saved to ``save_path`` (its parent directories made).  Returns
        without drawing where matplotlib is not installed."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        conf = np.clip(np.asarray(confidences, dtype=np.float32), 0.0, 1.0)
        preds = np.asarray(predictions).astype(np.int64)
        targs = np.asarray(labels).astype(np.int64)
        edges = np.linspace(0.0, 1.0, num_bins + 1)
        centers = (edges[:-1] + edges[1:]) / 2.0
        inds = np.digitize(conf, edges[1:-1], right=False)
        bin_acc = np.zeros(num_bins)
        bin_conf = np.zeros(num_bins)
        bin_count = np.zeros(num_bins, dtype=np.int64)
        for b in range(num_bins):
            sel = inds == b
            if sel.any():
                bin_count[b] = sel.sum()
                bin_conf[b] = conf[sel].mean()
                bin_acc[b] = (preds[sel] == targs[sel]).mean()
        nonempty = bin_count > 0
        ece = (float(np.sum(np.abs(bin_acc[nonempty] - bin_conf[nonempty])
                            * bin_count[nonempty] / bin_count[nonempty].sum()))
               if nonempty.any() else 0.0)
        plt.figure(figsize=(6, 6))
        plt.bar(centers, bin_acc, width=1.0 / num_bins * 0.9, align="center",
                edgecolor="black", linewidth=0.5, alpha=0.8, label="Accuracy")
        plt.plot([0, 1], [0, 1], linestyle="--", linewidth=1.0,
                 label="Perfect calibration")
        plt.scatter(centers[nonempty], bin_conf[nonempty], marker="o", s=20,
                    label="Mean confidence")
        plt.xlim(0, 1)
        plt.ylim(0, 1)
        plt.xlabel("Confidence")
        plt.ylabel("Accuracy")
        plt.title(f"Reliability Diagram (ECE = {ece:.3f})")
        plt.legend(loc="lower right")
        plt.grid(True, linestyle=":", linewidth=0.5)
        if save_path is not None:
            Path(save_path).parent.mkdir(parents=True, exist_ok=True)
            plt.tight_layout()
            plt.savefig(save_path, dpi=200)
        plt.close()


def per_bin_accuracy(
    confidences: np.ndarray,
    predictions: np.ndarray,
    labels: np.ndarray,
    num_bins: int,
) -> Tuple[List[float], List[Optional[float]]]:
    """Upper bin edges rounded to 2 places, and the accuracy per bin
    rounded to 4 (None for an empty bin): the reference's report format."""
    conf = np.clip(np.asarray(confidences, dtype=np.float64), 0.0, 1.0)
    preds = np.asarray(predictions).astype(np.int64)
    targs = np.asarray(labels).astype(np.int64)
    edges = np.linspace(0.0, 1.0, num_bins + 1)
    idx = np.clip(np.searchsorted(edges, conf, side="right") - 1, 0, num_bins - 1)
    bins_out = [round(float(edges[i + 1]), 2) for i in range(num_bins)]
    correct = preds == targs
    acc_out: List[Optional[float]] = []
    for b in range(num_bins):
        sel = idx == b
        acc_out.append(round(float(correct[sel].mean()), 4) if sel.any() else None)
    return bins_out, acc_out


def compute_calibration_metrics(
    logits: np.ndarray, labels: np.ndarray, num_bins: int = 15
) -> Dict[str, float]:
    """ECE/MCE/NLL/accuracy from aggregated logits."""
    probs = _softmax(np.asarray(logits, dtype=np.float64))
    confs = probs.max(axis=-1)
    preds = probs.argmax(axis=-1)
    labels = np.asarray(labels).astype(np.int64)
    return {
        "ece": CalibrationMetrics.expected_calibration_error(
            confs, preds, labels, num_bins
        ),
        "mce": CalibrationMetrics.maximum_calibration_error(
            confs, preds, labels, num_bins
        ),
        "nll": CalibrationMetrics.negative_log_likelihood(logits, labels),
        "accuracy": float((preds == labels).mean()) if len(labels) else 0.0,
    }


def compute_calibration_metrics_over_loader(
    forward_fn: Callable,
    loader: Iterable,
    num_bins: int = 15,
) -> Dict[str, float]:
    """The calibration metrics of a whole split: ``forward_fn(features,
    mask) -> logits`` (e.g. ``functools.partial(training.steps.forward,
    model)``; a tuple gives its first element) over the ``(features,
    labels, mask)`` batches of ``loader``, padding rows (mask all 0)
    dropped."""
    logits_all, labels_all = [], []
    for features, labels, mask in loader:
        logits = forward_fn(features, mask)
        if isinstance(logits, tuple):
            logits = logits[0]
        valid = np.asarray(mask.cpu()).max(axis=1) > 0
        logits_all.append(np.asarray(logits.float().cpu())[valid])
        labels_all.append(np.asarray(labels)[valid])
    if not logits_all:
        return {"ece": 0.0, "mce": 0.0, "nll": 0.0, "accuracy": 0.0}
    return compute_calibration_metrics(
        np.concatenate(logits_all), np.concatenate(labels_all), num_bins)
