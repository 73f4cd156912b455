"""Calibration metrics: ECE / MCE / NLL / accuracy, on host-side logits.

Uniform bins over [0, 1], the right edge included only in the last bin;
ECE = sum over non-empty bins of |accuracy - confidence| * n_bin / N.
Numpy, in float64: these run once over a split's aggregated logits.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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
