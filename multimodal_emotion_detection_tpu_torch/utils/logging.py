"""Metric logging (CSV with the reference's schema, optional TensorBoard)
and the step timer.

The CSV keeps the JAX package's columns and row cadence (``train/loss``,
``val/acc``, ``lr-<Optimizer>``, ``epoch``, ``step`` ...), so its curves
diff directly against the JAX run's.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Dict, Optional

import torch


class CSVLogger:
    """Append-style CSV metrics logger with a stable, growing column set."""

    def __init__(self, save_dir: str | Path, name: str = "csv_logs"):
        root = Path(save_dir) / name
        version = 0
        while (root / f"version_{version}").exists():
            version += 1
        self.log_dir = root / f"version_{version}"
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / "metrics.csv"
        self._rows: list[Dict[str, object]] = []
        self._columns: list[str] = []

    def log_metrics(self, metrics: Dict[str, float], step: int,
                    epoch: Optional[int] = None) -> None:
        """Append one (possibly sparse) row; ``epoch=None`` leaves the
        epoch cell empty, as the reference's learning-rate rows do.  The
        file is rewritten in full only when the column set grows."""
        row: Dict[str, object] = {"step": step}
        if epoch is not None:
            row["epoch"] = epoch
        for key, value in metrics.items():
            row[key] = float(value)
        new_columns = [key for key in row if key not in self._columns]
        self._rows.append(row)
        if new_columns or not self._rows[:-1]:
            self._columns.extend(new_columns)
            with open(self.path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._columns)
                writer.writeheader()
                writer.writerows(self._rows)
        else:
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._columns).writerow(row)


class TensorBoardLogger:
    """Thin TensorBoard event writer; a no-op where tensorboard is not
    installed."""

    def __init__(self, save_dir: str | Path, name: str = "tb_logs"):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._writer = None
            return
        root = Path(save_dir) / name
        version = 0
        while (root / f"version_{version}").exists():
            version += 1
        self._writer = SummaryWriter(log_dir=str(root / f"version_{version}"))

    def log_metrics(self, metrics: Dict[str, float], step: int,
                    epoch: Optional[int] = None) -> None:
        if self._writer is None:
            return
        for key, value in metrics.items():
            self._writer.add_scalar(key, float(value), global_step=step)


class StepTimer:
    """Wall-clock time of a stretch of training.  On a CUDA device both
    ends synchronise it, so the time is the card's work and not only its
    enqueueing."""

    def __init__(self, device: torch.device = torch.device("cpu")) -> None:
        self.device = torch.device(device)
        self._start: Optional[float] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._start = time.perf_counter()

    def stop(self) -> float:
        """Seconds since ``start``."""
        if self._start is None:
            raise RuntimeError("StepTimer.stop without start")
        self._sync()
        dt = time.perf_counter() - self._start
        self._start = None
        return dt
