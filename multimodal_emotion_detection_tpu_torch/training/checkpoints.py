"""The port's checkpoints, top-k / last / best bookkeeping and early stopping.

A checkpoint is ``torch.save({"state_dict", "meta"[, "optimizer"]})``:
the model's weights, plain metadata (epoch, step, val_loss: numbers and
strings) and, for a training checkpoint, the optimizer's state.  Every
part is tensors and plain values, so the file loads with
``weights_only=True`` and unpickles no arbitrary objects; the predict CLI
reads ``state_dict`` and ``meta`` of any of them.  A JSON sidecar
``<name>.json`` repeats ``meta``, as the JAX package writes one.

``CheckpointManager`` and ``EarlyStopping`` keep the JAX package's
contract: monitor ``val/loss`` (min), keep ``save_top_k`` files named
``epoch={e}-val_loss={v:.4f}.ckpt``, refresh ``last.ckpt`` on every
validation, recover the kept set from disk after a resume, copy the best
to ``best.ckpt`` at the end; patience counts validation checks.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: Path, state_dict: Dict[str, torch.Tensor],
                    meta: Dict[str, Any],
                    optimizer: Optional[Dict[str, Any]] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = {"state_dict": _to_cpu(state_dict), "meta": dict(meta)}
    if optimizer is not None:
        blob["optimizer"] = _to_cpu(optimizer)
    torch.save(blob, path)
    path.with_name(path.name + ".json").write_text(json.dumps(meta, indent=2))


def load_checkpoint(path: Path) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    blob = load_training_checkpoint(path)
    return blob["state_dict"], blob["meta"]


def load_training_checkpoint(path: Path) -> Dict[str, Any]:
    """The whole checkpoint: state_dict, meta and, if saved, optimizer."""
    return torch.load(Path(path), map_location="cpu", weights_only=True)


class CheckpointManager:
    """Top-k checkpoints by the lowest ``val/loss``, plus ``last.ckpt``."""

    def __init__(self, dirpath: Path, save_top_k: int = 1):
        self.dirpath = Path(dirpath)
        self.dirpath.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k
        # (metric, path) of currently-kept top-k checkpoints, best first
        self._kept: List[Tuple[float, Path]] = []
        self.best_model_path: Optional[Path] = None
        self.best_model_score: float = np.inf
        self._recover_kept()

    def _recover_kept(self) -> None:
        """Rebuild the top-k set from existing ``epoch=*-val_loss=*.ckpt``
        files, so a resumed run keeps pruning them and remembers its best."""
        for path in self.dirpath.glob("epoch=*-val_loss=*.ckpt"):
            try:
                metric = float(path.stem.split("val_loss=")[1])
            except (IndexError, ValueError):
                continue
            self._kept.append((metric, path))
        self._kept.sort(key=lambda kv: kv[0])
        if self._kept:
            self.best_model_score, self.best_model_path = self._kept[0]

    def on_epoch_end(self, state_dict: Dict[str, torch.Tensor],
                     optimizer: Dict[str, Any], epoch: int, step: int,
                     monitor_value: float) -> None:
        meta = {"epoch": int(epoch), "step": int(step),
                "val_loss": float(monitor_value)}
        save_checkpoint(self.dirpath / "last.ckpt", state_dict, meta, optimizer)

        if self.save_top_k == 0:
            return
        should_keep = (len(self._kept) < self.save_top_k
                       or monitor_value < self._kept[-1][0])
        if not should_keep:
            return
        path = self.dirpath / f"epoch={epoch}-val_loss={monitor_value:.4f}.ckpt"
        save_checkpoint(path, state_dict, meta, optimizer)
        # the 4-decimal filename can collide with a recovered entry (e.g.
        # resuming a deterministic run): REPLACE it, or the duplicate-path
        # pair gets pruned and deletes the file the kept entry points to
        self._kept = [(m, p) for m, p in self._kept if p != path]
        self._kept.append((float(monitor_value), path))
        self._kept.sort(key=lambda kv: kv[0])
        while len(self._kept) > self.save_top_k:
            _, drop = self._kept.pop()
            if any(p == drop for _, p in self._kept):
                continue  # another kept entry still references this file
            drop.unlink(missing_ok=True)
            drop.with_name(drop.name + ".json").unlink(missing_ok=True)
        if monitor_value < self.best_model_score:
            self.best_model_score = float(monitor_value)
            self.best_model_path = path

    def copy_best(self, target: Path) -> Optional[Path]:
        if self.best_model_path and self.best_model_path.exists():
            target = Path(target)
            shutil.copy(str(self.best_model_path), str(target))
            shutil.copy(str(self.best_model_path) + ".json", str(target) + ".json")
            return target
        return None

    def latest(self) -> Optional[Path]:
        last = self.dirpath / "last.ckpt"
        return last if last.exists() else None


class EarlyStopping:
    """Stop once val/loss has not fallen for ``patience`` validation checks."""

    def __init__(self, patience: int = 10):
        self.patience = patience
        self.best = np.inf
        self.wait = 0
        self.stopped = False

    def update(self, value: float) -> bool:
        """Returns True if training should stop."""
        if value < self.best:
            self.best = float(value)
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
        return self.stopped
