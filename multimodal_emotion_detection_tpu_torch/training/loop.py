"""Epoch loop: fit / validate / test with early stopping and checkpoints.

The port of the JAX package's ``Trainer`` on its per-step path: the train
split lives on the device, the host sends one (B,) index row per step, and
metric values come back once per epoch, so the steps queue up on the card
without a host round trip.  With ``dataset.device_resident=false`` each
batch is instead copied to the device as its step needs it
(``MultimodalLoader.stream``: the same batches in the same order, gathered
on the host, and an identity gather in the step), and the split is never
placed whole; the steps still queue without a host round trip.
Validation follows the JAX cadence (``training.val_every_n_epochs``, the
last epoch always validates); the CSV rows, checkpoint names and
early-stopping rule are the JAX package's.  ``runtime.profile_dir`` traces
the training steps of epoch ``min(1, max_epochs - 1)`` with
``torch.profiler`` (host and, on the card, device activity) and writes the
trace there as ``trace_epoch<e>.json`` (Chrome trace format).

Randomness: step ``s`` draws its modality and dropout masks from a
generator on the device seeded with ``seed * 1_000_003 + s``, a pure
function of the seed and the global step (the JAX package folds the step
into its key), so a resumed run repeats an uninterrupted one.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.data.loader import MultimodalLoader
from multimodal_emotion_detection_tpu_torch.models.classifier import (
    classifier_from_config,
    init_weights,
    logmel_params_from_config,
)
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.ops.logmel import (
    log_mel_spectrogram,
    mfcc,
)
from multimodal_emotion_detection_tpu_torch.training.checkpoints import (
    CheckpointManager,
    EarlyStopping,
    load_training_checkpoint,
)
from multimodal_emotion_detection_tpu_torch.training.optim import build_optimizer
from multimodal_emotion_detection_tpu_torch.training.steps import (
    eval_sums,
    train_step,
)
from multimodal_emotion_detection_tpu_torch.utils.logging import (
    CSVLogger,
    StepTimer,
    TensorBoardLogger,
)
from multimodal_emotion_detection_tpu_torch.utils.runtime import (
    device_from_config,
)

FRONTEND_CHUNK = 128  # clips per log-mel call when caching a split


def refuse_outside_slice(config) -> None:
    """Raise ``NotImplementedError`` naming the ``ROADMAP.md`` item for a
    training configuration the port does not run yet."""
    for name, cfg in dict(config.model.encoders).items():
        if dict(cfg).get("weights_path"):
            raise NotImplementedError(
                f"model.encoders.{name}.weights_path: pretrained encoder "
                "weights, with the image CNN they load into, are not ported "
                "yet (ROADMAP.md Queue 1 item 8)")


def step_seed(seed: int, step: int) -> int:
    return (int(seed) * 1_000_003 + int(step)) % (2**63)


class Trainer:
    def __init__(self, config, model: Optional[nn.Module] = None,
                 save_dir: Optional[Path] = None):
        refuse_outside_slice(config)
        self.config = config
        self.device = device_from_config(config)
        if model is None:
            model = init_weights(classifier_from_config(config),
                                 torch.Generator().manual_seed(config.seed))
        self.model = model.to(self.device)
        self.save_dir = Path(
            save_dir if save_dir is not None
            else Path(config.experiment.save_dir) / config.experiment.name)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.csv_logger = CSVLogger(self.save_dir)
        self.tb_logger = TensorBoardLogger(self.save_dir)
        self.checkpoints = CheckpointManager(
            self.save_dir / "checkpoints", save_top_k=config.experiment.save_top_k)
        self.early_stopping = EarlyStopping(
            patience=config.training.early_stopping_patience)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self._schedule = None
        self.step = 0
        self._opt_name = "AdamW" if config.training.optimizer == "adamw" else "Adam"
        self.timer = StepTimer(self.device)
        self.history: list[Dict[str, float]] = []

    # ------------------------------------------------------------------
    def _build(self, train_loader: MultimodalLoader) -> None:
        self._maybe_cache_frontend(train_loader)
        self.optimizer, self._schedule = build_optimizer(
            self.config.training, self.model.parameters(), len(train_loader))

    def _maybe_cache_frontend(self, loader: MultimodalLoader) -> None:
        """``frontend.cache=true``: replace a split's raw audio (N, 48000, 1)
        by its features (N, F, n_mels), computed once on the device in
        chunks of ``FRONTEND_CHUNK`` clips through the frontend kernel.
        The frontend has no parameters, so this equals running it in every
        step."""
        fe = self.config.model.frontend
        if (not fe.cache or fe.audio not in ("logmel", "mfcc")
                or loader.frontend_cached or "audio" not in loader.arrays.features):
            return
        params = logmel_params_from_config(fe)
        raw = loader.arrays.features["audio"]
        outs = []
        with torch.inference_mode():
            for i in range(0, raw.shape[0], FRONTEND_CHUNK):
                wave = torch.from_numpy(np.ascontiguousarray(
                    raw[i:i + FRONTEND_CHUNK])).to(self.device)
                feats = (mfcc(wave, params, n_mfcc=fe.n_mfcc) if fe.audio == "mfcc"
                         else log_mel_spectrogram(wave, params))
                outs.append(feats.cpu().numpy())
        loader.replace_features("audio", np.concatenate(outs, axis=0))
        loader.frontend_cached = True

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    def _place(self, loader: MultimodalLoader, epoch: int
               ) -> Tuple[np.ndarray, Optional[torch.Tensor], torch.Tensor]:
        """An epoch's valid rows, on the host and on the device, and its
        index rows on the device (None for a streamed split)."""
        valid = loader.epoch_batch_valid()
        idx = (torch.from_numpy(loader.epoch_batch_indices(epoch).astype(np.int64))
               .to(self.device) if loader.device_resident else None)
        return valid, idx, torch.from_numpy(valid).to(self.device)

    def _batches(self, loader: MultimodalLoader, epoch: int,
                 idx_dev: Optional[torch.Tensor]
                 ) -> Iterator[Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]]:
        """``(features, labels, idx)`` per batch of ``epoch``: the resident
        split and the batch's index row, or the streamed batch and the
        identity gather (as the JAX package's host-streaming path)."""
        if loader.device_resident:
            feats, labels = loader.device_arrays()
            for b in range(idx_dev.shape[0]):
                yield feats, labels, idx_dev[b]
        else:
            identity = torch.arange(loader.batch_size, device=self.device)
            for feats, labels in loader.stream(epoch):
                yield feats, labels, identity

    def _train_epoch(self, loader: MultimodalLoader, epoch: int,
                     idx_dev: Optional[torch.Tensor], valid_dev: torch.Tensor,
                     generator: torch.Generator) -> List[Dict[str, torch.Tensor]]:
        """The train steps of one epoch, queued without a host round trip;
        their metrics stay on the device."""
        cfg = self.config
        per_step = []
        for b, (feats, labels, idx) in enumerate(self._batches(loader, epoch, idx_dev)):
            generator.manual_seed(step_seed(cfg.seed, self.step))
            per_step.append(train_step(
                self.model, self.optimizer, feats, labels, idx, valid_dev[b],
                lr=self._schedule(self.step),
                clip_norm=float(cfg.training.gradient_clip_norm),
                modality_dropout=float(cfg.training.augmentation.modality_dropout),
                noise=Noise(generator)))
            self.step += 1
        return per_step

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_trace(self, prof, epoch: int) -> None:
        prof.stop()
        out = Path(self.config.runtime.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"trace_epoch{epoch}.json"
        prof.export_chrome_trace(str(path))
        print(f"Wrote the epoch {epoch} trace to {path}")

    # ------------------------------------------------------------------
    def fit(self, train_loader: MultimodalLoader, val_loader: MultimodalLoader,
            resume: bool = False) -> nn.Module:
        cfg = self.config
        self._maybe_cache_frontend(train_loader)
        self._maybe_cache_frontend(val_loader)
        if self.optimizer is None:
            self._build(train_loader)
        start_epoch = 0
        if resume:
            last = self.checkpoints.latest()
            if last is not None:
                blob = load_training_checkpoint(last)
                self.model.load_state_dict(blob["state_dict"])
                self.optimizer.load_state_dict(blob["optimizer"])
                self.step = int(blob["meta"]["step"])
                start_epoch = int(blob["meta"]["epoch"]) + 1
                print(f"Resumed from {last} at epoch {start_epoch}")

        generator = torch.Generator(device=self.device)
        val_every = max(1, int(cfg.training.val_every_n_epochs))
        log_n = int(cfg.experiment.log_every_n_steps or 0)
        trace_epoch = min(1, cfg.training.max_epochs - 1)

        def is_val_e(e):
            # validation cadence anchored at start_epoch; the final epoch
            # always validates so a best checkpoint exists
            return ((e - start_epoch + 1) % val_every == 0
                    or e == cfg.training.max_epochs - 1)

        for epoch in range(start_epoch, cfg.training.max_epochs):
            valid_np, idx_dev, valid_dev = self._place(train_loader, epoch)
            epoch_start_step = self.step
            self.timer.start()
            prof = (self._start_trace()
                    if cfg.runtime.profile_dir and epoch == trace_epoch else None)
            per_step = self._train_epoch(train_loader, epoch, idx_dev, valid_dev,
                                         generator)
            stacked = {k: torch.stack([m[k] for m in per_step]).cpu().numpy()
                       for k in per_step[0]}
            if prof is not None:
                self._stop_trace(prof, epoch)
            epoch_time = self.timer.stop()

            # sample-weighted epoch means (wrap-padded batches)
            weights = np.maximum(stacked["count"], 1e-9)
            weights = weights / weights.sum()
            train_row = {
                f"train/{k}": float(np.sum(stacked[k] * weights))
                for k in ("loss", "acc", "confidence_mean")
            }
            is_val_epoch = is_val_e(epoch)
            val_row = self.validate(val_loader, prefix="val") if is_val_epoch else {}

            # CSV rows in the reference's Lightning cadence: an lr row at
            # the epoch's first global step (epoch cell empty), optional
            # '*_step' rows every log_every_n_steps, then a val row (val
            # epochs) and a train row at the epoch's last global step
            lr_start = float(self._schedule(epoch_start_step))
            self.csv_logger.log_metrics({f"lr-{self._opt_name}": lr_start},
                                        step=epoch_start_step)
            if log_n > 0:
                for s in range(len(per_step)):
                    g = epoch_start_step + s
                    if (g + 1) % log_n == 0:
                        self.csv_logger.log_metrics(
                            {"train/loss_step": float(stacked["loss"][s]),
                             "train/acc_step": float(stacked["acc"][s])},
                            step=g, epoch=epoch)
            if val_row:
                self.csv_logger.log_metrics(val_row, step=self.step - 1, epoch=epoch)
            clips_per_sec = float(valid_np.sum()) / epoch_time if epoch_time > 0 else 0.0
            perf_row = {**train_row, "train/clips_per_sec": clips_per_sec}
            self.csv_logger.log_metrics(perf_row, step=self.step - 1, epoch=epoch)

            row = {**train_row, **val_row, f"lr-{self._opt_name}": lr_start,
                   "train/clips_per_sec": clips_per_sec}
            self.tb_logger.log_metrics(row, step=self.step, epoch=epoch)
            self.history.append({"epoch": epoch, **row})
            val_str = (f"val_loss {row['val/loss']:.4f} val_acc {row['val/acc']:.4f}"
                       if val_row else "val --")
            print(f"epoch {epoch:3d} | loss {row['train/loss']:.4f} "
                  f"acc {row['train/acc']:.4f} | {val_str} | "
                  f"{clips_per_sec:.1f} clips/s")

            # checkpoint + early stop on val/loss; patience counts
            # validation checks
            if is_val_epoch:
                self.checkpoints.on_epoch_end(
                    self.model.state_dict(), self.optimizer.state_dict(),
                    epoch, self.step, row["val/loss"])
                if self.early_stopping.update(row["val/loss"]):
                    print(f"Early stopping at epoch {epoch} (patience "
                          f"{cfg.training.early_stopping_patience})")
                    break
        return self.model

    # ------------------------------------------------------------------
    def validate(self, loader: MultimodalLoader, prefix: str = "val",
                 model: Optional[nn.Module] = None) -> Dict[str, float]:
        sums, _ = self._run_eval(loader, model=model, collect=False)
        count = max(sums["count"], 1.0)
        return {
            f"{prefix}/loss": sums["loss_sum"] / count,
            f"{prefix}/acc": sums["correct_sum"] / count,
            f"{prefix}/confidence_mean": sums["conf_sum"] / count,
            f"{prefix}/entropy": sums["entropy_sum"] / count,
        }

    def test(self, loader: MultimodalLoader, model: Optional[nn.Module] = None
             ) -> Tuple[Dict[str, float], np.ndarray, np.ndarray, np.ndarray]:
        """Returns (metrics, logits, preds, labels) over the full split."""
        sums, (logits, labels) = self._run_eval(loader, model=model, collect=True)
        count = max(sums["count"], 1.0)
        preds = logits.argmax(-1)
        metrics = {
            "test/loss": sums["loss_sum"] / count,
            "test/acc": sums["correct_sum"] / count,
            "test/acc_agg": float((preds == labels).mean()),
        }
        return metrics, logits, preds, labels

    def _run_eval(self, loader: MultimodalLoader, model=None, collect=False):
        model = model if model is not None else self.model
        self._maybe_cache_frontend(loader)
        valid_np, idx_dev, valid_dev = self._place(loader, 0)
        totals = None
        logits_list, labels_list = [], []
        for b, (feats, labels, idx) in enumerate(self._batches(loader, 0, idx_dev)):
            sums, logits, batch_labels = eval_sums(model, feats, labels, idx,
                                                   valid_dev[b])
            totals = sums if totals is None else {
                k: totals[k] + v for k, v in sums.items()}
            if collect:
                logits_list.append(logits)
                labels_list.append(batch_labels)
        totals = {k: float(v) for k, v in totals.items()}
        if not collect:
            return totals, None
        keep = valid_np.reshape(-1).astype(bool)
        return totals, (torch.cat(logits_list).float().cpu().numpy()[keep],
                        torch.cat(labels_list).cpu().numpy()[keep])

    # ------------------------------------------------------------------
    def load_best(self) -> nn.Module:
        """A copy of the model holding the best checkpoint's weights (the
        model itself if no checkpoint was kept)."""
        best = self.checkpoints.best_model_path
        if best is None:
            return self.model
        model = copy.deepcopy(self.model)
        model.load_state_dict(load_training_checkpoint(best)["state_dict"])
        return model
