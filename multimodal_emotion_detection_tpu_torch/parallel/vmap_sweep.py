"""Hyperparameter sweeps and ensembles: G members trained side by side on
the same batches.

The JAX package stacks G parameter sets along a leading axis and vmaps one
train step over them (switching its TPU kernels off to do so).
``torch.func.vmap`` cannot batch the port's kernel launches, and members
with different weights cannot share a launch, so the port's step is
step-major: the batch is gathered once, then each member runs its own
forward, backward and update through the kernels, one after another (the
same idiom as ``uncertainty/ensemble.py``).  A member is an ``nn.Module``
with its own AdamW state and, for BatchNorm encoders, its own running
statistics.

Members see the same batch and the same random draws: step ``s`` draws
from a generator on the device seeded with ``training/loop.py``'s
``step_seed(seed, s)``, first the (B, M) uniforms and the (B,) fallback
index of the modality-dropout mask, which every member thresholds at its
own probability (``modality_dropout_mask_from_uniforms``: a higher
probability drops a superset, the JAX grid's monotone coupling), then the
first member's dropout masks, which the others replay (``Noise(replay=)``).
Member ``i`` starts from ``init_weights`` seeded with ``step_seed(seed,
i)``; ``member_ids`` lets a standalone run reproduce a stacked member bit
for bit.

The update is the JAX sweep's: global-norm clip (``training/optim.py``'s
float64 norm), Adam, then ``p <- p - lr * (adam_dir + wd * p)`` at a
constant per-member lr (torch's AdamW), with no schedule and no
per-member early stopping.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from multimodal_emotion_detection_tpu_torch.data.masking import (
    modality_dropout_mask_from_uniforms,
)
from multimodal_emotion_detection_tpu_torch.models.classifier import init_weights
from multimodal_emotion_detection_tpu_torch.models.noise import Noise
from multimodal_emotion_detection_tpu_torch.training.loop import step_seed
from multimodal_emotion_detection_tpu_torch.training.steps import (
    cross_entropy,
    eval_sums,
    optimizer_update,
)
from multimodal_emotion_detection_tpu_torch.uncertainty.ensemble import stack_params


@dataclass
class SweepState:
    step: int  # shared global step
    members: List[nn.Module]
    optimizers: List[torch.optim.Optimizer]
    lrs: List[float]
    # per-member modality-dropout probability (the grid's mDrop axis);
    # None -> the shared value passed to make_vmapped_train_step
    mdrops: Optional[List[float]] = None


def init_sweep_state(
    model: nn.Module,
    lrs: Sequence[float],
    seed: int,
    mdrops: Optional[Sequence[float]] = None,
    member_ids: Optional[Sequence[int]] = None,
    device: Optional[torch.device] = None,
) -> SweepState:
    """G = len(lrs) copies of ``model``'s architecture, member ``i`` with
    ``init_weights`` seeded by ``step_seed(seed, member_ids[i])`` (default
    ``i``), on ``device`` (default: ``model``'s), each with a fresh AdamW
    state."""
    ids = list(member_ids) if member_ids is not None else list(range(len(lrs)))
    if len(ids) != len(lrs) or (mdrops is not None and len(mdrops) != len(lrs)):
        raise ValueError("lrs, mdrops and member_ids need one entry per member")
    if device is None:
        device = next(model.parameters()).device
    template = copy.deepcopy(model).to("cpu")
    members, optimizers = [], []
    for i in ids:
        member = init_weights(copy.deepcopy(template),
                              torch.Generator().manual_seed(step_seed(seed, i)))
        member = member.to(device)
        members.append(member)
        # lr and weight decay are set by the step
        optimizers.append(torch.optim.AdamW(member.parameters(), lr=0.0,
                                            betas=(0.9, 0.999), eps=1e-8,
                                            weight_decay=0.0))
    return SweepState(step=0, members=members, optimizers=optimizers,
                      lrs=[float(lr) for lr in lrs],
                      mdrops=None if mdrops is None else [float(p) for p in mdrops])


def make_vmapped_train_step(
    num_modalities: int,
    modality_dropout: float,
    clip_norm: float,
    weight_decay: float,
    scan_epoch: bool = False,
) -> Callable:
    """``(state, features, labels, idx, valid, seed) -> metrics``: one step
    of every member on the batch ``idx`` (B,) of the resident split
    (``valid`` (B,) marks real rows), updating ``state`` in place; metrics
    ``loss`` and ``acc`` are (G,) tensors on the device.  With
    ``scan_epoch`` it takes (S, B) ``idx`` / ``valid`` and runs the S
    steps, one a dispatch (metrics (S, G)), as the Trainer's
    ``epoch_scan`` is accepted and steps once a dispatch."""

    def step(state: SweepState, features, labels, idx, valid, seed: int):
        device = valid.device
        gen = torch.Generator(device=device).manual_seed(step_seed(seed, state.step))
        b = idx.shape[0]
        batch = {m: a.index_select(0, idx) for m, a in features.items()}
        batch_labels = labels.index_select(0, idx)
        first = Noise(gen)
        uniforms = first.draw(lambda g: torch.rand(
            (b, num_modalities), generator=g, device=device), device)
        fallback = first.draw(lambda g: torch.randint(
            0, num_modalities, (b,), generator=g, device=device), device)
        losses, accs, replay = [], [], []
        for i, (member, opt, lr) in enumerate(zip(state.members, state.optimizers,
                                                  state.lrs)):
            p = state.mdrops[i] if state.mdrops is not None else modality_dropout
            mask = modality_dropout_mask_from_uniforms(uniforms, fallback, p)
            mask = mask * valid[:, None]
            member.train()
            logits = member(batch, mask, noise=first if i == 0 else Noise(replay=replay))
            if i == 0:
                replay = first.drawn[2:]
            loss = cross_entropy(logits, batch_labels, valid)
            opt.zero_grad()
            loss.backward()
            for group in opt.param_groups:
                group["weight_decay"] = weight_decay
            optimizer_update(opt, lr, clip_norm)
            with torch.no_grad():
                correct = (logits.argmax(dim=-1) == batch_labels) * valid
                accs.append(correct.sum() / valid.sum().clamp(min=1.0))
            losses.append(loss.detach())
        state.step += 1
        return {"loss": torch.stack(losses), "acc": torch.stack(accs)}

    if not scan_epoch:
        return step

    def epoch(state: SweepState, features, labels, idx, valid, seed: int):
        per_step = [step(state, features, labels, idx[s], valid[s], seed)
                    for s in range(idx.shape[0])]
        return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return epoch


def make_vmapped_eval_step() -> Callable:
    """``(members, features, labels, idx, valid) -> sums``: every member's
    deterministic forward on the batch ``idx``, every modality available;
    ``loss_sum``, ``correct_sum`` and ``count`` as (G,) tensors."""

    def step(members: Sequence[nn.Module], features, labels, idx, valid):
        sums = [eval_sums(member, features, labels, idx, valid)[0] for member in members]
        return {k: torch.stack([s[k] for s in sums])
                for k in ("loss_sum", "correct_sum", "count")}

    return step


def member_params(state: SweepState, i: int) -> Dict[str, torch.Tensor]:
    """Member ``i``'s ``state_dict`` (parameters and buffers), copied."""
    return {k: v.detach().clone() for k, v in state.members[i].state_dict().items()}


def stacked_state_dict(state: SweepState) -> Dict[str, torch.Tensor]:
    """Every member's ``state_dict`` stacked along a leading member axis,
    as ``uncertainty.ensemble.ensemble_predict`` takes it."""
    return stack_params([member.state_dict() for member in state.members])


def _train_members(model, train_loader, val_loader, lrs, epochs, modality_dropout,
                   clip_norm, weight_decay, seed, mdrops=None, member_ids=None):
    """Train the members for ``epochs``; returns ``(state, history)``,
    history one {val_loss, val_acc: (G,)} per epoch (empty without a
    ``val_loader``)."""
    feats, labels = train_loader.device_arrays()
    device = labels.device
    m = train_loader.arrays.num_modalities
    state = init_sweep_state(model, lrs, seed, mdrops=mdrops,
                             member_ids=member_ids, device=device)
    train_epoch = make_vmapped_train_step(m, modality_dropout, clip_norm,
                                          weight_decay, scan_epoch=True)
    eval_step = make_vmapped_eval_step()

    def on_device(a, dtype):
        return torch.from_numpy(a.astype(dtype)).to(device)

    history = []
    for epoch in range(epochs):
        train_epoch(state, feats, labels,
                    on_device(train_loader.epoch_batch_indices(epoch), np.int64),
                    on_device(train_loader.epoch_batch_valid(), np.float32), seed)
        if val_loader is None:
            continue
        vfeats, vlabels = val_loader.device_arrays()
        vidx = on_device(val_loader.epoch_batch_indices(0), np.int64)
        vvalid = on_device(val_loader.epoch_batch_valid(), np.float32)
        totals = None
        for bi in range(vidx.shape[0]):
            sums = eval_step(state.members, vfeats, vlabels, vidx[bi], vvalid[bi])
            totals = sums if totals is None else {k: totals[k] + v for k, v in sums.items()}
        totals = {k: v.cpu().numpy().astype(np.float64) for k, v in totals.items()}
        count = np.maximum(totals["count"], 1)
        history.append({"val_loss": totals["loss_sum"] / count,
                        "val_acc": totals["correct_sum"] / count})
    return state, history


def _summaries(history, g: int) -> List[Dict[str, float]]:
    results = []
    for i in range(g):
        curve = [float(h["val_loss"][i]) for h in history]
        best_epoch = int(np.argmin(curve))
        results.append({
            "best_val_loss": curve[best_epoch],
            "best_epoch": best_epoch,
            "final_val_acc": float(history[-1]["val_acc"][i]),
        })
    return results


def vmapped_lr_sweep(
    model: nn.Module,
    train_loader,
    val_loader,
    lrs: Sequence[float],
    epochs: int,
    modality_dropout: float = 0.0,
    clip_norm: float = 1.0,
    weight_decay: float = 1e-4,
    seed: int = 42,
) -> List[Dict[str, float]]:
    """Train one member per lr; returns per-member best-val summaries
    (every member runs the whole epoch budget)."""
    _, history = _train_members(model, train_loader, val_loader, lrs, epochs,
                                modality_dropout, clip_norm, weight_decay, seed)
    return [{"learning_rate": float(lr), **r}
            for lr, r in zip(lrs, _summaries(history, len(lrs)))]


def vmapped_grid_sweep(
    model_factory: Callable[[float], nn.Module],
    train_loader,
    val_loader,
    lrs: Sequence[float],
    model_dropouts: Sequence[float],
    modality_dropouts: Sequence[float],
    epochs: int,
    clip_norm: float = 1.0,
    weight_decay: float = 1e-4,
    seed: int = 42,
) -> List[Dict[str, float]]:
    """The reference's grid as one program per model dropout (the rate is
    the model's, ``model_factory(model_dropout) -> model``), each over its
    lr x modality-dropout members (member id = position in that order).
    Returns one summary per grid member with its hyperparameters."""
    results: List[Dict[str, float]] = []
    for model_dropout in model_dropouts:
        members = [(lr, md) for lr in lrs for md in modality_dropouts]
        _, history = _train_members(
            model_factory(model_dropout), train_loader, val_loader,
            [lr for lr, _ in members], epochs, 0.0, clip_norm, weight_decay, seed,
            mdrops=[md for _, md in members])
        for (lr, md), r in zip(members, _summaries(history, len(members))):
            r.update({"learning_rate": float(lr),
                      "model_dropout": float(model_dropout),
                      "modality_dropout": float(md)})
            results.append(r)
    return results


def train_ensemble(
    model: nn.Module,
    train_loader,
    n_members: int,
    epochs: int,
    learning_rate: float = 1e-3,
    modality_dropout: float = 0.0,
    clip_norm: float = 1.0,
    weight_decay: float = 1e-4,
    seed: int = 42,
) -> Dict[str, torch.Tensor]:
    """Train ``n_members`` independently initialised members at one lr;
    returns their stacked ``state_dict``, which
    ``uncertainty.ensemble.ensemble_predict`` takes."""
    state, _ = _train_members(model, train_loader, None, [learning_rate] * n_members,
                              epochs, modality_dropout, clip_norm, weight_decay, seed)
    return stacked_state_dict(state)
