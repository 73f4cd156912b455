"""Drive the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (name, count, nvidia-smi name and power limit).
2. Builds every CUDA kernel of both paths from ``csrc/`` (one nvcc per
   source, all at once) and prints ptxas's register / shared-memory /
   spill report.
3. Holds each serving kernel against its plain PyTorch version on the card
   at the shapes the serving path gives it (log-mel, one FFT a frame, at
   B=32 with hops 128 and 160 and at B=1; ``lstm2_infer``, on the 2-layer
   forward core, at B=32 and 1, each with its launch plan), and times
   kernel, plain version and, where one exists, the one PyTorch call
   computing the same function.
4. Serves: writes a 64-clip synthetic test split, builds the flagship
   (configs/base.yaml + model.frontend.audio=logmel) with seeded weights,
   saves a checkpoint and runs the port's predict CLI on it at batch 32.
   Every kernel's launch count is zeroed just before and read just after:
   log-mel and lstm2_infer must have run once per batch, the others never.
   The logits are checked
   against the model's own forward on the CPU, where every kernel wrapper
   runs its plain version.  Then the
   forward's latency at batch 32 and 1 (host clock) and, under
   torch.profiler, its device time by kernel and the device's busy share.
5. Holds the two training kernels (training forward with residuals, on
   the 2-layer forward core's training form; reverse dgates chain, on the
   2-layer reverse core) against their plain versions at the flagship's
   training shape (B=32, T=372, D=64, H=256, keep mask at dropout 0.1,
   each with its launch plan; the chain at B 17 and 1 too) and
   times them beside cuDNN's LSTM forward and backward, and the whole
   recurrence gradient beside cuDNN's forward + backward.  Then
   ``[lstm2_bwd_chain_remat]`` does the same for the gate-rematerialising
   pair (``runtime.lstm_remat_gates``: the forward's no-gates form, the
   reverse chain that recomputes the gates, the 2-layer reverse core's
   remat cell, its chain at B 17 and 1 too, and at B=512, past the rows
   whose gate blocks fit one launch, in slices of the batch, each with its
   launch plan),
   holds it against the stored-gates pair on the same inputs, and times
   and measures the peak memory of the whole recurrence gradient on both
   routes (the remat route's must be the lower).
6. Trains: writes synthetic train / val / test splits of 96 / 64 / 64
   full-width clips and runs the port's train CLI for 2 epochs at batch 32
   with seeded weights.  The launch counts are zeroed just before and read
   just after: the 2-layer training kernels once per train step,
   lstm2_infer once per eval batch, logmel once per both, the one-layer
   kernels never.  The artifacts must exist.  One
   train step on the card is held against the same step on the CPU (plain
   versions, same batch and masks); then the train step's latency at batch
   32 (host clock) and its device time by kernel under torch.profiler.
   ``[train_remat]`` does all of this again with
   ``runtime.lstm_remat_gates=true``: the no-gates forward and the remat
   chain once per train step, the stored-gates pair never.
7. The big sweep config (LSTM 3x512, output 256, head 512, video 512,
   log-mel cached per split; ``BIG``): holds the single-layer training
   forward, its eval form and the single-layer reverse chain against their
   plain versions at B=32, T=372, H=512 and times them beside cuDNN (each
   with its launch plan: units per CTA, cluster size, row groups, shared
   memory; the eval form's at B=1 too, and its B=1 time), and the whole
   3-layer recurrence gradient beside cuDNN's.
8. Trains the big config as in 6 (``[train_big]``): 3 training forwards and
   3 reverse chains per step, 3 eval-form launches per eval batch, log-mel
   once per split, and no launch of the 2-layer kernels; the card step
   against the CPU step; train-step latency and profile.  Then serves the
   trained ``best.ckpt`` through the predict CLI (``[serve_big]``: 3
   eval-form launches and 1 log-mel per batch), logits against the CPU
   forward, latency and profile.
9. The GRU audio encoder config (GRU 2x256, log-mel cached per split;
   ``GRU``): holds the three 2-layer GRU kernels (eval form, training
   forward with residuals, reverse chain, all three on the 2-layer cores)
   against their plain versions at B=32, T=372, D=64, H=256 (the eval form
   and the reverse chain at B=1 too, the reverse chain at B=17, each with
   its launch plan) and times them beside cuDNN's GRU, and the whole
   recurrence gradient beside cuDNN's.  Trains it as in 6
   (``[train_gru]``: one training forward and one reverse chain per step,
   gru2_infer once per eval batch, log-mel once per split, no LSTM
   kernel), card step against the CPU step, latency and profile; serves
   its ``best.ckpt`` (``[serve_gru]``: log-mel and gru2_infer once per
   batch), logits against the CPU forward, latency and profile.
10. The big sweep config with the GRU encoder (GRU 3x512, log-mel cached
   per split; ``BIG_GRU``): ``[gru1_train_fwd]`` / ``[gru1_infer]`` hold
   the one-layer GRU training forward and its eval form, ``[gru_bwd_chain]``
   the one-layer GRU reverse chain (with and without ``dh_series``; the
   launch plans printed), against
   their plain versions at B=32, T=372, H=512, with the whole 3-layer
   gradient against autograd through the plain forward, and time them
   beside cuDNN's GRU.  ``[train_big_gru]`` trains it as in 6 (3 training
   forwards and 3 reverse chains per step, 3 eval-form launches per eval
   batch, log-mel once per split, no 2-layer kernel), card step against
   the CPU step, latency and profile; ``[serve_big_gru]`` serves its
   ``best.ckpt`` (3 eval-form launches and 1 log-mel per batch), logits
   against the CPU forward, latency and profile.
11. The legacy-layout pair (``set_res2_mode("off")``, the route the JAX
   package's numerics gate cross-checks): ``[lstm2_train_fwd_legacy]`` /
   ``[lstm2_bwd_chain_legacy]`` and ``[gru2_train_fwd_legacy]`` /
   ``[gru2_bwd_chain_legacy]`` hold its four kernels (rows 5, 9, 8 and 10
   of PERF.md's table; the chains with and without ``dys``) against their
   plain versions at B=32, T=372, D=64, H=256 (the forwards and the LSTM
   chain also at B 17 and 1; all four the 2-layer cores' legacy cells,
   printed with their launch plans), time them beside the residual-native
   pair's on the same inputs in the same phase (µs per phase of each; the
   forwards' shared lanes bit for bit, the chains' outputs to 1e-5 of the
   largest), the plain versions and cuDNN,
   the fused GRU chain beside the layered one over the same residuals (1e-5
   of the largest), and hold the whole recurrence gradient of each legacy
   route (the GRU's fused and layered) to the residual-native route's (dx
   1e-6, weights 1e-5 of the largest).
   ``[train_legacy]`` trains the flagship as in 6 with the switch set (the
   two legacy kernels once per step, lstm2_infer per eval batch, no other
   pair), ``[train_gru_legacy]`` the GRU config with it and
   ``lstm_vjp.GRU_BWD2_ENABLED``; card step against the CPU step, latency and
   profile.  Neither is served again: the eval forward ignores the switch.
12. The transformer audio encoder config (``TRANSFORMER``: 2 post-LN
   blocks h256, 4 heads, log-mel cached per split): ``[flash_fwd]`` /
   ``[flash_bwd]`` hold the flash forward and fused backward against their
   plain versions at the encoder's (32, 4, 372, 64) (dropout 0 and 0.1,
   one seed), at (4, 4, 1000, 64) with a key-padding bias, at the
   blockwise fold of one raw clip (94, 4, 512, 64) and at head dims 128
   and 40 with T off the tiles, check the dropout mask's kept fraction,
   and time them beside ``scaled_dot_product_attention``; ``[flash_long]`` runs
   ``flash_attention`` forward + backward at (2, 4, 5000, 64), past the
   fused form's 4,096 keys, so the two-pass kernels run (once each, the
   fused one never), against the plain versions, and times them.  Every
   flash kernel (the forward, the fused backward, its dK / dV form and the
   two-pass dQ pass) runs 3xTF32 on the tensor cores: each prints its bound
   on the float32 rate and in 3xTF32 on the TF32 rate (``bound_fp32_ms``,
   ``bound_3xtf32_ms``; their ``bound_ms`` is the latter).
   ``[train_tf]`` trains it as in 6 (two flash forwards per train step and
   per eval batch, two fused backwards per step, log-mel once per split
   chunk, no recurrent kernel), card step against the CPU step with the
   Philox seeds replayed, latency and profile; ``[serve_tf]`` serves its
   ``best.ckpt`` (log-mel once and the flash forward twice per batch),
   logits against the CPU forward, latency and profile.
13. ``configs/base.yaml`` as written (``frontend.audio: "raw"``: the
   (B, 48000, 1) waveform into the LSTM 2x256, 96,000 serial layer-steps a
   forward): ``[lstm_raw]`` / ``[gru_raw]`` hold the 2-layer pairs'
   training forward, reverse chain and eval form (rows 11, 12, 2 and 14,
   15, 3) at B=32, T=48,000, D=1, H=256, and ``[lstm1_raw]`` the one-layer
   forward and chain (rows 6, 4; the cores of the GRU's 7f, 7) at H=512,
   each kernel over the whole batch, held on the first and the last row of
   the batch (``RAW_ROWS``) against its plain version, which worker
   processes run on the CPU over those rows while the card runs the other
   phases (the chains over the plain forwards' residuals, which the card's
   chains take in those rows); each series' error printed per run of steps
   cut where the full series' offsets pass 2^29 and 2^31 elements, bound
   1e-4 of the largest entry; their times go into the kernels line as
   ``raw_*``.  The
   big config on raw (LSTM 3x512, b32), whose full-length residuals exceed
   the card, must be refused before it allocates them.  ``[train_raw]`` /
   ``[serve_raw]`` train the file unmodified and serve its ``best.ckpt`` as
   in 6 (the pair once per step, the eval form per eval or served batch,
   no log-mel), ``[train_raw_gru]`` / ``[serve_raw_gru]`` with the GRU; the
   card-vs-CPU step and the served logits are checked on 4 clips.
14. The fusion library's configs as written, both on the flagship's audio
   path: ``[lstm2_train_fwd]`` also holds row 11 at 320 rows (the MC
   fold's 10 samples x batch 32) against its plain version, to 1e-4 of the
   largest entry, with its launch plan.  ``[train_hybrid]`` /
   ``[serve_hybrid]`` train ``configs/av_hybrid.yaml`` (hybrid
   cross-modal attention fusion) and serve its ``best.ckpt`` as in 6, the
   card-vs-CPU step on 4 clips; ``[train_unc]`` trains
   ``configs/uncertainty.yaml`` (uncertainty-weighted late fusion), whose
   calibration report (``uncertainty.json`` under an
   ``outputs.experiments_dir`` in the work directory) takes the place of
   ``best.ckpt`` and ``results.json``, and ``[serve_unc]`` serves the
   trainer's best checkpoint; ``[mc_dropout]`` runs ``predict --mc-dropout
   10`` on it (log-mel and row 11 once per batch, at 320 rows; no eval
   form), checks ``uncertainty.npy``, repeats the first batch on the card
   and on the CPU with the card's masks replayed (mean logits 1e-3,
   uncertainty 1e-4), and times the b32 MC forward.
15. The unimodal configs as written (``BASELINE.json`` configs 1 and 2),
   which run no recurrent kernel: ``[train_audio_only]`` /
   ``[serve_audio_only]`` train ``configs/audio_only.yaml`` (log-mel inside
   every step -> Conv1d k5 -> BatchNorm -> ReLU -> Conv1d k3 -> BatchNorm
   -> ReLU -> mean -> Dense, cuDNN convolutions) and serve its
   ``best.ckpt`` as in 6 (log-mel once per step, eval batch and served
   batch, every other kernel never); its gradient jumps at ReLU kinks past
   the smooth models' bound, so its card step and the CPU's float32 step
   are held to the CPU's float64 step on the same log-mel features
   (``kinked_step_check``), BatchNorm's running statistics after it to 1e-5
   of each buffer's largest entry; ``[train_video_only]`` /
   ``[serve_video_only]`` the same as 6 for
   ``configs/video_only.yaml`` (the frame encoder alone: no kernel
   launches); ``[train_mlp]`` trains ``audio_only.yaml`` with
   ``SimpleMLPEncoder`` (``model.encoders.audio.type=mlp``);
   ``[mc_dropout_cnn]`` runs ``predict --mc-dropout 10`` on the CNN's
   checkpoint (log-mel once per batch), checked as ``[mc_dropout]``, and the
   running statistics must come out of every MC forward bit for bit.  The
   raw-length phases of 13 also time cuDNN's LSTM / GRU at that shape
   (``raw_library_ms``), and ``[lstm2_train_fwd]`` cuDNN's training forward
   at 320 rows (``b320_library_ms``).
16. bf16 residual streams (``runtime.lstm_residual_dtype``,
   configs/fast.yaml): ``[lstm2_res_bf16]`` (rows 11 and 12's bf16 forms at
   B 32, 17 and 1), ``[gru2_res_bf16]`` (rows 14 and 15, B 32 and 1) and
   ``[lstm1_res_bf16]`` (rows 6 and 4 at H 512): the forwards' finals bit
   for bit the float32 forms', every stored bf16 series the float32 form's
   rounded to bf16 on the card (bit for bit, or within one bf16 ulp with
   the count printed), the chains over those bf16 residuals against the
   float32 chains over them upcast (the same rule), each against its plain
   version (bf16 outputs within one bf16 ulp + 1e-6 of the largest entry,
   float32 within 1e-4 of it), both forms timed in the same phase beside
   the plain version, cuDNN and the bound.  Then ``[train_fast]`` /
   ``[serve_fast]`` (configs/fast.yaml as written: log-mel cached per
   split, the pair's bf16 forms per step, its eval form per eval batch;
   the card step to 1e-3 of the largest gradient of the CPU's, and apart
   from the card's float32-stream step by more than 3x that gap; its p50,
   busy share and peak memory beside ``[train_hybrid]``'s),
   ``[train_gru_fast]`` (the GRU config) and ``[train_big_fast]`` (the big
   config) with bf16 streams, and ``[lstm1_raw]`` prints the big config's
   bf16 count on raw beside the card's free bytes.  The remat pair in bf16
   (``runtime.lstm_remat_gates=true`` with bf16 streams):
   ``[lstm2_remat_bf16]`` holds rows 11n and 13's bf16 forms bit for bit
   to the float32 forms rounded (11nb at B 32, 17 and 1; 13b over 11nb's
   streams at B 32, 17, 1 and 128, in slices of the batch) and to their
   plain versions, times both beside their float32 forms, row 12b and
   cuDNN, and holds the whole recurrence gradient to the CPU's (2e-3) with
   its peak memory beside the stored-gates and float32 routes' and
   ``stack_residual_bytes``'; ``[train_fast_remat]`` / ``[serve_fast_remat]``
   train fast.yaml with remat (11nb and 13b once a step, no other pair;
   the card step as ``[train_fast]``'s, and apart from the stored-gates
   step on the same batch) and serve its ``best.ckpt``.
17. Synthetic data, the host-streaming loader, the epoch trace and the
   streaming monitor.  ``[stream]`` runs ``tools.stream`` on ``[serve]``'s
   seeded flagship checkpoint over a 60 s stream (58 windows of 48,000
   samples / 24 frames, 2 microbatches of 32: log-mel and row 2 twice),
   holds its logits bit for bit to the card's ``forward`` on the same
   windows in b32 batches and within 1e-3 to the stream on the CPU (every
   label, ``timeline.csv`` apart from its probabilities and
   ``summary.json`` equal), and runs ``--microbatch 1`` (row 2's B=1 plan).
   ``[train_synthetic]`` trains the reference's synthetic fixture (three
   sensors of D 32, T 100, 5 classes) through an LSTM 2x256 a sensor
   (rows 11 and 12 three times a step, row 2 three times an eval batch),
   card step against the CPU step, step latency and busy share;
   ``[train_synthetic_stream]`` again with ``dataset.device_resident=false``
   and ``runtime.profile_dir``: bit for bit the resident run, one trace of
   epoch 1 naming rows 11 and 12 three times a step, and no more
   synchronising calls a streamed epoch than a resident one
   (``torch.cuda.set_sync_debug_mode``); ``[serve_synthetic]`` serves its
   ``best.ckpt`` (row 2 three times a batch), logits against the CPU;
   ``[debug]`` runs ``tools.debug`` on the same model (the overfit probe's
   frozen-encoder steps run row 11 and no reverse chain).  Every phase's
   wall seconds are printed as it ends.
18. The serving and sweep tools.  ``[quantize]`` runs ``tools.quantize``
   on ``[train]``'s flagship ``best.ckpt`` (int8 weight-only codes per
   output channel), then the predict CLI over the test split in float32,
   with ``--quantize-weights`` int8, int8-bf16 and bfloat16 and with
   ``--quantized-artifact`` (log-mel and row 2 once per batch each): the
   artifact's logits bit for bit the in-memory int8 round trip's, each
   mode's first batch against the CPU's plain forward on the same rounded
   weights (1e-3), every mode's accuracy and ECE beside float32's and the
   artifact's bytes beside the checkpoint's; then ``predict
   --quantize-weights int8`` on ``[train_gru]``'s and ``[train_tf]``'s
   ``best.ckpt`` (``[quantize_gru]``: log-mel and row 3 once per batch;
   ``[quantize_tf]``: log-mel once and row 16 twice), each first batch
   against the CPU's plain forward on the same rounded weights.  ``[sweep]`` runs ``tools.sweep
   --vmap-grid`` on the flagship for 1 epoch of the 96-clip train split:
   the reference's 3x2x2 grid as 2 programs of 6 members, each member
   stepping through rows 1, 11 and 12 and validating through rows 1 and 2
   (counts exact: 12 x the steps), the (1e-3, 0, 0) member equal to a
   standalone ``--vmap-lrs 1e-3`` run to the last bit; ``run_sweep`` over a
   1x2x1 grid (two train.run calls) with its harvested artifacts; and a
   6-member step's time per member beside ``[train]``'s step.
   ``[visualize]`` runs ``tools.visualize`` on ``[train_hybrid]``'s
   ``best.ckpt`` (log-mel and row 2 once) and holds the (M, M)
   cross-attention matrix from the card to the CPU's (1e-5).
19. The transformer config with bf16 encoders (``TRANSFORMER_BF16``:
   ``model.encoders.{audio,video}.dtype=bfloat16``).  ``[flash_bf16]``
   holds the bf16 forms of the flash forward and fused backward against
   their bf16 plain versions at ``[flash_fwd]``'s cases but the fold (O,
   dQ, dK, dV within ``FLASH_BF16_ULPS`` bf16 ulps of the largest entry,
   LSE to 1e-5) and times each at (32, 4, 372, 64), at dropout rates 0 and
   0.1 beside SDPA in bf16 at the same ``dropout_p`` and at 0.1 beside the
   float32 form on the same values, with the bound at the bf16 tensor rate
   and bf16 bytes; ``[flash_long_bf16]`` runs ``flash_attention`` on
   bf16 at (2, 4, 5000, 64) (the bf16 forward, dK / dV and dQ forms once
   each, no fused or float32 form) against the plain versions and times
   the two-pass forms beside their float32 forms.  ``[train_tf_bf16]``
   trains it as in 6 (two bf16 forwards per step and eval batch, two bf16
   fused backwards per step, no float32 flash kernel), the card step held
   by the bf16 step rule (``half_step_check``: the card's and the CPU's
   bf16 steps each against the CPU's float32 step on the same weights,
   batch and masks), its p50 / p90 and busy share beside ``[train_tf]``'s;
   ``[serve_tf_bf16]`` serves its ``best.ckpt`` (logits within 4 bf16 ulps
   of the largest CPU logit, the argmax wherever the CPU's top two are
   more than twice that apart), b32 and b1 latency.
20. Export (``tools.export``, the serving kernels as ``med_torch`` custom
   ops): ``[export]``, ``[export_gru]``, ``[export_big]``,
   ``[export_big_gru]``, ``[export_tf]`` and ``[export_tf_compute_bf16]``
   export ``[train]``'s, ``[train_gru]``'s, ``[train_big]``'s,
   ``[train_big_gru]``'s, ``[train_tf]``'s and ``[train_tf_compute_bf16]``'s
   ``best.ckpt`` at b32 through the CLI (its round trip: the eager forward
   and the loaded program once each, counted exactly), print the export
   seconds and the ``.pt2`` bytes, hold the loaded program's logits on the
   test split's first 32 clips bit for bit to the eager ``forward``'s with
   each exported call's launches exact (log-mel once; rows 2, 3 once, 6e,
   7e three times, 16 or 16b twice), and time both b32 forwards in the
   same phase.  The flagship's file is also loaded and served in a fresh
   interpreter that imports only ``multimodal_emotion_detection_tpu_torch
   .ops``, bit for bit the eager logits.
21. The way in: ``[import_ref]`` builds the reference's own model at
   ``configs/base.yaml``'s widths (wired as the reference is, seeded torch
   init), saves it as a Lightning-style ``.ckpt``, imports it with
   ``utils/torch_import.py::import_reference_checkpoint``, saves a port
   checkpoint and serves ``[serve]``'s 64 clips through the predict CLI at
   b32 on the raw waveform (row 2 once a batch), the logits within 1e-3 of
   the reference module's cuDNN forward on the card, argmax 64/64.
   ``[serve_resize]`` serves the flagship with
   ``model.frontend.video=resize`` at b32 on raw uint8 BGR frames at
   1280x720 (2.1 GB a batch): logits within 1e-4 of the same model on the
   ETL-flattened frames, 2 clips' resized frames against the numpy resize,
   the frontend's device time beside its bound.  ``[etl]`` writes 96
   RAVDESS-named 48 kHz WAVs and frame ``.npy`` files and runs the ETL
   CLIs (``data.ravdess --no_video``, ``data.manifest --feature_len 24``;
   no kernel launches), checks shapes, dtypes, peaks, split sizes and the
   native resampler against its scipy plain version on every clip;
   ``[train_etl]`` trains the flagship on the manifest ETL's output (rows
   1, 11, 12 and 2 counted exactly).  ``[flops]`` prints ``utils/flops.py``'s
   FLOPs per clip of every trained configuration, the share of the card's
   datasheet peak at each train step's and ``[serve]``'s b32 p50, and a
   device-to-device copy's bandwidth beside the datasheet HBM figure.
22. Prints the script's wall time, one JSON line describing every kernel
   (the one-layer and 2-layer cores' entries name their shared header as
   ``core``), nvidia-smi's name and power limit of the card, and as the
   last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no ok
line.  Without a CUDA card it exits non-zero at once.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
CSRC = "multimodal_emotion_detection_tpu_torch/csrc/"

# H100 SXM published peaks (NVIDIA data sheet), at its 700 W power limit
FP32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
HBM_BYTES = 3.35e12  # bytes/s


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def bound(flops: float, nbytes: float, rate: float = FP32_FLOPS):
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def tc_bounds(flops: float, nbytes: float):
    """Both bounds of a kernel that runs float32 products as 3xTF32 on the
    tensor cores: on the CUDA cores' float32 rate, and as 3 TF32 products
    at the tensor cores' rate (the kernel's own arithmetic, its bound_ms)."""
    return bound(flops, nbytes), bound(3 * flops, nbytes, TF32_FLOPS)


def _work(name: str, b: int, t: int, d: int, h: int):
    """``(flops, bytes)`` of one call of a recurrent kernel at (B, T, D, H):
    its products, each input read once, each output written once (the
    one-layer kernels take the hoisted projection: D unused)."""
    if name == "lstm2_infer":
        return (2 * b * t * (d * 4 * h + 3 * h * 4 * h),
                4 * (b * t * d + d * 4 * h + 3 * h * 4 * h + 2 * 4 * h + b * h))
    if name == "lstm2_train_fwd":
        return (2 * b * t * (d * 4 * h + 3 * h * 4 * h),
                4 * (t * b * (d + h + 13 * h) + d * 4 * h + 3 * h * 4 * h
                     + 2 * 4 * h + 4 * b * h))
    if name == "lstm2_bwd_chain":
        return (2 * b * t * 3 * 4 * h * h,
                4 * (t * b * (10 * h + h + 8 * h) + b * h + 3 * h * 4 * h))
    if name == "gru2_infer":
        return (2 * b * t * (d * 3 * h + 3 * h * 3 * h),
                4 * (b * t * d + d * 3 * h + 3 * h * 3 * h + 4 * 3 * h + b * h))
    if name == "gru2_train_fwd":
        return (2 * b * t * (d * 3 * h + 3 * h * 3 * h),
                4 * (t * b * (d + h + 11 * h) + d * 3 * h + 3 * h * 3 * h
                     + 4 * 3 * h + 2 * b * h))
    if name == "gru2_bwd_chain":
        return (2 * b * t * 3 * 3 * h * h,
                4 * (t * b * (8 * h + 3 * h + 8 * h) + b * h + 3 * h * 3 * h))
    if name == "lstm1_train_fwd":
        return (2 * b * t * h * 4 * h,
                4 * (2 * t * b * 4 * h + h * 4 * h + 2 * t * b * h + 2 * b * h))
    if name == "lstm_bwd_chain":  # with dh_series
        return (2 * b * t * 4 * h * h,
                4 * (2 * t * b * 4 * h + 2 * t * b * h + b * h + h * 4 * h))
    raise KeyError(name)


class L2Flush:
    """Writes 128 MB, over twice the 50 MB L2, so a timed call starts with
    its inputs in device memory as a fresh request's would be."""

    def __init__(self):
        self.buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")

    def __call__(self):
        self.buf.zero_()


def device_ms(fn, flush: L2Flush, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call,
    the L2 flushed before each.  A ~0.5 ms spin of the card after the flush
    lets the host enqueue the start event and the call before the card
    reaches them, so a wrapper's host time is not counted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 110, warmup: int = 5):
    """Median and 90th percentile (11 samples beyond it at 110 reps) of
    the host-clock time of ``fn`` + synchronize, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    times.sort()
    return statistics.median(times), times[int(0.9 * reps)]


def max_errs(out: torch.Tensor, ref: torch.Tensor):
    diff = (out - ref).abs()
    return float(diff.max()), float((diff / ref.abs().clamp(min=1e-3)).max())


def phase_logmel(logmel, flush):
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    wave = torch.from_numpy(rng.randn(32, 48000).astype(np.float32)).to(dev)
    p = logmel.LogMelParams()
    out = logmel.logmel_cuda(wave, p)
    torch.cuda.synchronize()
    ref = logmel.logmel_frames(wave, p)
    abs_err, rel_err = max_errs(out, ref)
    print(f"[logmel] (32, 48000) hop 128 -> {tuple(out.shape)}: "
          f"max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
          "(bound 1e-4 abs + 1e-4 rel)")
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    p160 = logmel.LogMelParams(hop_length=160)
    out160 = logmel.logmel_cuda(wave, p160)
    ref160 = logmel.logmel_frames(wave, p160)
    a160, r160 = max_errs(out160, ref160)
    print(f"[logmel] (32, 48000) hop 160 -> {tuple(out160.shape)}: "
          f"max abs err {a160:.3e}, max rel err {r160:.3e}")
    torch.testing.assert_close(out160, ref160, rtol=1e-4, atol=1e-4)

    one = wave[:1].contiguous()
    out1 = logmel.logmel_cuda(one, p)
    a1 = max_errs(out1, logmel.logmel_frames(one, p))[0]
    torch.testing.assert_close(out1, logmel.logmel_frames(one, p), rtol=1e-4, atol=1e-4)

    ms = device_ms(lambda: logmel.logmel_cuda(wave, p), flush)
    plain_ms = device_ms(lambda: logmel.logmel_frames(wave, p), flush)
    ms1 = device_ms(lambda: logmel.logmel_cuda(one, p), flush)
    plain_ms1 = device_ms(lambda: logmel.logmel_frames(one, p), flush)
    b, t = wave.shape
    f, nb, nm = out.shape[1], p.n_bins, p.n_mels
    # the kernel's formulation: a real n_fft-point FFT at 2.5 n log2 n flops
    # a frame, the split and power (~3 a bin) and the filterbank's
    # non-zeros; bytes: the waveform in, the features out, its tables
    # (twiddles, window, runs, weights)
    runs, weights = logmel.mel_runs_np(p)
    fft_flops = b * f * (2.5 * p.n_fft * np.log2(p.n_fft) + 3 * nb + 2 * weights.size)
    fft_bytes = 4 * (b * t + b * f * nm + 3 * p.n_fft + runs.size + weights.size)
    bound_ms, bound_by = bound(fft_flops, fft_bytes)
    # the products' formulation the plain version uses: the window-folded
    # DFT basis over the window's non-zero taps, the dense filterbank
    lo, hi = logmel.nonzero_taps(p.n_fft, p.win_length)
    taps = hi - lo
    dft_flops = b * f * (4 * taps * nb + 2 * nb * nm)
    dft_bytes = 4 * (b * t + b * f * nm + 2 * taps * nb + nb * nm)
    dft_ms, dft_by = bound(dft_flops, dft_bytes)
    print(f"[logmel] B=32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms as FFT + sparse filterbank ({bound_by}: "
          f"{fft_flops / 1e9:.3f} GFLOP, {weights.size} filterbank non-zeros, "
          f"{fft_bytes / 1e6:.2f} MB); as products over the {taps} non-zero taps "
          f"{dft_ms:.4f} ms ({dft_by}: {dft_flops / 1e9:.3f} GFLOP); no single "
          "PyTorch call computes it")
    bound1 = bound(fft_flops / b, fft_bytes - 4 * (b - 1) * (t + f * nm))[0]
    print(f"[logmel] B=1 -> {tuple(out1.shape)}: max abs err {a1:.3e}; kernel "
          f"{ms1:.4f} ms, plain {plain_ms1:.4f} ms, bound {bound1:.4f} ms")
    return {"name": "logmel", "route": "cuda",
            "source": "multimodal_emotion_detection_tpu_torch/csrc/logmel.cu",
            "replaces": "multimodal_emotion_detection_tpu/ops/logmel.py:160",
            "max_abs_err": max(abs_err, a160, a1), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "b1_ms": ms1, "b1_plain_ms": plain_ms1, "bound_products_ms": dft_ms}


def phase_lstm(lstm_kernel, flush):
    dev = torch.device("cuda")
    b, t, d, h = 32, 372, 64, 256
    rng = np.random.RandomState(1)
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        return {name: torch.from_numpy(
            rng.uniform(-k, k, shape).astype(np.float32)).to(dev)
            for name, shape in (("w_ih", (d_in, 4 * h)),
                                ("w_hh", (h, 4 * h)), ("b", (4 * h,)))}

    l0, l1 = layer(d), layer(h)
    x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32)).to(dev)
    out = lstm_kernel.lstm2_infer(x, l0, l1)
    torch.cuda.synchronize()
    ref = lstm_kernel.lstm2_infer_reference(x, l0, l1)
    abs_err, rel_err = max_errs(out, ref)
    print(f"[lstm2_infer] B={b} T={t} D={d} H={h}: max abs err {abs_err:.3e}, "
          f"max rel err {rel_err:.3e} (bound 1e-4 abs on h1)")
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    out1 = lstm_kernel.lstm2_infer(x[:1], l0, l1)
    ref1 = lstm_kernel.lstm2_infer_reference(x[:1], l0, l1)
    a1, _ = max_errs(out1, ref1)
    print(f"[lstm2_infer] B=1: max abs err {a1:.3e}")
    torch.testing.assert_close(out1, ref1, rtol=0, atol=1e-4)
    for rows in (b, 1):
        print(f"[lstm2_infer] "
              f"{_chain_plan_text(lstm_kernel, 'lstm2_infer', 4, h, rows, True, 2)}")

    lib = _cudnn_lstm(l0, l1)
    with torch.no_grad():
        lib_out = lib(x)[1][0][-1]
    lib_err, _ = max_errs(lib_out, ref)
    print(f"[lstm2_infer] torch.nn.LSTM (cuDNN) vs plain: max abs err {lib_err:.3e}")

    def run_lib():
        with torch.no_grad():
            lib(x)

    ms = device_ms(lambda: lstm_kernel.lstm2_infer(x, l0, l1), flush)
    plain_ms = device_ms(
        lambda: lstm_kernel.lstm2_infer_reference(x, l0, l1), flush, reps=5)
    library_ms = device_ms(run_lib, flush)
    x1 = x[:1].contiguous()
    ms_b1 = device_ms(lambda: lstm_kernel.lstm2_infer(x1, l0, l1), flush)
    flops, nbytes = _work("lstm2_infer", b, t, d, h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[lstm2_infer] kernel {ms:.4f} ms (input projection + one cooperative "
          f"cluster launch, {t + 1} phases, {1e3 * ms / (t + 1):.3f} us per phase), "
          f"plain {plain_ms:.4f} ms, cuDNN {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; serial chain of "
          f"{2 * t} layer-steps)")
    print(f"[lstm2_infer] B=1 kernel {ms_b1:.4f} ms ({1e3 * ms_b1 / (t + 1):.3f} us "
          "per phase)")
    return {"name": "lstm2_infer", "route": "cuda",
            "source": "multimodal_emotion_detection_tpu_torch/csrc/lstm2_infer.cu",
            "core": CSRC + "rnn2_fwd_chain.cuh",
            "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:40",
            "max_abs_err": max(abs_err, a1), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def run_counted(counters, expected, path: str, fn):
    """Zero every kernel's launch count, run ``fn``, read the counts: each
    must equal ``expected[name]``, 0 where it is not listed.  Returns
    ``(fn's result, wall seconds, counts)``."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    for name, count in launches.items():
        if count != expected.get(name, 0):
            raise RuntimeError(f"{name} launched {count} times on the {path} "
                               f"path, expected {expected.get(name, 0)}")
    return out, wall, launches


def serve_path(tag: str, counters, expected, ckpt: Path, overrides,
               audio: np.ndarray, video: np.ndarray, out_dir: Path,
               check_clips: int = 0, reps: int = 110, profile_reps: int = 20,
               config: str = "base.yaml", logit_ulps: int = 0):
    """The predict CLI on ``ckpt`` with ``configs/<config>`` over the test
    split (``audio``, ``video``) at batch 32 with the launch counts checked; the logits
    (of the first ``check_clips``, where given) against the model's own
    forward on the CPU, where every kernel wrapper runs its plain version
    (each kernel was held against it on the card); then the forward's
    latency over ``reps`` requests and its profile over ``profile_reps`` at
    batch 32 and 1.  The logits are held to 1e-3 and the argmax everywhere;
    with ``logit_ulps`` (bf16 encoders) to that many bf16 ulps of the
    largest logit (2^-8 of it each), and the argmax wherever the CPU's top
    two logits are more than twice that bound apart."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.tools import predict
    from multimodal_emotion_detection_tpu_torch.tools._restore import (
        restore_for_eval,
    )
    from multimodal_emotion_detection_tpu_torch.training.steps import forward

    config_path = str(ROOT / "configs" / config)
    n = audio.shape[0]
    metrics, predict_s, launches = run_counted(
        counters, expected, tag, lambda: predict.main([
            "--checkpoint", str(ckpt), "--config", config_path, "--split", "test",
            "--out", str(out_dir), *overrides]))
    print(f"[{tag}] predict over {n} clips at batch 32: {predict_s:.3f} s wall "
          f"(first call, data load included); launches {launches}")
    logits = np.load(out_dir / "logits.npy")
    if logits.shape != (n, 8) or not np.isfinite(logits).all():
        raise RuntimeError(f"bad logits: shape {logits.shape}")
    if not (out_dir / "metrics.json").exists():
        raise RuntimeError("metrics.json was not written")
    print(f"[{tag}] metrics {json.dumps(metrics)}")

    cfg = load_config(config_path, overrides)
    cfg.model.frontend.cache = False  # as predict: raw features in
    clips = {m: {"audio": audio, "video": video}[m] for m in cfg.dataset.modalities}
    model, _, _ = restore_for_eval(cfg, ckpt, "test", torch.device("cpu"))
    rows = check_clips or n
    with torch.no_grad():
        ref = torch.cat([
            forward(model, {m: torch.from_numpy(a[i:min(i + 32, rows)])
                            for m, a in clips.items()})
            for i in range(0, rows, 32)]).float().numpy()
    err = float(np.abs(logits[:rows] - ref).max())
    same = logits[:rows].argmax(-1) == ref.argmax(-1)
    agree = int(same.sum())
    bound_logits, decided = 1e-3, np.ones(rows, bool)
    if logit_ulps:
        bound_logits = logit_ulps * 2.0 ** -8 * float(np.abs(ref).max())
        top2 = np.sort(ref, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * bound_logits
    print(f"[{tag}] logits vs the plain-version forward on the CPU: max abs "
          f"err {err:.3e} (bound {bound_logits:.3e}), argmax agreement {agree}/{rows}"
          + (f" ({int(decided.sum())} clips with a top-two margin over twice the "
             f"bound, {int(same[decided].sum())} of them agree)" if logit_ulps else ""))
    if err > bound_logits or not same[decided].all():
        raise RuntimeError("served logits disagree with the plain forward")

    dev = torch.device("cuda")
    model = model.to(dev).eval()
    b32 = {m: torch.from_numpy(a[:32]).to(dev) for m, a in clips.items()}
    b1 = {k: v[:1].contiguous() for k, v in b32.items()}
    for label, batch in (("b32", b32), ("b1", b1)):
        p50, p90 = host_ms(lambda: forward(model, batch), reps=reps)
        SERVES.setdefault(tag, {})[label] = p50
        print(f"[{tag}] forward latency {label} (host clock around "
              f"synchronize, {reps} requests, inputs on the card): "
              f"p50 {p50:.4f} ms, p90 {p90:.4f} ms")
        profile_forward(f"{tag} {label}", lambda: forward(model, batch),
                        reps=profile_reps)
    return launches


def phase_serve(counters):
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )
    from multimodal_emotion_detection_tpu_torch.training.checkpoints import (
        save_checkpoint,
    )

    n = 64
    data = WORK / "data"
    split = data / "test"
    split.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(2)
    audio = rng.randn(n, 48000, 1).astype(np.float32)
    video = rng.rand(n, 24, 4096).astype(np.float32)
    np.save(split / "audio.npy", audio)
    np.save(split / "video.npy", video)
    np.save(split / "labels.npy", rng.randint(0, 8, n).astype(np.int32))

    overrides = ["model.frontend.audio=logmel", f"dataset.data_dir={data}"]
    cfg = load_config(str(ROOT / "configs" / "base.yaml"), overrides)
    model = init_weights(classifier_from_config(cfg),
                         torch.Generator().manual_seed(0))
    ckpt = WORK / "flagship_seed0.pt"
    save_checkpoint(ckpt, model.state_dict(), {"seed": 0})
    batches = n // cfg.dataset.batch_size
    return serve_path("serve", counters, {"logmel": batches, "lstm2_infer": batches},
                      ckpt, overrides, audio, video, WORK / "predictions")


def _lstm_train_inputs(seed: int, b: int = 32, t: int = 372):
    """The flagship's training shape (log-mel 64, LSTM 2x256, batch 32;
    or b rows over t steps): time-major x, keep mask at dropout 0.1, both
    layers' weights."""
    dev = torch.device("cuda")
    d, h = 64, 256
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        return {name: torch.from_numpy(
            rng.uniform(-k, k, shape).astype(np.float32)).to(dev)
            for name, shape in (("w_ih", (d_in, 4 * h)),
                                ("w_hh", (h, 4 * h)), ("b", (4 * h,)))}

    l0, l1 = layer(d), layer(h)
    x_tm = torch.from_numpy(rng.randn(t, b, d).astype(np.float32)).to(dev)
    keep = torch.from_numpy(
        ((rng.rand(t, b, h) < 0.9) / 0.9).astype(np.float32)).to(dev)
    return x_tm, keep, l0, l1


def _cudnn_lstm(*layers, batch_first: bool = True):
    """Yardstick only, never called by the port: cuDNN's LSTM with the
    same layers' weights (torch keeps (4H, D) matrices and two biases)."""
    d, h = layers[0]["w_ih"].shape[0], layers[0]["w_hh"].shape[0]
    lib = torch.nn.LSTM(d, h, num_layers=len(layers), batch_first=batch_first).cuda()
    with torch.no_grad():
        for i, p in enumerate(layers):
            getattr(lib, f"weight_ih_l{i}").copy_(p["w_ih"].T)
            getattr(lib, f"weight_hh_l{i}").copy_(p["w_hh"].T)
            getattr(lib, f"bias_ih_l{i}").copy_(p["b"])
            getattr(lib, f"bias_hh_l{i}").zero_()
    return lib.train()


def phase_lstm2_train_fwd(lstm_kernel, flush):
    x_tm, keep, l0, l1 = _lstm_train_inputs(3)
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    outs = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    refs = lstm_kernel.lstm2_train_fwd_reference(x_tm, keep, l0, l1)
    errs = {}
    for name, out, ref in zip(("packed", "h0_prev", "h1_prev", "x1", "finals"),
                              outs, refs):
        errs[name] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)
    print(f"[lstm2_train_fwd] B={b} T={t} D={d} H={h}, keep p=0.1: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (bound 1e-4 abs + 1e-4 rel)")
    print(f"[lstm2_train_fwd] "
          f"{_chain_plan_text(lstm_kernel, 'lstm2_train_fwd', 4, h, b, True, 2)}")

    lib = _cudnn_lstm(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()

    def run_lib():
        lib(x_bt)  # training forward with autograd: saves what backward needs

    ms = device_ms(lambda: lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1),
                   flush)
    plain_ms = device_ms(
        lambda: lstm_kernel.lstm2_train_fwd_reference(x_tm, keep, l0, l1),
        flush, reps=5)
    library_ms = device_ms(run_lib, flush)
    flops, nbytes = _work("lstm2_train_fwd", b, t, d, h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[lstm2_train_fwd] kernel {ms:.4f} ms (input projection + one "
          f"cooperative cluster launch, {t + 1} phases, "
          f"{1e3 * ms / (t + 1):.3f} us per phase), plain {plain_ms:.4f} ms, "
          f"cuDNN nn.LSTM training forward at keep=1 {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB incl. the residual stores)")
    kern = {"name": "lstm2_train_fwd", "route": "cuda",
            "source": "multimodal_emotion_detection_tpu_torch/csrc/lstm2_train_fwd.cu",
            "core": CSRC + "rnn2_fwd_chain.cuh",
            "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:2270",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    return kern, (x_tm, keep, l0, l1, refs[0])


def phase_lstm2_bwd_chain(lstm_kernel, lstm_vjp, flush, inputs):
    x_tm, keep, l0, l1, packed = inputs
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    dh = torch.from_numpy(np.random.RandomState(4).randn(b, h).astype(np.float32)).cuda()
    args = (packed, keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    outs = lstm_kernel.lstm2_bwd_chain(*args)
    torch.cuda.synchronize()
    refs = lstm_kernel.lstm2_bwd_chain_reference(*args)
    errs = {}
    for name, out, ref in zip(("dg0", "dg1"), outs, refs):
        errs[name] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)
    # one row (the plan's two row groups, one empty) and 17 rows (a second
    # pass of rows in a group)
    for rows in (1, 17):
        sub = (*(a[:, :rows].contiguous() for a in (packed, keep)), dh[:rows].contiguous(),
               *args[3:])
        outs = lstm_kernel.lstm2_bwd_chain(*sub)
        torch.cuda.synchronize()
        for name, out, ref in zip(("dg0", "dg1"), outs,
                                  lstm_kernel.lstm2_bwd_chain_reference(*sub)):
            errs[f"{name} B={rows}"] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                       msg=f"{name} B={rows}")
    print(f"[lstm2_bwd_chain] B={b} T={t} H={h}: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (bound 1e-4 abs + 1e-4 rel)")
    for rows in (b, 17, 1):
        print(f"[lstm2_bwd_chain] "
              f"{_chain_plan_text(lstm_kernel, 'lstm2_bwd_chain', 4, h, rows, layers=2)}")

    lib = _cudnn_lstm(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()
    lib_params = list(lib.parameters())
    h_lib = lib(x_bt)[1][0][-1]

    def run_lib_bwd():
        torch.autograd.grad(h_lib, lib_params, dh, retain_graph=True)

    ms = device_ms(lambda: lstm_kernel.lstm2_bwd_chain(*args), flush)
    plain_ms = device_ms(lambda: lstm_kernel.lstm2_bwd_chain_reference(*args),
                         flush, reps=5)
    library_ms = device_ms(run_lib_bwd, flush)
    flops, nbytes = _work("lstm2_bwd_chain", b, t, d, h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[lstm2_bwd_chain] kernel {ms:.4f} ms (one cooperative cluster launch, "
          f"{t + 1} phases, {1e3 * ms / (t + 1):.3f} us per phase), plain "
          f"{plain_ms:.4f} ms, cuDNN backward of h_n at keep=1 {library_ms:.4f} ms "
          "(it also forms the weight gradients), bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)")

    # the whole recurrence gradient at keep=1: the kernel pair plus the
    # hoisted weight-gradient products, against cuDNN forward + backward
    ones = torch.ones_like(keep)
    p0 = {k: v.clone().requires_grad_() for k, v in l0.items()}
    p1 = {k: v.clone().requires_grad_() for k, v in l1.items()}
    ours_params = [*p0.values(), *p1.values()]

    def run_ours_grad():
        out = lstm_vjp.fused_lstm_final(x_bt, ones[:, None], (p0, p1))
        return torch.autograd.grad(out, ours_params, dh)

    def run_lib_grad():
        return torch.autograd.grad(lib(x_bt)[1][0][-1], lib_params, dh)

    g_ours, g_lib = run_ours_grad(), run_lib_grad()
    # cuDNN keeps (4H, D) matrices: compare dW_hh of layer 1 (ours (H, 4H))
    grad_err = float((g_ours[4] - g_lib[5].T).abs().max() / g_lib[5].abs().max())
    whole_ms = device_ms(run_ours_grad, flush)
    whole_lib_ms = device_ms(run_lib_grad, flush)
    print(f"[lstm2_bwd_chain] whole recurrence gradient (forward + reverse chain "
          f"+ hoisted weight products) {whole_ms:.4f} ms vs cuDNN forward + "
          f"backward {whole_lib_ms:.4f} ms; dW_hh1 relative to cuDNN's "
          f"{grad_err:.3e}")
    if not grad_err < 1e-3:
        raise RuntimeError("the recurrence gradient disagrees with cuDNN's")
    return {"name": "lstm2_bwd_chain", "route": "cuda",
            "source": "multimodal_emotion_detection_tpu_torch/csrc/lstm2_bwd_chain.cu",
            "core": CSRC + "rnn2_bwd_chain.cuh",
            "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:2482",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_lstm2_remat(lstm_kernel, lstm_vjp, flush):
    """``[lstm2_bwd_chain_remat]``: the gate-rematerialising pair at the
    flagship's training shape (B=32, T=372, D=64, H=256, keep p=0.1).  The
    no-gates training forward and the remat reverse chain against their
    plain versions; the no-gates residuals against the stored-gates form's
    (bit for bit) and the remat chain against the stored-gates chain on the
    same forward (the recompute's rounding); times of both forms beside
    cuDNN; the whole recurrence gradient and its peak memory on both
    routes."""
    x_tm, keep, l0, l1 = _lstm_train_inputs(8)
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    names = ("packed", "h0_prev", "h1_prev", "x1", "finals")

    def fwd(store_gates):
        return lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1,
                                                     store_gates=store_gates)

    outs = fwd(False)
    torch.cuda.synchronize()
    refs = lstm_kernel.lstm2_train_fwd_reference(x_tm, keep, l0, l1, store_gates=False)
    fwd_errs = {}
    for name, out, ref in zip(names, outs, refs):
        fwd_errs[name] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)
    stored = fwd(True)
    same = [torch.equal(o, s) for o, s in zip(outs, (stored[0][..., 8 * h:], *stored[1:]))]
    print(f"[lstm2_train_fwd_nogates] B={b} T={t} D={d} H={h}, keep p=0.1: max abs "
          "err " + ", ".join(f"{k} {v:.3e}" for k, v in fwd_errs.items())
          + f" (bound 1e-4 abs + 1e-4 rel); equal to the stored-gates form's "
          f"c_prev lanes and series bit for bit: {all(same)}")
    if not all(same):
        raise RuntimeError("the no-gates forward differs from the stored-gates form")
    print(f"[lstm2_train_fwd_nogates] "
          f"{_chain_plan_text(lstm_kernel, 'lstm2_train_fwd', 4, h, b, True, 2)}")

    dh = torch.from_numpy(np.random.RandomState(9).randn(b, h).astype(np.float32)).cuda()
    packed, h0p, h1p, x1 = outs[:4]
    args = (packed, keep, x_tm, x1, h0p, h1p, dh, l0, l1)
    dgs = lstm_kernel.lstm2_bwd_chain_remat(*args)
    torch.cuda.synchronize()
    errs = {}
    for name, out, ref in zip(("dg0", "dg1"), dgs,
                              lstm_kernel.lstm2_bwd_chain_remat_reference(*args)):
        errs[name] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)
    # one row (two row groups, one empty) and 17 rows (5 a group)
    for rows in (1, 17):
        sub = (*(a[:, :rows].contiguous() for a in (packed, keep, x_tm, x1, h0p, h1p)),
               dh[:rows].contiguous(), l0, l1)
        outs_b = lstm_kernel.lstm2_bwd_chain_remat(*sub)
        torch.cuda.synchronize()
        for name, out, ref in zip(("dg0", "dg1"), outs_b,
                                  lstm_kernel.lstm2_bwd_chain_remat_reference(*sub)):
            errs[f"{name} B={rows}"] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                       msg=f"{name} B={rows}")
    # past the rows whose gate blocks fit one launch: one launch a slice of
    # the batch (the plan's batch_slice), B=512 over 16 steps
    xw, keepw, w0, w1 = _lstm_train_inputs(12, b=512, t=16)
    resw = lstm_kernel.lstm2_train_fwd_residuals(xw, keepw, w0, w1, store_gates=False)
    dhw = torch.from_numpy(np.random.RandomState(13).randn(512, h).astype(np.float32)).cuda()
    wide = (resw[0], keepw, xw, resw[3], resw[1], resw[2], dhw, w0, w1)
    before = lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches
    outs_w = lstm_kernel.lstm2_bwd_chain_remat(*wide)
    torch.cuda.synchronize()
    slices = lstm_kernel.LSTM2_BWD_CHAIN_REMAT.launches - before
    for name, out, ref in zip(("dg0", "dg1"), outs_w,
                              lstm_kernel.lstm2_bwd_chain_remat_reference(*wide)):
        errs[f"{name} B=512"] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=f"{name} B=512")
    stored_args = (stored[0], keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    dgs_stored = lstm_kernel.lstm2_bwd_chain(*stored_args)
    vs_stored = {name: float((a - s).abs().max() / s.abs().max())
                 for name, a, s in zip(("dg0", "dg1"), dgs, dgs_stored)}
    print(f"[lstm2_bwd_chain_remat] B={b} T={t} D={d} H={h}: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (bound 1e-4 abs + 1e-4 rel); "
          "against the stored-gates chain on the same forward (the recompute's "
          "rounding, carried by the chain): max abs diff relative to the largest "
          + ", ".join(f"{k} {v:.3e}" for k, v in vs_stored.items()))
    if max(vs_stored.values()) > 1e-3:
        raise RuntimeError("the remat chain disagrees with the stored-gates chain")
    print(f"[lstm2_bwd_chain_remat] B=512 T=16: {slices} launches (slices of the batch)")
    d4 = -(-d // 4) * 4
    for rows in (b, 17, 1, 512):
        print("[lstm2_bwd_chain_remat] " + _chain_plan_text(
            lstm_kernel, "lstm2_bwd_chain_remat", 4, h, rows, layers=2, remat_d=d4))

    lib = _cudnn_lstm(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()
    lib_params = list(lib.parameters())
    h_lib = lib(x_bt)[1][0][-1]

    def run_lib_bwd():
        torch.autograd.grad(h_lib, lib_params, dh, retain_graph=True)

    fwd_ms = device_ms(lambda: fwd(False), flush)
    fwd_stored_ms = device_ms(lambda: fwd(True), flush)
    fwd_plain_ms = device_ms(lambda: lstm_kernel.lstm2_train_fwd_reference(
        x_tm, keep, l0, l1, store_gates=False), flush, reps=5)
    fwd_lib_ms = device_ms(lambda: lib(x_bt), flush)
    ms = device_ms(lambda: lstm_kernel.lstm2_bwd_chain_remat(*args), flush)
    stored_ms = device_ms(lambda: lstm_kernel.lstm2_bwd_chain(*stored_args), flush)
    plain_ms = device_ms(lambda: lstm_kernel.lstm2_bwd_chain_remat_reference(*args),
                         flush, reps=5)
    library_ms = device_ms(run_lib_bwd, flush)
    # the forward as row 11 counts it (its layer-0 projection included),
    # with 5H of residual stores per row instead of 13H
    fwd_flops = 2 * b * t * (d * 4 * h + 3 * h * 4 * h)
    fwd_bytes = 4 * (t * b * (d + h + 5 * h) + d * 4 * h + 3 * h * 4 * h
                     + 2 * 4 * h + 4 * b * h)
    fwd_bound_ms, fwd_bound_by = bound(fwd_flops, fwd_bytes)
    # the chain's three products per step plus the recompute of g0 (D + H
    # deep) and g1 (2H deep); packed, keep, x, x1, h0p, h1p, dh_final and the
    # weights read, dg0 and dg1 written
    flops = 2 * t * b * 4 * h * (3 * h + d + h + 2 * h)
    nbytes = 4 * (t * b * (2 * h + h + d + 3 * h + 8 * h) + b * h
                  + (d + 3 * h) * 4 * h + 2 * 4 * h)
    bound_ms, bound_by = bound(flops, nbytes)
    per, per_stored = 1e3 * ms / (t + 1), 1e3 * stored_ms / (t + 1)
    print(f"[lstm2_train_fwd_nogates] kernel {fwd_ms:.4f} ms ({1e3 * fwd_ms / (t + 1):.3f} "
          f"us per phase; the stored-gates form {fwd_stored_ms:.4f} ms), plain "
          f"{fwd_plain_ms:.4f} ms, cuDNN nn.LSTM training forward at keep=1 "
          f"{fwd_lib_ms:.4f} ms, bound {fwd_bound_ms:.4f} ms ({fwd_bound_by}: "
          f"{fwd_flops / 1e9:.3f} GFLOP, {fwd_bytes / 1e6:.2f} MB incl. the residual stores)")
    print(f"[lstm2_bwd_chain_remat] kernel {ms:.4f} ms (one cooperative cluster "
          f"launch, {t + 1} phases, {per:.3f} us per phase; the stored-gates chain "
          f"{stored_ms:.4f} ms, {per_stored:.3f} us per phase: the recompute costs "
          f"{per - per_stored:.3f} us per phase), plain {plain_ms:.4f} ms, cuDNN "
          f"backward of h_n at keep=1 {library_ms:.4f} ms (it also forms the weight "
          f"gradients), bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)")

    # the whole recurrence gradient at keep=1 on both routes: time, peak
    # memory (the residuals live from the forward to the backward)
    ones = torch.ones_like(keep)
    p0 = {k: v.clone().requires_grad_() for k, v in l0.items()}
    p1 = {k: v.clone().requires_grad_() for k, v in l1.items()}
    params = [*p0.values(), *p1.values()]

    def run_grad(remat):
        out = lstm_vjp.fused_lstm_final(x_bt, ones[:, None], (p0, p1), remat_gates=remat)
        return torch.autograd.grad(out, params, dh)

    whole = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = run_grad(remat)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e6
        whole[remat] = (grads, peak, device_ms(lambda: run_grad(remat), flush))
    grad_diff = max(float((a - s).abs().max() / s.abs().max())
                    for a, s in zip(whole[True][0], whole[False][0]))
    print(f"[lstm2_bwd_chain_remat] whole recurrence gradient at keep=1: remat "
          f"{whole[True][2]:.4f} ms, peak {whole[True][1]:.2f} MB above the inputs; "
          f"stored gates {whole[False][2]:.4f} ms, peak {whole[False][1]:.2f} MB; "
          f"gradients differ by {grad_diff:.3e} of each tensor's largest")
    if not grad_diff < 1e-3:
        raise RuntimeError("the remat route's gradient disagrees with the stored-gates route's")
    # the route exists to keep less: its residuals and the chain's blocks
    # (no buffer that grows with T beyond the outputs) below the gates'
    if not whole[True][1] < whole[False][1]:
        raise RuntimeError("the remat route's peak memory is not below the stored-gates route's")
    src = "multimodal_emotion_detection_tpu_torch/csrc/"
    return ({"name": "lstm2_train_fwd_nogates", "route": "cuda",
             "source": src + "lstm2_train_fwd.cu", "core": src + "rnn2_fwd_chain.cuh",
             "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:2270",
             "max_abs_err": max(fwd_errs.values()), "ms": fwd_ms,
             "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound_ms,
             "bound_by": fwd_bound_by, "library_ms": fwd_lib_ms},
            {"name": "lstm2_bwd_chain_remat", "route": "cuda",
             "source": src + "lstm2_bwd_chain_remat.cu", "core": src + "rnn2_bwd_chain.cuh",
             "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:2687",
             "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})



def _shifted(a: torch.Tensor) -> torch.Tensor:
    """The series before each step from the series after it."""
    return torch.cat([torch.zeros_like(a[:1]), a[:-1]])


def _largest_diff(outs, refs) -> float:
    """The largest of max |out - ref| / max |ref| over the pairs."""
    return max(float((o - r).abs().max() / r.abs().max().clamp(min=1e-30))
               for o, r in zip(outs, refs))


def _whole_grads(fused, x_bt, keep, layers, dh):
    """``fused``'s output cotangent ``dh`` pulled back to x and every
    parameter, and a callable that runs it again (for timing)."""
    x = x_bt.clone().requires_grad_()
    ps = [{k: v.clone().requires_grad_() for k, v in p.items()} for p in layers]
    params = [x] + [v for p in ps for v in p.values()]

    def run():
        return torch.autograd.grad(fused(x, keep[:, None], ps), params, dh)

    return run(), run


def _routes_agree(tag, names, legacy, residual, dx_bound=1e-6, dw_bound=1e-5):
    """The legacy route's gradient against the residual-native route's:
    dx within ``dx_bound`` of the largest |dx|, every weight gradient within
    ``dw_bound`` of its largest entry (the JAX package's gate between the
    two layouts, ``ops/envelope.py`` V2_VS_LEGACY_GRAD_REL, on dx)."""
    rel = {n: float((a - b).abs().max() / b.abs().max())
           for n, a, b in zip(names, legacy, residual)}
    exact = all(torch.equal(a, b) for a, b in zip(legacy, residual))
    print(f"[{tag}] legacy vs residual-native whole gradient, max abs diff "
          f"relative to the largest: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f" (bounds dx {dx_bound:g}, weights {dw_bound:g}); bit for bit: {exact}")
    if rel["dx"] > dx_bound or max(v for k, v in rel.items() if k != "dx") > dw_bound:
        raise RuntimeError(f"[{tag}] the legacy route's gradient disagrees with the "
                           "residual-native route's")
    return rel


def phase_lstm2_legacy(lstm_kernel, lstm_vjp, flush):
    """``[lstm2_train_fwd_legacy]`` / ``[lstm2_bwd_chain_legacy]``: rows 5 and
    9, the legacy-layout pair (``set_res2_mode("off")``, the 2-layer cores'
    legacy LSTM cells), at the flagship's training shape (B=32, T=372, D=64,
    H=256, keep p=0.1).  Each kernel against its plain version (the chain
    with and without ``dys``) at B 32, 17 and 1; against the residual-native
    pair (rows 11 and 12) on the same inputs; times and µs per phase
    beside theirs in the same phase, the plain versions' and cuDNN's; the
    whole recurrence gradient on both routes, held to each other, and
    timed."""
    x_tm, keep, l0, l1 = _lstm_train_inputs(12)
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    outs = lstm_kernel.lstm2_train_fwd_legacy(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    refs = lstm_kernel.lstm2_train_fwd_legacy_reference(x_tm, keep, l0, l1)
    fwd_errs = {}
    for name, out, ref in zip(("ys", "h_final", "g0", "g1", "h0_new", "c0_new",
                               "c1_new"), outs, refs):
        fwd_errs[name] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)
    packed, h0p, h1p, _, finals = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1)
    ys, h_final, g0, g1, h0, c0, c1 = outs
    # the residual-native form: the same core and plan, another store layout
    diff = _largest_diff(
        (g0, g1, _shifted(c0), _shifted(c1), _shifted(h0), _shifted(ys), h_final),
        (packed[..., :4 * h], packed[..., 4 * h:8 * h], packed[..., 8 * h:9 * h],
         packed[..., 9 * h:], h0p, h1p, finals[2]))
    print(f"[lstm2_train_fwd_legacy] B={b} T={t} D={d} H={h}, keep p=0.1: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in fwd_errs.items())
          + f" (bound 1e-4 abs + 1e-4 rel); against the residual-native form's gates "
          f"and shifted series, max abs diff relative to the largest {diff:.3e}")

    rng = np.random.RandomState(13)
    dh = torch.from_numpy(rng.randn(b, h).astype(np.float32)).cuda()
    dys = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).cuda()
    # the chain's inputs as the legacy route builds them: the gate series
    # (views of the forward's 12H rows) and the shifted c series
    cp0, cp1 = _shifted(c0), _shifted(c1)
    w = (l0["w_hh"], l1["w_hh"], l1["w_ih"])
    errs = {}
    for label, stream in (("", None), (" with dys", dys)):
        args = (g0, g1, cp0, cp1, stream, keep, dh, *w)
        dgs = lstm_kernel.lstm2_bwd_chain_legacy(*args)
        torch.cuda.synchronize()
        for name, out, ref in zip(("dg0", "dg1"), dgs,
                                  lstm_kernel.lstm2_bwd_chain_legacy_reference(*args)):
            errs[name + label] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name + label)
    # one row (two row groups, one empty) and 17 rows (5 a group): both
    # kernels, the chain with dys, on the first rows of the same inputs
    for rows in (17, 1):
        sub = (x_tm[:, :rows].contiguous(), keep[:, :rows].contiguous(), l0, l1)
        outs_b = lstm_kernel.lstm2_train_fwd_legacy(*sub)
        torch.cuda.synchronize()
        refs_b = lstm_kernel.lstm2_train_fwd_legacy_reference(*sub)
        for name, out, ref in zip(("ys", "h_final", "g0", "g1", "h0_new", "c0_new",
                                   "c1_new"), outs_b, refs_b):
            fwd_errs[f"{name} B={rows}"] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                       msg=f"{name} B={rows}")
        args = (outs_b[2], outs_b[3], _shifted(outs_b[5]), _shifted(outs_b[6]),
                dys[:, :rows].contiguous(), sub[1], dh[:rows].contiguous(), *w)
        for name, out, ref in zip(("dg0", "dg1"), lstm_kernel.lstm2_bwd_chain_legacy(*args),
                                  lstm_kernel.lstm2_bwd_chain_legacy_reference(*args)):
            errs[f"{name} with dys B={rows}"] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                       msg=f"{name} with dys B={rows}")
    print(f"[lstm2_train_fwd_legacy] B 17 and 1: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in fwd_errs.items() if "B=" in k)
          + " (bound 1e-4 abs + 1e-4 rel)")
    res_args = (packed, keep, dh, *w)
    # the residual-native chain (row 12): the same core and plan over
    # another layout
    vs_res = {name: float((a - r).abs().max() / r.abs().max()) for name, a, r in zip(
        ("dg0", "dg1"),
        lstm_kernel.lstm2_bwd_chain_legacy(g0, g1, cp0, cp1, None, keep, dh, *w),
        lstm_kernel.lstm2_bwd_chain(*res_args))}
    print(f"[lstm2_bwd_chain_legacy] B={b} T={t} H={h}: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (bound 1e-4 abs + 1e-4 rel); against the residual-native chain's dg, max "
          "abs diff relative to the largest "
          + ", ".join(f"{k} {v:.3e}" for k, v in vs_res.items()) + " (bound 1e-5)")
    if max(vs_res.values()) > 1e-5:
        raise RuntimeError("the legacy LSTM chain disagrees with the residual-native one")
    for rows in (b, 17, 1):
        print("[lstm2_train_fwd_legacy] " + _chain_plan_text(
            lstm_kernel, "lstm2_train_fwd_legacy", 4, h, rows, True, 2))
        print("[lstm2_bwd_chain_legacy] " + _chain_plan_text(
            lstm_kernel, "lstm2_bwd_chain_legacy", 4, h, rows, layers=2))

    lib = _cudnn_lstm(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()
    lib_params = list(lib.parameters())
    h_lib = lib(x_bt)[1][0][-1]

    def run_lib_bwd():
        torch.autograd.grad(h_lib, lib_params, dh, retain_graph=True)

    fwd_ms = device_ms(lambda: lstm_kernel.lstm2_train_fwd_legacy(x_tm, keep, l0, l1), flush)
    fwd_res_ms = device_ms(
        lambda: lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1), flush)
    fwd_plain_ms = device_ms(
        lambda: lstm_kernel.lstm2_train_fwd_legacy_reference(x_tm, keep, l0, l1),
        flush, reps=5)
    fwd_lib_ms = device_ms(lambda: lib(x_bt), flush)
    chain = (g0, g1, cp0, cp1)
    ms = device_ms(lambda: lstm_kernel.lstm2_bwd_chain_legacy(*chain, None, keep, dh, *w),
                   flush)
    ms_dys = device_ms(lambda: lstm_kernel.lstm2_bwd_chain_legacy(*chain, dys, keep, dh, *w),
                       flush)
    res_ms = device_ms(lambda: lstm_kernel.lstm2_bwd_chain(*res_args), flush)
    plain_ms = device_ms(lambda: lstm_kernel.lstm2_bwd_chain_legacy_reference(
        *chain, None, keep, dh, *w), flush, reps=5)
    library_ms = device_ms(run_lib_bwd, flush)
    # the forward as rows 11 counts it (its layer-0 projection included),
    # with the legacy layout's 12H of stores per row and h_final
    fwd_flops = 2 * b * t * (d * 4 * h + 3 * h * 4 * h)
    fwd_bytes = 4 * (t * b * (d + h + 12 * h) + d * 4 * h + 3 * h * 4 * h
                     + 2 * 4 * h + b * h)
    fwd_bound_ms, fwd_bound_by = bound(fwd_flops, fwd_bytes)
    # the chain without dys: g0, g1, c0_prev, c1_prev, keep, dh_final and
    # three weights read, dg (8H) written
    flops = 2 * b * t * 3 * 4 * h * h
    nbytes = 4 * (t * b * (8 * h + 2 * h + h + 8 * h) + b * h + 3 * h * 4 * h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[lstm2_train_fwd_legacy] kernel {fwd_ms:.4f} ms (input projection + one "
          f"cooperative cluster launch, {1e3 * fwd_ms / (t + 1):.3f} us per phase; the "
          f"residual-native form (row 11) {fwd_res_ms:.4f} ms, "
          f"{1e3 * fwd_res_ms / (t + 1):.3f} us per phase, in this phase), plain "
          f"{fwd_plain_ms:.4f} ms, cuDNN nn.LSTM training forward at keep=1 "
          f"{fwd_lib_ms:.4f} ms, bound {fwd_bound_ms:.4f} ms ({fwd_bound_by}: "
          f"{fwd_flops / 1e9:.3f} GFLOP, {fwd_bytes / 1e6:.2f} MB incl. the 12H stores)")
    print(f"[lstm2_bwd_chain_legacy] kernel {ms:.4f} ms (the series' pack and one "
          f"cooperative cluster launch, {1e3 * ms / (t + 1):.3f} us per phase; "
          f"{ms_dys:.4f} ms with dys; the residual-native chain (row 12) {res_ms:.4f} ms, "
          f"{1e3 * res_ms / (t + 1):.3f} us per phase, in this phase), plain "
          f"{plain_ms:.4f} ms, cuDNN backward of h_n at keep=1 "
          f"{library_ms:.4f} ms (it also forms the weight gradients), bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")

    # the whole recurrence gradient at keep p=0.1 on both routes, same inputs
    names = ("dx", "dw_ih0", "dw_hh0", "db0", "dw_ih1", "dw_hh1", "db1")
    whole = {}
    for mode in ("off", "auto"):
        prev = lstm_vjp.set_res2_mode(mode)
        try:
            grads, run = _whole_grads(lstm_vjp.fused_lstm_final, x_bt, keep, (l0, l1), dh)
            whole[mode] = (grads, device_ms(run, flush))
        finally:
            lstm_vjp.set_res2_mode(prev)
    _routes_agree("lstm2_bwd_chain_legacy", names, whole["off"][0], whole["auto"][0])
    print(f"[lstm2_bwd_chain_legacy] whole recurrence gradient (forward + reverse chain "
          f"+ hoisted weight products): legacy {whole['off'][1]:.4f} ms, residual-native "
          f"{whole['auto'][1]:.4f} ms")
    src = "multimodal_emotion_detection_tpu_torch/csrc/"
    return ({"name": "lstm2_train_fwd_legacy", "route": "cuda",
             "source": src + "lstm2_train_fwd_legacy.cu", "core": src + "rnn2_fwd_chain.cuh",
             "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:669",
             "max_abs_err": max(fwd_errs.values()), "ms": fwd_ms,
             "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound_ms,
             "bound_by": fwd_bound_by, "library_ms": fwd_lib_ms},
            {"name": "lstm2_bwd_chain_legacy", "route": "cuda",
             "source": src + "lstm2_bwd_chain_legacy.cu", "core": src + "rnn2_bwd_chain.cuh",
             "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:1685",
             "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})

def _big_layer_inputs(seed: int, gates: int = 4):
    """One layer of the big sweep config at its training shape (B=32,
    T=372, H=512) with ``gates`` gates (4 for the LSTM, 3 for the GRU): the
    layer-0 input (log-mel, D=64) and a deeper layer's (D=512, an h series
    times a keep mask), both layers' w_ih and input bias, and one w_hh."""
    dev = torch.device("cuda")
    b, t, h = 32, 372, 512
    g = gates * h
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)

    def u(*shape, lim=k):
        return torch.from_numpy(rng.uniform(-lim, lim, shape).astype(np.float32)).to(dev)

    x0 = torch.from_numpy(rng.randn(t, b, 64).astype(np.float32)).to(dev)
    x1 = u(t, b, h, lim=1.0)
    return {"D=64": (x0, u(64, g), u(g)), "D=512": (x1, u(h, g), u(g))}, u(h, g)


def phase_lstm1_train_fwd(lstm_kernel, flush):
    inputs, w_hh = _big_layer_inputs(5)
    t, b, _ = inputs["D=64"][0].shape
    h = w_hh.shape[0]
    errs, eval_errs = {}, {}
    for label, (x, w_ih, bias) in inputs.items():
        ih = torch.matmul(x, w_ih) + bias
        outs = lstm_kernel.lstm1_train_fwd(ih, w_hh)
        torch.cuda.synchronize()
        refs = lstm_kernel.lstm1_train_fwd_reference(ih, w_hh)
        for name, out, ref in zip(("g", "h_prev", "c_prev", "finals"), outs, refs):
            errs[f"{name} {label}"] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-4, msg=name)
        for series in (True, False):
            out = lstm_kernel.lstm1_infer(ih, w_hh, series)
            torch.cuda.synchronize()
            ref = lstm_kernel.lstm1_infer_reference(ih, w_hh, series)
            eval_errs[f"{'series' if series else 'final'} {label}"] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    print(f"[lstm1_train_fwd] B={b} T={t} H={h}, input D=64 and D=512: max abs "
          "err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (bound 1e-4 abs)")
    print("[lstm1_infer] eval form: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in eval_errs.items())
          + " (bound 1e-4 abs)")

    # timed at a deeper layer's shape; the input projection is outside
    # the kernel on this route (one torch.matmul between launches)
    x, w_ih, bias = inputs["D=512"]
    ih = torch.matmul(x, w_ih) + bias
    lib = _cudnn_lstm({"w_ih": w_ih, "w_hh": w_hh, "b": bias}, batch_first=False)

    def run_lib_train():
        lib(x)  # training forward with autograd: saves what backward needs

    def run_lib_eval():
        with torch.no_grad():
            lib(x)

    ms = device_ms(lambda: lstm_kernel.lstm1_train_fwd(ih, w_hh), flush)
    plain_ms = device_ms(lambda: lstm_kernel.lstm1_train_fwd_reference(ih, w_hh),
                         flush, reps=5)
    library_ms = device_ms(run_lib_train, flush)
    eval_ms = device_ms(lambda: lstm_kernel.lstm1_infer(ih, w_hh, True), flush)
    eval_final_ms = device_ms(lambda: lstm_kernel.lstm1_infer(ih, w_hh, False), flush)
    eval_plain_ms = device_ms(
        lambda: lstm_kernel.lstm1_infer_reference(ih, w_hh, True), flush, reps=5)
    eval_library_ms = device_ms(run_lib_eval, flush)
    # the b1 serving forward's eval forms: two row groups, one of them
    # empty, a plan the B=32 checks above never run
    ih1 = ih[:, :1].contiguous()
    for series in (True, False):
        out = lstm_kernel.lstm1_infer(ih1, w_hh, series)
        torch.cuda.synchronize()
        ref = lstm_kernel.lstm1_infer_reference(ih1, w_hh, series)
        eval_errs[f"{'series' if series else 'final'} B=1"] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    print("[lstm1_infer] eval form at B=1 (D=512 input): max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in eval_errs.items() if "B=1" in k)
          + " (bound 1e-4 abs)")
    b1_ms = device_ms(lambda: lstm_kernel.lstm1_infer(ih1, w_hh, False), flush)
    # ih and w_hh read; g, h_prev, c_prev and finals written
    flops, nbytes = _work("lstm1_train_fwd", b, t, 0, h)
    bound_ms, bound_by = bound(flops, nbytes)
    # ih and w_hh read; the h series written
    eval_bytes = 4 * (t * b * 4 * h + h * 4 * h + t * b * h)
    eval_bound_ms, eval_bound_by = bound(flops, eval_bytes)
    print(f"[lstm1_train_fwd] {_chain_plan_text(lstm_kernel, 'lstm1_fwd', 4, h, b, True)}")
    print(f"[lstm1_infer] {_chain_plan_text(lstm_kernel, 'lstm1_fwd', 4, h, 1, True)}")
    print(f"[lstm1_train_fwd] kernel {ms:.4f} ms (one cooperative cluster launch, {t} "
          f"split grid barriers, {1e3 * ms / t:.3f} us per step), plain {plain_ms:.4f} "
          f"ms, cuDNN nn.LSTM({h}, {h}) training forward (input projection "
          f"included) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB incl. the residual stores)")
    print(f"[lstm1_infer] kernel {eval_ms:.4f} ms with the h series out, "
          f"{eval_final_ms:.4f} ms final h only ({1e3 * eval_ms / t:.3f} us per "
          f"step), B=1 final h {b1_ms:.4f} ms, plain {eval_plain_ms:.4f} ms, "
          f"cuDNN nn.LSTM({h}, {h}) "
          f"inference forward {eval_library_ms:.4f} ms, bound {eval_bound_ms:.4f} ms "
          f"({eval_bound_by}: {flops / 1e9:.3f} GFLOP, {eval_bytes / 1e6:.2f} MB)")
    source, core = CSRC + "lstm1_fwd.cu", CSRC + "rnn_fwd_chain.cuh"
    train_kern = {"name": "lstm1_train_fwd", "route": "cuda", "source": source,
                  "core": core,
                  "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:1078",
                  "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": library_ms}
    eval_kern = {"name": "lstm1_infer", "route": "cuda", "source": source,
                 "core": core,
                 "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:1078",
                 "max_abs_err": max(eval_errs.values()), "ms": eval_ms,
                 "plain_ms": eval_plain_ms, "bound_ms": eval_bound_ms,
                 "bound_by": eval_bound_by, "library_ms": eval_library_ms}
    return train_kern, eval_kern, (inputs, w_hh)


def _chain_plan_text(lstm_kernel, source, width, h, b, forward=False, layers=1,
                     remat_d=0):
    """The launch plan of a one-layer reverse chain (csrc/rnn_bwd_chain.cuh)
    or forward (csrc/rnn_fwd_chain.cuh), or of a 2-layer one
    (csrc/rnn2_bwd_chain.cuh, csrc/rnn2_fwd_chain.cuh; ``remat_d`` the
    remat chain's padded D), on this card."""
    plan = lstm_kernel.chain_plan_on(source, width, h, b, torch.device("cuda"), forward,
                                     layers, remat_d)
    row = "H" if forward else f"{plan.width}H"
    sets = (f"{plan.ctas} CTAs ({plan.grid} a layer: the lead set's row {row}, the "
            f"follow set's [own {row} | feed {row}])" if layers == 2 else f"{plan.grid} CTAs")
    return (f"launch plan at B={b} H={h}: UPC {plan.upc}, {sets} in "
            f"clusters of {plan.ncl}, {plan.rgroups} row groups "
            f"({plan.rgroups * plan.upc} units a CTA, {plan.outputs} sums a cluster), "
            f"{plan.smem} bytes of shared memory per CTA, chunks of {plan.kc} float4 "
            f"columns" + (f", gate blocks of {plan.rk} steps" if plan.rk else "")
            + (f", one launch a slice of {plan.batch_slice} rows" if plan.batch_slice
               else ""))



def phase_lstm_bwd_chain(lstm_kernel, lstm_vjp, flush, layer_inputs):
    inputs, w_hh = layer_inputs
    x, w_ih, bias = inputs["D=512"]
    t, b, _ = x.shape
    h = w_hh.shape[0]
    g, _, c_prev, _ = lstm_kernel.lstm1_train_fwd_reference(
        torch.matmul(x, w_ih) + bias, w_hh)
    rng = np.random.RandomState(6)
    dhf = torch.from_numpy(rng.randn(b, h).astype(np.float32)).cuda()
    dhs = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).cuda()
    errs = {}
    for label, series in (("dh_series given", dhs), ("dh_series None", None)):
        out = lstm_kernel.lstm_bwd_chain(g, c_prev, series, dhf, w_hh)
        torch.cuda.synchronize()
        ref = lstm_kernel.lstm_bwd_chain_reference(g, c_prev, series, dhf, w_hh)
        errs[label] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4, msg=label)
    print(f"[lstm_bwd_chain] B={b} T={t} H={h}: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (bound 1e-4 abs)")

    lib = _cudnn_lstm({"w_ih": w_ih, "w_hh": w_hh, "b": bias}, batch_first=False)
    lib_params = list(lib.parameters())
    h_lib = lib(x)[1][0][-1]

    def run_lib_bwd():
        torch.autograd.grad(h_lib, lib_params, dhf, retain_graph=True)

    # a lower layer's chain (dh_series from the layer above), and the top
    # layer's (none)
    ms = device_ms(lambda: lstm_kernel.lstm_bwd_chain(g, c_prev, dhs, dhf, w_hh), flush)
    top_ms = device_ms(lambda: lstm_kernel.lstm_bwd_chain(g, c_prev, None, dhf, w_hh),
                       flush)
    plain_ms = device_ms(
        lambda: lstm_kernel.lstm_bwd_chain_reference(g, c_prev, dhs, dhf, w_hh),
        flush, reps=5)
    library_ms = device_ms(run_lib_bwd, flush)
    # g, c_prev, dh_series, dh_final and w_hh read; dgates written
    flops, nbytes = _work("lstm_bwd_chain", b, t, 0, h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[lstm_bwd_chain] {_chain_plan_text(lstm_kernel, 'lstm_bwd_chain', 4, h, b)}")
    print(f"[lstm_bwd_chain] kernel {ms:.4f} ms with dh_series, {top_ms:.4f} ms "
          f"without (one cooperative cluster launch, {t} split grid barriers, "
          f"{1e3 * ms / t:.3f} us per step), plain {plain_ms:.4f} ms, cuDNN "
          f"backward of h_n for nn.LSTM({h}, {h}) {library_ms:.4f} ms (it also "
          f"forms the weight gradients), bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")

    # the whole 3-layer recurrence gradient at keep=1 (3 forwards, 3
    # chains, the hops and the hoisted weight products) against cuDNN's
    # 3-layer forward + backward on the same weights
    x0 = inputs["D=64"][0].transpose(0, 1).contiguous()  # (B, T, 64)
    d = x0.shape[2]
    k = 1.0 / np.sqrt(h)
    layers = [{name: torch.from_numpy(
        rng.uniform(-k, k, shape).astype(np.float32)).cuda().requires_grad_()
        for name, shape in (("w_ih", (d if i == 0 else h, 4 * h)),
                            ("w_hh", (h, 4 * h)), ("b", (4 * h,)))}
        for i in range(3)]
    ours_params = [p[n] for p in layers for n in ("w_ih", "w_hh", "b")]
    ones = torch.ones((t, 2, b, h), device="cuda")
    lib3 = _cudnn_lstm(*layers)
    lib3_params = list(lib3.parameters())

    def run_ours_grad():
        out = lstm_vjp.fused_lstm_final(x0, ones, layers)
        return torch.autograd.grad(out, ours_params, dhf)

    def run_lib_grad():
        return torch.autograd.grad(lib3(x0)[1][0][-1], lib3_params, dhf)

    g_ours, g_lib = run_ours_grad(), run_lib_grad()
    # cuDNN keeps (4H, D) matrices: compare dW_hh of layer 2 (ours (H, 4H))
    grad_err = float((g_ours[7] - g_lib[9].T).abs().max() / g_lib[9].abs().max())
    whole_ms = device_ms(run_ours_grad, flush)
    whole_lib_ms = device_ms(run_lib_grad, flush)
    print(f"[lstm_bwd_chain] whole 3-layer recurrence gradient (3 forwards + 3 "
          f"reverse chains + hops + hoisted weight products) {whole_ms:.4f} ms vs "
          f"cuDNN nn.LSTM({d}, {h}, num_layers=3) forward + backward "
          f"{whole_lib_ms:.4f} ms; dW_hh2 relative to cuDNN's {grad_err:.3e}")
    if not grad_err < 1e-3:
        raise RuntimeError("the layered recurrence gradient disagrees with cuDNN's")
    return {"name": "lstm_bwd_chain", "route": "cuda",
            "source": CSRC + "lstm_bwd_chain.cu", "core": CSRC + "rnn_bwd_chain.cuh",
            "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:514",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def _gru_inputs(seed: int):
    """The GRU config's training shape (log-mel 64, GRU 2x256, batch 32):
    time-major x, keep mask at dropout 0.1, both layers' weights."""
    dev = torch.device("cuda")
    b, t, d, h = 32, 372, 64, 256
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)

    def layer(d_in):
        return {name: torch.from_numpy(
            rng.uniform(-k, k, shape).astype(np.float32)).to(dev)
            for name, shape in (("w_ih", (d_in, 3 * h)), ("w_hh", (h, 3 * h)),
                                ("b_ih", (3 * h,)), ("b_hh", (3 * h,)))}

    l0, l1 = layer(d), layer(h)
    x_tm = torch.from_numpy(rng.randn(t, b, d).astype(np.float32)).to(dev)
    keep = torch.from_numpy(
        ((rng.rand(t, b, h) < 0.9) / 0.9).astype(np.float32)).to(dev)
    return x_tm, keep, l0, l1


def _cudnn_gru(*layers, batch_first: bool = True):
    """Yardstick only, never called by the port: cuDNN's GRU with the same
    layers' weights (torch keeps (3H, D) matrices; gate order r, z, n and
    b_hh inside the reset product, as the port's)."""
    d, h = layers[0]["w_ih"].shape[0], layers[0]["w_hh"].shape[0]
    lib = torch.nn.GRU(d, h, num_layers=len(layers), batch_first=batch_first).cuda()
    with torch.no_grad():
        for i, p in enumerate(layers):
            getattr(lib, f"weight_ih_l{i}").copy_(p["w_ih"].T)
            getattr(lib, f"weight_hh_l{i}").copy_(p["w_hh"].T)
            getattr(lib, f"bias_ih_l{i}").copy_(p["b_ih"])
            getattr(lib, f"bias_hh_l{i}").copy_(p["b_hh"])
    return lib.train()


def phase_gru2_infer(lstm_kernel, flush):
    x_tm, _, l0, l1 = _gru_inputs(7)
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    x = x_tm.transpose(0, 1).contiguous()
    out = lstm_kernel.gru2_infer(x, l0, l1)
    torch.cuda.synchronize()
    ref = lstm_kernel.gru2_infer_reference(x, l0, l1)
    abs_err, rel_err = max_errs(out, ref)
    print(f"[gru2_infer] B={b} T={t} D={d} H={h}: max abs err {abs_err:.3e}, "
          f"max rel err {rel_err:.3e} (bound 1e-4 abs on h1)")
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    x1 = x[:1].contiguous()
    out1 = lstm_kernel.gru2_infer(x1, l0, l1)
    ref1 = lstm_kernel.gru2_infer_reference(x1, l0, l1)
    a1, _ = max_errs(out1, ref1)
    print(f"[gru2_infer] B=1: max abs err {a1:.3e}")
    torch.testing.assert_close(out1, ref1, rtol=0, atol=1e-4)
    for rows in (b, 1):
        print(f"[gru2_infer] {_chain_plan_text(lstm_kernel, 'gru2_infer', 3, h, rows, True, 2)}")

    lib = _cudnn_gru(l0, l1)
    with torch.no_grad():
        lib_err, _ = max_errs(lib(x)[1][-1], ref)
    print(f"[gru2_infer] torch.nn.GRU (cuDNN) vs plain: max abs err {lib_err:.3e}")

    def run_lib():
        with torch.no_grad():
            lib(x)

    ms = device_ms(lambda: lstm_kernel.gru2_infer(x, l0, l1), flush)
    plain_ms = device_ms(lambda: lstm_kernel.gru2_infer_reference(x, l0, l1),
                         flush, reps=5)
    library_ms = device_ms(run_lib, flush)
    ms_b1 = device_ms(lambda: lstm_kernel.gru2_infer(x1, l0, l1), flush)
    # x, the four weight matrices and four biases read; h1 written
    flops, nbytes = _work("gru2_infer", b, t, d, h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[gru2_infer] kernel {ms:.4f} ms (input projection + one cooperative "
          f"cluster launch, {t + 1} phases, {1e3 * ms / (t + 1):.3f} us per phase), "
          f"plain {plain_ms:.4f} ms, cuDNN nn.GRU inference forward {library_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB; serial chain of {2 * t} layer-steps)")
    print(f"[gru2_infer] B=1 kernel {ms_b1:.4f} ms ({1e3 * ms_b1 / (t + 1):.3f} us "
          "per barrier phase)")
    return {"name": "gru2_infer", "route": "cuda",
            "source": "multimodal_emotion_detection_tpu_torch/csrc/gru2_infer.cu",
            "core": CSRC + "rnn2_fwd_chain.cuh",
            "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:204",
            "max_abs_err": max(abs_err, a1), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_gru2_train_fwd(lstm_kernel, flush):
    x_tm, keep, l0, l1 = _gru_inputs(8)
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    outs = lstm_kernel.gru2_train_fwd_residuals(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    refs = lstm_kernel.gru2_train_fwd_reference(x_tm, keep, l0, l1)
    errs = {}
    for name, out, ref in zip(("packed", "h0_prev", "h1_prev", "x1", "finals"),
                              outs, refs):
        errs[name] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)
    print(f"[gru2_train_fwd] B={b} T={t} D={d} H={h}, keep p=0.1: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (bound 1e-4 abs + 1e-4 rel)")
    print(f"[gru2_train_fwd] "
          f"{_chain_plan_text(lstm_kernel, 'gru2_train_fwd', 3, h, b, True, 2)}")

    lib = _cudnn_gru(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()

    def run_lib():
        lib(x_bt)  # training forward with autograd: saves what backward needs

    ms = device_ms(lambda: lstm_kernel.gru2_train_fwd_residuals(x_tm, keep, l0, l1),
                   flush)
    plain_ms = device_ms(
        lambda: lstm_kernel.gru2_train_fwd_reference(x_tm, keep, l0, l1),
        flush, reps=5)
    library_ms = device_ms(run_lib, flush)
    # x, keep, weights and biases read; packed (8H), h0_prev, h1_prev, x1
    # and finals written
    flops, nbytes = _work("gru2_train_fwd", b, t, d, h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[gru2_train_fwd] kernel {ms:.4f} ms (input projection + one "
          f"cooperative cluster launch, {t + 1} phases, "
          f"{1e3 * ms / (t + 1):.3f} us per phase), plain {plain_ms:.4f} ms, "
          f"cuDNN nn.GRU training forward at keep=1 {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB incl. the residual stores)")
    kern = {"name": "gru2_train_fwd", "route": "cuda",
            "source": "multimodal_emotion_detection_tpu_torch/csrc/gru2_train_fwd.cu",
            "core": CSRC + "rnn2_fwd_chain.cuh",
            "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:2812",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    return kern, (x_tm, keep, l0, l1, refs)


def phase_gru2_bwd_chain(lstm_kernel, lstm_vjp, flush, inputs):
    x_tm, keep, l0, l1, refs = inputs
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    dh = torch.from_numpy(np.random.RandomState(9).randn(b, h).astype(np.float32)).cuda()
    args = (*refs[:3], keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    outs = lstm_kernel.gru2_bwd_chain(*args)
    torch.cuda.synchronize()
    errs = {}
    for name, out, ref in zip(("dih0", "dhn0", "dih1", "dhn1"), outs,
                              lstm_kernel.gru2_bwd_chain_reference(*args)):
        errs[name] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name)
    # one row (the plan's two row groups, one empty) and 17 rows (a second
    # pass of rows in a group)
    for rows in (1, 17):
        sub = (*(a[:, :rows].contiguous() for a in (*refs[:3], keep)),
               dh[:rows].contiguous(), l0["w_hh"], l1["w_hh"], l1["w_ih"])
        outs = lstm_kernel.gru2_bwd_chain(*sub)
        torch.cuda.synchronize()
        for name, out, ref in zip(("dih0", "dhn0", "dih1", "dhn1"), outs,
                                  lstm_kernel.gru2_bwd_chain_reference(*sub)):
            errs[f"{name} B={rows}"] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4,
                                       msg=f"{name} B={rows}")
    print(f"[gru2_bwd_chain] B={b} T={t} H={h}: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (bound 1e-4 abs + 1e-4 rel)")
    for rows in (b, 17, 1):
        print(f"[gru2_bwd_chain] "
              f"{_chain_plan_text(lstm_kernel, 'gru2_bwd_chain', 3, h, rows, layers=2)}")

    lib = _cudnn_gru(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()
    lib_params = list(lib.parameters())
    h_lib = lib(x_bt)[1][-1]

    def run_lib_bwd():
        torch.autograd.grad(h_lib, lib_params, dh, retain_graph=True)

    ms = device_ms(lambda: lstm_kernel.gru2_bwd_chain(*args), flush)
    plain_ms = device_ms(lambda: lstm_kernel.gru2_bwd_chain_reference(*args),
                         flush, reps=5)
    library_ms = device_ms(run_lib_bwd, flush)
    # packed (8H), h0_prev, h1_prev, keep, dh_final and three weights read;
    # dih0, dih1 (3H) and dhn0, dhn1 written
    flops, nbytes = _work("gru2_bwd_chain", b, t, d, h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[gru2_bwd_chain] kernel {ms:.4f} ms (one cooperative cluster launch, "
          f"{t + 1} phases, {1e3 * ms / (t + 1):.3f} us per phase), plain "
          f"{plain_ms:.4f} ms, cuDNN backward of h_n at keep=1 {library_ms:.4f} ms "
          "(it also forms the weight gradients), bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)")

    # the whole recurrence gradient at keep=1: the kernel pair plus the
    # hoisted weight-gradient products, against cuDNN forward + backward
    ones = torch.ones_like(keep)
    p0 = {k: v.clone().requires_grad_() for k, v in l0.items()}
    p1 = {k: v.clone().requires_grad_() for k, v in l1.items()}
    ours_params = [*p0.values(), *p1.values()]

    def run_ours_grad():
        out = lstm_vjp.fused_gru_final(x_bt, ones[:, None], (p0, p1))
        return torch.autograd.grad(out, ours_params, dh)

    def run_lib_grad():
        return torch.autograd.grad(lib(x_bt)[1][-1], lib_params, dh)

    g_ours, g_lib = run_ours_grad(), run_lib_grad()
    # cuDNN keeps (3H, H) matrices: compare dW_hh of layer 1 (ours (H, 3H)),
    # and db_hh of layer 1, whose n third differs from db_ih's
    grad_err = float((g_ours[5] - g_lib[5].T).abs().max() / g_lib[5].abs().max())
    bias_err = float((g_ours[7] - g_lib[7]).abs().max() / g_lib[7].abs().max())
    whole_ms = device_ms(run_ours_grad, flush)
    whole_lib_ms = device_ms(run_lib_grad, flush)
    print(f"[gru2_bwd_chain] whole recurrence gradient (forward + reverse chain "
          f"+ hoisted weight products) {whole_ms:.4f} ms vs cuDNN forward + "
          f"backward {whole_lib_ms:.4f} ms; dW_hh1 relative to cuDNN's "
          f"{grad_err:.3e}, db_hh1 {bias_err:.3e}")
    if not (grad_err < 1e-3 and bias_err < 1e-3):
        raise RuntimeError("the GRU recurrence gradient disagrees with cuDNN's")
    return {"name": "gru2_bwd_chain", "route": "cuda",
            "source": "multimodal_emotion_detection_tpu_torch/csrc/gru2_bwd_chain.cu",
            "core": CSRC + "rnn2_bwd_chain.cuh",
            "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:3053",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}



def _gru_legacy_fwd_checked(lstm_kernel, sub, errs, tag=""):
    """Row 8 on ``sub`` = (x_tm, keep, l0, l1) against its plain version
    (1e-4 abs + 1e-4 rel, the errors into ``errs``) and bit for bit against
    row 14 on the same inputs on r, z, n, hn and h (one cell arithmetic,
    one plan); returns row 8's result."""
    out = lstm_kernel.gru2_train_fwd_legacy(*sub)
    torch.cuda.synchronize()
    ref = lstm_kernel.gru2_train_fwd_legacy_reference(*sub)
    names = ("ys", "h_final") + tuple(f"{n}{i}" for i in range(2)
                                      for n in ("r", "z", "n", "hn", "h"))
    for name, o, r in zip(names, (*out[:2], *out[2][0], *out[2][1]),
                          (*ref[:2], *ref[2][0], *ref[2][1])):
        errs[name + tag] = max_errs(o, r)[0]
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4, msg=name + tag)
    h = out[1].shape[-1]
    packed, h0p, h1p, _, finals = lstm_kernel.gru2_train_fwd_residuals(*sub)
    layers = out[2]
    same = all(torch.equal(a, r) for a, r in zip(
        [torch.cat(layers[i][:4], dim=-1) for i in range(2)]
        + [_shifted(layers[i][4]) for i in range(2)] + [out[1]],
        [packed[..., 4 * h * i:4 * h * (i + 1)] for i in range(2)] + [h0p, h1p, finals[1]]))
    if not same:
        raise RuntimeError(f"row 8 differs from row 14 on the same inputs{tag}")
    return out


def phase_gru2_legacy(lstm_kernel, lstm_vjp, flush):
    """``[gru2_train_fwd_legacy]`` / ``[gru2_bwd_chain_legacy]``: rows 8 and
    10, the legacy-layout GRU pair (the 2-layer cores' legacy GRU cells), at
    the GRU config's training shape (B=32, T=372, D=64, H=256, keep p=0.1).
    Each kernel against its plain version (the chain with and without
    ``dys``; the forward at B 32, 17 and 1, there bit for bit against row
    14 on the shared lanes); the plans; times and µs per phase beside the
    residual-native pair's (rows 14 and 15) on the same inputs in the same
    phase, the plain versions' and cuDNN's; row 10 against the layered
    backward over the same residuals (two row-7 launches and the hop:
    ``GRU_BWD2_ENABLED`` off, the JAX package's default) in value and time;
    the whole recurrence gradient on the legacy routes against the
    residual-native one."""
    x_tm, keep, l0, l1 = _gru_inputs(14)
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    fwd_errs = {}
    ys, h_final, layers = _gru_legacy_fwd_checked(lstm_kernel, (x_tm, keep, l0, l1),
                                                  fwd_errs)
    # 17 rows (5 a row group) and one row (two row groups, one empty)
    for rows in (17, 1):
        _gru_legacy_fwd_checked(lstm_kernel, (x_tm[:, :rows].contiguous(),
                                              keep[:, :rows].contiguous(), l0, l1),
                                fwd_errs, f" B={rows}")
    print(f"[gru2_train_fwd_legacy] B={b} T={t} D={d} H={h}, keep p=0.1, and B 17 and 1: "
          "max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in fwd_errs.items())
          + " (bound 1e-4 abs + 1e-4 rel); r, z, n, hn, the shifted h series and h_final "
          "bit for bit the residual-native form's (row 14) on the same inputs")
    for rows in (b, 17, 1):
        print("[gru2_train_fwd_legacy] " + _chain_plan_text(
            lstm_kernel, "gru2_train_fwd_legacy", 3, h, rows, True, 2))
    packed, h0p, h1p, _, finals = lstm_kernel.gru2_train_fwd_residuals(x_tm, keep, l0, l1)

    rng = np.random.RandomState(15)
    dh = torch.from_numpy(rng.randn(b, h).astype(np.float32)).cuda()
    dys = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).cuda()
    res0, res1 = ((_shifted(lay[4]),) + tuple(lay[:4]) for lay in layers)
    w = (l0["w_hh"], l1["w_hh"], l1["w_ih"])
    names = ("dih0", "dhh0", "dih1", "dhh1")
    errs = {}
    for label, stream in (("", None), (" with dys", dys)):
        args = (res0, res1, stream, keep, dh, *w)
        outs = lstm_kernel.gru2_bwd_chain_legacy(*args)
        torch.cuda.synchronize()
        refs = lstm_kernel.gru2_bwd_chain_legacy_reference(*args)
        for name, out, ref in zip(names, (*outs[0], *outs[1]), (*refs[0], *refs[1])):
            errs[name + label] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4, msg=name + label)
    fused = lstm_kernel.gru2_bwd_chain_legacy(res0, res1, None, keep, dh, *w)
    res_args = (packed, h0p, h1p, keep, dh, *w)
    dih0, dhn0, dih1, dhn1 = lstm_kernel.gru2_bwd_chain(*res_args)
    # the residual-native chain (row 15): the same core, over another layout
    vs_res = {name: float((a - r).abs().max() / r.abs().max()) for name, a, r in
              zip(("dih0", "dhn0", "dih1", "dhn1"), (fused[0][0], fused[0][1][..., 2 * h:], fused[1][0],
                          fused[1][1][..., 2 * h:]), (dih0, dhn0, dih1, dhn1))}
    layered = lstm_vjp.gru_bwd_layered_legacy(res0, res1, None, keep, dh, *w)
    vs_layered = {name: float((a - r).abs().max() / r.abs().max()) for name, a, r in
                  zip(names, (*fused[0], *fused[1]), (*layered[0], *layered[1]))}
    print(f"[gru2_bwd_chain_legacy] B={b} T={t} H={h}: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (bound 1e-4 abs + 1e-4 rel); against the residual-native chain's dih and "
          "dhn, max abs diff relative to the largest "
          + ", ".join(f"{k} {v:.3e}" for k, v in vs_res.items()) + " (bound 1e-5); "
          "against the layered backward over the same "
          "residuals (2 x gru_bwd_chain + hop), max abs diff relative to the largest "
          + ", ".join(f"{k} {v:.3e}" for k, v in vs_layered.items()) + " (bound 1e-5)")
    if max(vs_layered.values()) > 1e-5 or max(vs_res.values()) > 1e-5:
        raise RuntimeError("the fused legacy GRU chain disagrees with the layered one "
                           "or the residual-native one")
    for rows in (b, 17, 1):
        print("[gru2_bwd_chain_legacy] " + _chain_plan_text(
            lstm_kernel, "gru2_bwd_chain_legacy", 3, h, rows, layers=2))

    lib = _cudnn_gru(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()
    lib_params = list(lib.parameters())
    h_lib = lib(x_bt)[1][-1]

    def run_lib_bwd():
        torch.autograd.grad(h_lib, lib_params, dh, retain_graph=True)

    fwd_ms = device_ms(lambda: lstm_kernel.gru2_train_fwd_legacy(x_tm, keep, l0, l1), flush)
    fwd_res_ms = device_ms(
        lambda: lstm_kernel.gru2_train_fwd_residuals(x_tm, keep, l0, l1), flush)
    fwd_plain_ms = device_ms(
        lambda: lstm_kernel.gru2_train_fwd_legacy_reference(x_tm, keep, l0, l1),
        flush, reps=5)
    fwd_lib_ms = device_ms(lambda: lib(x_bt), flush)
    ms = device_ms(lambda: lstm_kernel.gru2_bwd_chain_legacy(res0, res1, None, keep, dh, *w),
                   flush)
    ms_dys = device_ms(
        lambda: lstm_kernel.gru2_bwd_chain_legacy(res0, res1, dys, keep, dh, *w), flush)
    res_ms = device_ms(lambda: lstm_kernel.gru2_bwd_chain(*res_args), flush)
    layered_ms = device_ms(
        lambda: lstm_vjp.gru_bwd_layered_legacy(res0, res1, None, keep, dh, *w), flush)
    plain_ms = device_ms(lambda: lstm_kernel.gru2_bwd_chain_legacy_reference(
        res0, res1, None, keep, dh, *w), flush, reps=5)
    library_ms = device_ms(run_lib_bwd, flush)
    # the forward as row 14 counts it, with the legacy layout's 10H of
    # stores per row and h_final
    fwd_flops = 2 * b * t * (d * 3 * h + 3 * h * 3 * h)
    fwd_bytes = 4 * (t * b * (d + h + 10 * h) + d * 3 * h + 3 * h * 3 * h
                     + 4 * 3 * h + b * h)
    fwd_bound_ms, fwd_bound_by = bound(fwd_flops, fwd_bytes)
    # the chain without dys: res0, res1 (5H each), keep, dh_final and three
    # weights read, out (12H) written
    flops = 2 * b * t * 3 * 3 * h * h
    nbytes = 4 * (t * b * (10 * h + h + 12 * h) + b * h + 3 * h * 3 * h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[gru2_train_fwd_legacy] kernel {fwd_ms:.4f} ms (input projection + one "
          f"cooperative cluster launch, {1e3 * fwd_ms / (t + 1):.3f} us per phase; the "
          f"residual-native form (row 14) {fwd_res_ms:.4f} ms, "
          f"{1e3 * fwd_res_ms / (t + 1):.3f} us per phase, in this phase), plain "
          f"{fwd_plain_ms:.4f} ms, cuDNN nn.GRU training forward at keep=1 "
          f"{fwd_lib_ms:.4f} ms, bound {fwd_bound_ms:.4f} ms ({fwd_bound_by}: "
          f"{fwd_flops / 1e9:.3f} GFLOP, {fwd_bytes / 1e6:.2f} MB incl. the 10H stores)")
    print(f"[gru2_bwd_chain_legacy] kernel {ms:.4f} ms (the gate series' pack and one "
          f"cooperative cluster launch, {1e3 * ms / (t + 1):.3f} us per phase; "
          f"{ms_dys:.4f} ms "
          f"with dys; the residual-native chain {res_ms:.4f} ms and the layered backward "
          f"over the same residuals {layered_ms:.4f} ms in this phase), plain "
          f"{plain_ms:.4f} ms, cuDNN backward of h_n at keep=1 {library_ms:.4f} ms (it "
          f"also forms the weight gradients), bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")

    # the whole recurrence gradient at keep p=0.1 on the legacy routes (the
    # fused chain, then the layered one) and the residual-native route
    names = ("dx",) + tuple(f"d{n}{i}" for i in range(2)
                             for n in ("w_ih", "w_hh", "b_ih", "b_hh"))
    whole = {}
    for route, mode, bwd2 in (("fused", "off", True), ("layered", "off", False),
                              ("residual", "auto", False)):
        prev, prev_bwd2 = lstm_vjp.set_res2_mode(mode), lstm_vjp.GRU_BWD2_ENABLED
        lstm_vjp.GRU_BWD2_ENABLED = bwd2
        try:
            grads, run = _whole_grads(lstm_vjp.fused_gru_final, x_bt, keep, (l0, l1), dh)
            whole[route] = (grads, device_ms(run, flush))
        finally:
            lstm_vjp.set_res2_mode(prev)
            lstm_vjp.GRU_BWD2_ENABLED = prev_bwd2
    _routes_agree("gru2_bwd_chain_legacy", names, whole["fused"][0], whole["residual"][0])
    _routes_agree("gru2_bwd_chain_legacy layered", names, whole["layered"][0],
                  whole["residual"][0])
    print(f"[gru2_bwd_chain_legacy] whole recurrence gradient (forward + reverse chain "
          f"+ hoisted weight products): legacy with row 10 {whole['fused'][1]:.4f} ms, "
          f"legacy layered {whole['layered'][1]:.4f} ms, residual-native "
          f"{whole['residual'][1]:.4f} ms")
    src = "multimodal_emotion_detection_tpu_torch/csrc/"
    return ({"name": "gru2_train_fwd_legacy", "route": "cuda",
             "source": src + "gru2_train_fwd_legacy.cu", "core": src + "rnn2_fwd_chain.cuh",
             "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:1354",
             "max_abs_err": max(fwd_errs.values()), "ms": fwd_ms,
             "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound_ms,
             "bound_by": fwd_bound_by, "library_ms": fwd_lib_ms},
            {"name": "gru2_bwd_chain_legacy", "route": "cuda",
             "source": src + "gru2_bwd_chain_legacy.cu", "core": src + "rnn2_bwd_chain.cuh",
             "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:1886",
             "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})

def phase_gru1_train_fwd(lstm_kernel, flush):
    """``[gru1_train_fwd]`` (and ``[gru1_infer]``, its eval form): one GRU
    layer of the big GRU config at B=32, T=372, H=512, layer-0 and deeper
    inputs, against the plain versions; times beside cuDNN's GRU."""
    inputs, w_hh = _big_layer_inputs(11, gates=3)
    t, b, _ = inputs["D=64"][0].shape
    h = w_hh.shape[0]
    k = 1.0 / np.sqrt(h)
    b_hh = torch.from_numpy(
        np.random.RandomState(12).uniform(-k, k, 3 * h).astype(np.float32)).cuda()
    errs, eval_errs = {}, {}
    for label, (x, w_ih, b_ih) in inputs.items():
        ih = torch.matmul(x, w_ih) + b_ih
        outs = lstm_kernel.gru1_train_fwd(ih, w_hh, b_hh)
        torch.cuda.synchronize()
        refs = lstm_kernel.gru1_train_fwd_reference(ih, w_hh, b_hh)
        for name, out, ref in zip(("gates", "h_prev", "h"), outs, refs):
            errs[f"{name} {label}"] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-4, msg=name)
        for series in (True, False):
            out = lstm_kernel.gru1_infer(ih, w_hh, b_hh, series)
            torch.cuda.synchronize()
            ref = lstm_kernel.gru1_infer_reference(ih, w_hh, b_hh, series)
            eval_errs[f"{'series' if series else 'final'} {label}"] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    print(f"[gru1_train_fwd] B={b} T={t} H={h}, input D=64 and D=512: max abs "
          "err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (bound 1e-4 abs)")
    print("[gru1_infer] eval form: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in eval_errs.items())
          + " (bound 1e-4 abs)")

    # timed at a deeper layer's shape; the input projection is outside
    # the kernel on this route (one torch.matmul between launches)
    x, w_ih, b_ih = inputs["D=512"]
    ih = torch.matmul(x, w_ih) + b_ih
    lib = _cudnn_gru({"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh},
                     batch_first=False)

    def run_lib_train():
        lib(x)  # training forward with autograd: saves what backward needs

    def run_lib_eval():
        with torch.no_grad():
            lib(x)

    ms = device_ms(lambda: lstm_kernel.gru1_train_fwd(ih, w_hh, b_hh), flush)
    plain_ms = device_ms(
        lambda: lstm_kernel.gru1_train_fwd_reference(ih, w_hh, b_hh), flush, reps=5)
    library_ms = device_ms(run_lib_train, flush)
    eval_ms = device_ms(lambda: lstm_kernel.gru1_infer(ih, w_hh, b_hh, True), flush)
    eval_final_ms = device_ms(lambda: lstm_kernel.gru1_infer(ih, w_hh, b_hh, False),
                              flush)
    eval_plain_ms = device_ms(
        lambda: lstm_kernel.gru1_infer_reference(ih, w_hh, b_hh, True), flush, reps=5)
    eval_library_ms = device_ms(run_lib_eval, flush)
    # the b1 serving forward's eval forms: two row groups, one of them
    # empty, a plan the B=32 checks above never run
    ih1 = ih[:, :1].contiguous()
    for series in (True, False):
        out = lstm_kernel.gru1_infer(ih1, w_hh, b_hh, series)
        torch.cuda.synchronize()
        ref = lstm_kernel.gru1_infer_reference(ih1, w_hh, b_hh, series)
        eval_errs[f"{'series' if series else 'final'} B=1"] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    print("[gru1_infer] eval form at B=1 (D=512 input): max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in eval_errs.items() if "B=1" in k)
          + " (bound 1e-4 abs)")
    b1_ms = device_ms(lambda: lstm_kernel.gru1_infer(ih1, w_hh, b_hh, False), flush)
    flops = 2 * b * t * h * 3 * h
    # ih, w_hh and b_hh read; gates (4H), h_prev and the final h written
    nbytes = 4 * (t * b * 3 * h + h * 3 * h + 3 * h + t * b * 5 * h + b * h)
    bound_ms, bound_by = bound(flops, nbytes)
    # ih, w_hh and b_hh read; the h series written
    eval_bytes = 4 * (t * b * 3 * h + h * 3 * h + 3 * h + t * b * h)
    eval_bound_ms, eval_bound_by = bound(flops, eval_bytes)
    print(f"[gru1_train_fwd] {_chain_plan_text(lstm_kernel, 'gru1_fwd', 3, h, b, True)}")
    print(f"[gru1_infer] {_chain_plan_text(lstm_kernel, 'gru1_fwd', 3, h, 1, True)}")
    print(f"[gru1_train_fwd] kernel {ms:.4f} ms (one cooperative cluster launch, {t} "
          f"split grid barriers, {1e3 * ms / t:.3f} us per step), plain {plain_ms:.4f} "
          f"ms, cuDNN nn.GRU({h}, {h}) training forward (input projection "
          f"included) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB incl. the residual stores)")
    print(f"[gru1_infer] kernel {eval_ms:.4f} ms with the h series out, "
          f"{eval_final_ms:.4f} ms final h only ({1e3 * eval_ms / t:.3f} us per "
          f"step), B=1 final h {b1_ms:.4f} ms, plain {eval_plain_ms:.4f} ms, "
          f"cuDNN nn.GRU({h}, {h}) "
          f"inference forward {eval_library_ms:.4f} ms, bound {eval_bound_ms:.4f} ms "
          f"({eval_bound_by}: {flops / 1e9:.3f} GFLOP, {eval_bytes / 1e6:.2f} MB)")
    source, core = CSRC + "gru1_fwd.cu", CSRC + "rnn_fwd_chain.cuh"
    # no TPU kernel: it replaces the XLA scan the JAX package runs there
    replaces = "multimodal_emotion_detection_tpu/ops/lstm_vjp.py:798"
    train_kern = {"name": "gru1_train_fwd", "route": "cuda", "source": source,
                  "core": core, "replaces": replaces, "max_abs_err": max(errs.values()), "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": library_ms}
    eval_kern = {"name": "gru1_infer", "route": "cuda", "source": source,
                 "core": core, "replaces": replaces, "max_abs_err": max(eval_errs.values()),
                 "ms": eval_ms, "plain_ms": eval_plain_ms, "bound_ms": eval_bound_ms,
                 "bound_by": eval_bound_by, "library_ms": eval_library_ms}
    return train_kern, eval_kern, (inputs, w_hh, b_hh)


def phase_gru_bwd_chain(lstm_kernel, lstm_vjp, flush, layer_inputs):
    """``[gru_bwd_chain]``: one GRU layer's reverse chain at B=32, T=372,
    H=512, with and without ``dh_series``, against the plain version; the
    whole 3-layer ``LayeredGRUFinal`` gradient against autograd through the
    plain forward; times beside cuDNN's GRU backward."""
    inputs, w_hh, b_hh = layer_inputs
    x, w_ih, b_ih = inputs["D=512"]
    t, b, _ = x.shape
    h = w_hh.shape[0]
    gates, h_prev, _ = lstm_kernel.gru1_train_fwd_reference(
        torch.matmul(x, w_ih) + b_ih, w_hh, b_hh)
    rng = np.random.RandomState(13)
    dhf = torch.from_numpy(rng.randn(b, h).astype(np.float32)).cuda()
    dhs = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).cuda()
    errs = {}
    for label, series in (("dh_series given", dhs), ("dh_series None", None)):
        outs = lstm_kernel.gru_bwd_chain(gates, h_prev, series, dhf, w_hh)
        torch.cuda.synchronize()
        refs = lstm_kernel.gru_bwd_chain_reference(gates, h_prev, series, dhf, w_hh)
        for name, out, ref in zip(("dih", "dhn"), outs, refs):
            errs[f"{name} {label}"] = max_errs(out, ref)[0]
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-4, msg=f"{name} {label}")
    print(f"[gru_bwd_chain] B={b} T={t} H={h}: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (bound 1e-4 abs)")

    lib = _cudnn_gru({"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh},
                     batch_first=False)
    lib_params = list(lib.parameters())
    h_lib = lib(x)[1][-1]

    def run_lib_bwd():
        torch.autograd.grad(h_lib, lib_params, dhf, retain_graph=True)

    # a lower layer's chain (dh_series from the layer above), and the top
    # layer's (none)
    ms = device_ms(lambda: lstm_kernel.gru_bwd_chain(gates, h_prev, dhs, dhf, w_hh),
                   flush)
    top_ms = device_ms(lambda: lstm_kernel.gru_bwd_chain(gates, h_prev, None, dhf, w_hh),
                       flush)
    plain_ms = device_ms(
        lambda: lstm_kernel.gru_bwd_chain_reference(gates, h_prev, dhs, dhf, w_hh),
        flush, reps=5)
    library_ms = device_ms(run_lib_bwd, flush)
    flops = 2 * b * t * 3 * h * h
    # gates (4H), h_prev, dh_series, dh_final and w_hh read; dih (3H) and
    # dhn written
    nbytes = 4 * (t * b * (4 * h + h + h + 3 * h + h) + b * h + h * 3 * h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[gru_bwd_chain] {_chain_plan_text(lstm_kernel, 'gru_bwd_chain', 3, h, b)}")
    print(f"[gru_bwd_chain] kernel {ms:.4f} ms with dh_series, {top_ms:.4f} ms "
          f"without (one cooperative cluster launch, {t} split grid barriers, "
          f"{1e3 * ms / t:.3f} us per step), plain {plain_ms:.4f} ms, cuDNN "
          f"backward of h_n for nn.GRU({h}, {h}) {library_ms:.4f} ms (it also "
          f"forms the weight gradients), bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")

    # the whole 3-layer recurrence gradient (3 forwards, 3 chains, the hops
    # and the hoisted weight products): at dropout 0.1 against autograd
    # through the plain forward, at keep=1 against cuDNN's 3-layer forward
    # + backward on the same weights
    x0 = inputs["D=64"][0].transpose(0, 1).contiguous()  # (B, T, 64)
    d = x0.shape[2]
    k = 1.0 / np.sqrt(h)
    names = ("w_ih", "w_hh", "b_ih", "b_hh")
    layers = [{name: torch.from_numpy(
        rng.uniform(-k, k, shape).astype(np.float32)).cuda().requires_grad_()
        for name, shape in (("w_ih", (d if i == 0 else h, 3 * h)), ("w_hh", (h, 3 * h)),
                            ("b_ih", (3 * h,)), ("b_hh", (3 * h,)))}
        for i in range(3)]
    ours_params = [p[n] for p in layers for n in names]
    keep = torch.from_numpy(
        ((rng.rand(t, 2, b, h) < 0.9) / 0.9).astype(np.float32)).cuda()

    def plain_final(keep_tm):
        x_l = x0.transpose(0, 1)
        for i, p in enumerate(layers):
            _, hp, hf = lstm_kernel.gru1_train_fwd_reference(
                x_l @ p["w_ih"] + p["b_ih"], p["w_hh"], p["b_hh"])
            x_l = torch.cat([hp[1:], hf[None]])
            if i < 2:
                x_l = x_l * keep_tm[:, i]
        return hf

    g_ours = torch.autograd.grad(lstm_vjp.fused_gru_final(x0, keep, layers),
                                 ours_params, dhf)
    g_plain = torch.autograd.grad(plain_final(keep), ours_params, dhf)
    grad_errs = _grad_close("LayeredGRUFinal", g_ours, g_plain,
                            [f"layer_{i}.{n}" for i in range(3) for n in names])
    worst = max(grad_errs, key=grad_errs.get)
    print(f"[gru_bwd_chain] whole 3-layer gradient at dropout 0.1 vs autograd "
          f"through the plain forward: max abs err {grad_errs[worst]:.3e} ({worst}; "
          "bound 1e-4 of each tensor's largest entry)")
    ones = torch.ones((t, 2, b, h), device="cuda")
    lib3 = _cudnn_gru(*layers)
    lib3_params = list(lib3.parameters())

    def run_ours_grad():
        out = lstm_vjp.fused_gru_final(x0, ones, layers)
        return torch.autograd.grad(out, ours_params, dhf)

    def run_lib_grad():
        return torch.autograd.grad(lib3(x0)[1][-1], lib3_params, dhf)

    g_ours, g_lib = run_ours_grad(), run_lib_grad()
    # cuDNN keeps (3H, H) matrices: compare dW_hh of layer 2 (ours (H, 3H)),
    # and db_hh of layer 2, whose n third differs from db_ih's
    rel_err = float((g_ours[9] - g_lib[9].T).abs().max() / g_lib[9].abs().max())
    bias_err = float((g_ours[11] - g_lib[11]).abs().max() / g_lib[11].abs().max())
    whole_ms = device_ms(run_ours_grad, flush)
    whole_lib_ms = device_ms(run_lib_grad, flush)
    print(f"[gru_bwd_chain] whole 3-layer recurrence gradient at keep=1 (3 "
          f"forwards + 3 reverse chains + hops + hoisted weight products) "
          f"{whole_ms:.4f} ms vs cuDNN nn.GRU({d}, {h}, num_layers=3) forward + "
          f"backward {whole_lib_ms:.4f} ms; dW_hh2 relative to cuDNN's "
          f"{rel_err:.3e}, db_hh2 {bias_err:.3e}")
    if not (rel_err < 1e-3 and bias_err < 1e-3):
        raise RuntimeError("the layered GRU gradient disagrees with cuDNN's")
    return {"name": "gru_bwd_chain", "route": "cuda",
            "source": CSRC + "gru_bwd_chain.cu", "core": CSRC + "rnn_bwd_chain.cuh",
            "replaces": "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:1265",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def _flash_inputs(b, h, tq, tk, d, seed, valid_keys=None):
    """q, k, v, dO (B, H, T, D) on the card and the (B, Tk) key bias: None,
    or 0 for the keys ``valid_keys`` (B, Tk) marks and -1e9 elsewhere."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, h, tq, d).astype(np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.randn(b, h, tk, d).astype(np.float32)).to(dev)
            for _ in range(2))
    do = torch.from_numpy(rng.randn(b, h, tq, d).astype(np.float32)).to(dev)
    bias = None
    if valid_keys is not None:
        bias = torch.from_numpy(
            np.where(valid_keys, 0.0, -1e9).astype(np.float32)).to(dev)
    return q, k, v, bias, do


def _flash_cases():
    """The shapes the encoder's attention takes, with the key bias and the
    dropout rate of each: the slice's (32 clips, 4 heads, 372 frames, 64)
    without a bias at rates 0 (eval) and 0.1 (training, one seed for both
    calls); (4, 4, 1000, 64), many key tiles and a ragged edge, with a
    random key-padding bias; the blockwise fold of one raw clip, 94
    blocks of 512 with the last one padded past 48,000 samples; and the
    kernels' other head-dim paths, 128 (with a key bias) and 40, at T off
    the tiles."""
    rng = np.random.RandomState(21)
    pad_mask = rng.rand(4, 1000) > 0.2
    pad_mask[:, 0] = True
    fold = np.ones((94, 512), bool)
    fold[-1, 48000 - 93 * 512:] = False
    wide_mask = rng.rand(8, 300) > 0.2
    wide_mask[:, 0] = True
    return [("(32, 4, 372, 64) rate 0", (32, 4, 372, 372, 64), None, 0.0),
            ("(32, 4, 372, 64) rate 0.1", (32, 4, 372, 372, 64), None, 0.1),
            ("(4, 4, 1000, 64) key bias, rate 0.1", (4, 4, 1000, 1000, 64),
             pad_mask, 0.1),
            ("(94, 4, 512, 64) blockwise fold, rate 0.1", (94, 4, 512, 512, 64),
             fold, 0.1),
            ("(8, 4, 300, 128) key bias, rate 0.1", (8, 4, 300, 300, 128),
             wide_mask, 0.1),
            ("(8, 4, 77, 40) rate 0", (8, 4, 77, 77, 40), None, 0.0)]


def _grad_close(name, outs, refs, labels):
    """Max abs errors of ``outs`` against ``refs``, each held to 1e-4 of
    its largest entry (a gradient sums up to T terms)."""
    errs = {}
    for label, out, ref in zip(labels, outs, refs):
        scale = max(float(ref.abs().max()), 1.0)
        errs[label] = max_errs(out, ref)[0]
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * scale,
                                   msg=f"{name} {label}")
    return errs


def _sdpa(q, k, v, bias, rate=0.0):
    """Yardstick only, never called by the port: PyTorch's fused attention
    on the same inputs (its own kernel choice; dropout at ``rate``, none by
    default)."""
    mask = None if bias is None else bias[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                            dropout_p=rate)


def phase_flash(fa, flush):
    """``[flash_fwd]`` / ``[flash_bwd]``: both kernels against their plain
    versions at every case of ``_flash_cases``, the kept fraction of the
    mask, and times at the slice's training shape."""
    seed = torch.tensor([0x5EED_0F_F1A5], dtype=torch.int64, device="cuda")
    fwd_errs, bwd_errs = {}, {}
    for label, (b, h, tq, tk, d), valid, rate in _flash_cases():
        q, k, v, bias, do = _flash_inputs(b, h, tq, tk, d, tq + tk, valid)
        o, lse = fa.flash_fwd(q, k, v, bias, seed, rate)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, bias, seed, rate)
        fwd_errs[f"O {label}"] = max_errs(o, o_ref)[0]
        fwd_errs[f"LSE {label}"] = max_errs(lse, lse_ref)[0]
        torch.testing.assert_close(o, o_ref, rtol=1e-4, atol=1e-4, msg=label)
        torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4, msg=label)
        delta = (do * o_ref).sum(-1)
        args = (q, k, v, bias, seed, rate, do, lse_ref, delta)
        outs = fa.flash_bwd_fused(*args)
        torch.cuda.synchronize()
        errs = _grad_close("flash_bwd_fused", outs, fa.flash_bwd_reference(*args),
                           ("dQ", "dK", "dV"))
        bwd_errs.update({f"{n} {label}": e for n, e in errs.items()})
        del q, k, v, bias, do, o, lse, o_ref, lse_ref, delta, args, outs
    print("[flash_fwd] kernel vs plain: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in fwd_errs.items())
          + " (bound 1e-4 abs + 1e-4 rel); at rate 0.1 the outputs agree, so "
          "the kernel's Philox mask is the plain version's")
    print("[flash_bwd] fused kernel vs plain: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in bwd_errs.items())
          + " (bound 1e-4 of the largest entry)")

    b, h, t, d = 32, 4, 372, 64
    keep = fa.attn_keep_mask(seed, 0.1, (b, h, t, t)) > 0
    n = keep.numel()
    kept = float(keep.float().mean())
    sigma = (0.1 * 0.9 / n) ** 0.5
    print(f"[flash_fwd] attn_keep_mask at rate 0.1 over {n} elements: kept "
          f"{kept:.6f}, expected 0.9 +- {6 * sigma:.6f} (6 sigma)")
    if abs(kept - 0.9) > 6 * sigma:
        raise RuntimeError("the dropout mask's kept fraction is off")
    del keep

    q, k, v, _, do = _flash_inputs(b, h, t, t, d, 5)
    o, lse = fa.flash_fwd_reference(q, k, v, None, seed, 0.1)
    delta = (do * o).sum(-1)
    args = (q, k, v, None, seed, 0.1, do, lse, delta)
    lib_err = max_errs(_sdpa(q, k, v, None), fa.flash_fwd_reference(
        q, k, v, None, seed, 0.0)[0])[0]
    ms = device_ms(lambda: fa.flash_fwd(q, k, v, None, seed, 0.1), flush)
    eval_ms = device_ms(lambda: fa.flash_fwd(q, k, v, None, seed, 0.0), flush)
    plain_ms = device_ms(lambda: fa.flash_fwd_reference(q, k, v, None, seed, 0.1),
                         flush, reps=5)
    library_ms = device_ms(lambda: _sdpa(q, k, v, None), flush)
    bwd_ms = device_ms(lambda: fa.flash_bwd_fused(*args), flush)
    bwd_plain_ms = device_ms(lambda: fa.flash_bwd_reference(*args), flush, reps=5)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    lib_out = _sdpa(*leaves, None)
    bwd_library_ms = device_ms(
        lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), flush)

    def lib_train():
        torch.autograd.grad(_sdpa(*leaves, None), leaves, do)

    def ours_train():
        ls = [x.clone().requires_grad_() for x in (q, k, v)]
        torch.autograd.grad(fa.flash_attention(*ls, dropout_rate=0.1,
                                               dropout_seed=seed), ls, do)

    train_ms, lib_train_ms = device_ms(ours_train, flush), device_ms(lib_train, flush)
    pairs = b * h * t * t
    # q, k, v read, O and LSE written; for the backward q, k, v, dO, LSE and
    # Delta read, dQ, dK, dV written: the function's bytes (the float32 fused
    # form also writes and reads back its dQ partials, one slot a kv span)
    fwd_fp32, fwd_bound = tc_bounds(4 * pairs * d, 4 * (4 * b * h * t * d + b * h * t))
    bwd_fp32, bwd_bound = tc_bounds(10 * pairs * d, 4 * (7 * b * h * t * d + 2 * b * h * t))
    n_spans = fa.kv_spans(t)[0]
    print(f"[flash_fwd] B={b} H={h} T={t} D={d}: kernel {ms:.4f} ms at rate 0.1 "
          f"({eval_ms:.4f} ms at rate 0), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention (no dropout; max abs err {lib_err:.3e} vs "
          f"plain) {library_ms:.4f} ms, bound {fwd_bound[0]:.4f} ms in 3xTF32 "
          f"({fwd_bound[1]}: 3 x {4 * pairs * d / 1e9:.3f} GFLOP at "
          f"{TF32_FLOPS / 1e12:.0f} TFLOP/s), {fwd_fp32[0]:.4f} ms in float32 "
          f"({fwd_fp32[1]}: at {FP32_FLOPS / 1e12:.0f} TFLOP/s; the Philox mask's "
          "integer work not counted)")
    print(f"[flash_bwd] fused kernel {bwd_ms:.4f} ms at rate 0.1 ({n_spans} kv spans, "
          f"partials summed in it), plain {bwd_plain_ms:.4f} ms, SDPA backward "
          f"(autograd.grad, no dropout) {bwd_library_ms:.4f} ms, bound "
          f"{bwd_bound[0]:.4f} ms in 3xTF32 ({bwd_bound[1]}: 3 x "
          f"{10 * pairs * d / 1e9:.3f} GFLOP at {TF32_FLOPS / 1e12:.0f} TFLOP/s), "
          f"{bwd_fp32[0]:.4f} ms in float32 ({bwd_fp32[1]}: at "
          f"{FP32_FLOPS / 1e12:.0f} TFLOP/s)")
    print(f"[flash_bwd] forward + backward through flash_attention {train_ms:.4f} ms "
          f"vs SDPA forward + backward {lib_train_ms:.4f} ms")
    src = "multimodal_emotion_detection_tpu_torch/csrc/"
    fwd = {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
           "replaces": "multimodal_emotion_detection_tpu/ops/flash_attention.py:159",
           "max_abs_err": max(fwd_errs.values()), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
           "bound_fp32_ms": fwd_fp32[0], "bound_3xtf32_ms": fwd_bound[0],
           "library_ms": library_ms}
    bwd = {"name": "flash_bwd_fused", "route": "cuda",
           "source": src + "flash_bwd_fused.cu",
           "replaces": "multimodal_emotion_detection_tpu/ops/flash_attention.py:266",
           "max_abs_err": max(bwd_errs.values()), "ms": bwd_ms,
           "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound[0],
           "bound_by": bwd_bound[1], "bound_fp32_ms": bwd_fp32[0],
           "bound_3xtf32_ms": bwd_bound[0], "library_ms": bwd_library_ms}
    return fwd, bwd


LONG = (2, 4, 5000, 64)  # past FUSE_MAX_TK keys: the two-pass backward


def phase_flash_long(fa, counters, flush):
    """``[flash_long]``: ``flash_attention`` forward + backward at (2, 4,
    5000, 64) with a key bias and dropout 0.1, with the launch counts
    checked (the forward once, the two-pass kernels once each, the fused
    form never), its gradients against the plain versions; then the two
    kernels' times beside SDPA's backward."""
    b, h, t, d = LONG
    rng = np.random.RandomState(31)
    valid = rng.rand(b, t) > 0.1
    valid[:, 0] = True
    q, k, v, bias, do = _flash_inputs(b, h, t, t, d, 32, valid)
    seed = torch.tensor([0xA77E5710], dtype=torch.int64, device="cuda")
    if fa.bwd_route(t) != "two_pass":
        raise RuntimeError(f"T={t} does not take the two-pass backward")

    def run():
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves, bias, dropout_rate=0.1, dropout_seed=seed)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        return (out.detach(), *grads)

    outs, _, launches = run_counted(
        counters, {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1},
        "flash_long", run)
    o_ref, lse = fa.flash_fwd_reference(q, k, v, bias, seed, 0.1)
    delta = (do * o_ref).sum(-1)
    args = (q, k, v, bias, seed, 0.1, do, lse, delta)
    errs = _grad_close("flash_long", outs, (o_ref, *fa.flash_bwd_reference(*args)),
                       ("O", "dQ", "dK", "dV"))
    print(f"[flash_long] B={b} H={h} T={t} D={d}, key bias, rate 0.1: launches "
          f"{launches}; max abs err vs plain "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (bound 1e-4 of the largest entry)")
    dkv_ms = device_ms(lambda: fa.flash_bwd_dkv(*args), flush, reps=5)
    dq_ms = device_ms(lambda: fa.flash_bwd_dq(*args), flush, reps=5)
    plain_ms = device_ms(lambda: fa.flash_bwd_reference(*args), flush, reps=3)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    lib_out = _sdpa(*leaves, bias)
    library_ms = device_ms(
        lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True),
        flush, reps=5)
    pairs = b * h * t * t
    dkv_fp32, dkv_bound = tc_bounds(8 * pairs * d,
                                    4 * (6 * b * h * t * d + 2 * b * h * t + b * t))
    dq_fp32, dq_bound = tc_bounds(6 * pairs * d,
                                  4 * (5 * b * h * t * d + 2 * b * h * t + b * t))
    print(f"[flash_long] dkv kernel {dkv_ms:.4f} ms (bound {dkv_bound[0]:.4f} ms in "
          f"3xTF32, {dkv_bound[1]}: 3 x {8 * pairs * d / 1e9:.3f} GFLOP at "
          f"{TF32_FLOPS / 1e12:.0f} TFLOP/s; {dkv_fp32[0]:.4f} ms in float32), dq "
          f"kernel {dq_ms:.4f} ms (bound {dq_bound[0]:.4f} ms in 3xTF32, "
          f"{dq_bound[1]}: 3 x {6 * pairs * d / 1e9:.3f} GFLOP; {dq_fp32[0]:.4f} ms "
          f"in float32); dkv + dq {dkv_ms + dq_ms:.4f} ms; plain backward (dQ, dK, "
          f"dV at once) {plain_ms:.4f} ms; SDPA backward (dQ, dK, dV at once, no "
          f"dropout) {library_ms:.4f} ms")
    src = "multimodal_emotion_detection_tpu_torch/csrc/"
    common = {"route": "cuda",
              "max_abs_err": max(errs[n] for n in ("dQ", "dK", "dV")),
              "plain_ms": plain_ms, "library_ms": library_ms}
    return launches, [
        {"name": "flash_bwd_dkv", **common, "source": src + "flash_bwd_fused.cu",
         "ms": dkv_ms,
         "replaces": "multimodal_emotion_detection_tpu/ops/flash_attention.py:255",
         "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1],
         "bound_fp32_ms": dkv_fp32[0], "bound_3xtf32_ms": dkv_bound[0]},
        {"name": "flash_bwd_dq", **common, "source": src + "flash_bwd_dq.cu",
         "ms": dq_ms,
         "replaces": "multimodal_emotion_detection_tpu/ops/flash_attention.py:212",
         "bound_ms": dq_bound[0], "bound_by": dq_bound[1],
         "bound_fp32_ms": dq_fp32[0], "bound_3xtf32_ms": dq_bound[0]}]


# a bf16 flash kernel against its plain version: O, dQ, dK, dV within this
# many bf16 ulps of the output's largest entry (one ulp = 2^-8 of it; plus
# 1e-6 absolute, where the exact result is 0); LSE (float32) to 1e-5
FLASH_BF16_ULPS = 4


def _half_flash_check(tag, errs, label, outs, refs, names) -> float:
    """Each output against its plain version by the bounds above, the
    error (in bf16 ulps of the largest entry for bf16 ones) into ``errs``;
    returns the largest absolute difference."""
    for name, out, ref in zip(names, outs, refs):
        if out.dtype != ref.dtype:
            raise RuntimeError(f"{tag} {name}: {out.dtype}, its plain version {ref.dtype}")
        err = float((out.float() - ref.float()).abs().max())
        if out.dtype == torch.float32:  # LSE
            errs[f"{name} {label}"] = err
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5, msg=f"{tag} {label}")
            continue
        largest = float(ref.float().abs().max())
        errs[f"{name} {label} (ulps)"] = ulps = err / (2.0 ** -8 * largest + 1e-30)
        if err > FLASH_BF16_ULPS * 2.0 ** -8 * largest + 1e-6:
            raise RuntimeError(f"{tag} {name} {label}: {ulps:.2f} bf16 ulps of the largest")
    return max(float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs))


def phase_flash_bf16(fa, flush):
    """``[flash_bf16]``: the forward's and the fused backward's bf16 forms
    against their bf16 plain versions at the encoder's (32, 4, 372, 64)
    (rates 0 and 0.1), (4, 4, 1000, 64) with a key-padding bias and head
    dims 128 and 40 with T off the tiles (``_flash_cases`` but the fold);
    then each timed at the encoder's shape at dropout rates 0 and 0.1
    beside SDPA on the bf16 tensors at the same ``dropout_p``, and at 0.1
    beside the float32 form on the same values, in this call."""
    bf16 = torch.bfloat16
    seed = torch.tensor([0x5EED_0F_F1A5], dtype=torch.int64, device="cuda")
    fwd_errs, bwd_errs, worst = {}, {}, [0.0, 0.0]
    for label, (b, h, tq, tk, d), valid, rate in _flash_cases():
        if b == 94:  # the blockwise fold: no config runs it in bf16 here
            continue
        q, k, v, bias, do = (x if x is None or x.dim() == 2 else x.to(bf16)
                             for x in _flash_inputs(b, h, tq, tk, d, tq + tk, valid))
        o, lse = fa.flash_fwd(q, k, v, bias, seed, rate)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, bias, seed, rate)
        worst[0] = max(worst[0], _half_flash_check(
            "flash_fwd_bf16", fwd_errs, label, (o, lse), (o_ref, lse_ref), ("O", "LSE")))
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (q, k, v, bias, seed, rate, do, lse_ref, delta)
        outs = fa.flash_bwd_fused(*args)
        torch.cuda.synchronize()
        worst[1] = max(worst[1], _half_flash_check(
            "flash_bwd_fused_bf16", bwd_errs, label, outs, fa.flash_bwd_reference(*args),
            ("dQ", "dK", "dV")))
        del q, k, v, bias, do, o, lse, o_ref, lse_ref, delta, args, outs
    print("[flash_bf16] forward bf16 form vs plain: "
          + ", ".join(f"{k} {v:.3e}" for k, v in fwd_errs.items())
          + f" (bound {FLASH_BF16_ULPS} bf16 ulps of the largest entry; LSE abs err, "
          "bound 1e-5 abs + 1e-5 rel)")
    print("[flash_bf16] fused backward bf16 form vs plain: "
          + ", ".join(f"{k} {v:.3e}" for k, v in bwd_errs.items())
          + f" (bound {FLASH_BF16_ULPS} bf16 ulps of the largest entry)")

    b, h, t, d = 32, 4, 372, 64
    q, k, v, _, do = _flash_inputs(b, h, t, t, d, 5)
    q, k, v, do = (x.to(bf16) for x in (q, k, v, do))
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))  # the same values
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    # like for like: each form and SDPA in bf16 at dropout rates 0 and 0.1
    # (SDPA's dropout_p, its training mode; a yardstick the port never calls)
    for rate in (0.0, 0.1):
        o, lse = fa.flash_fwd_reference(q, k, v, None, seed, rate)
        args = (q, k, v, None, seed, rate, do, lse, (do.float() * o.float()).sum(-1))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        lib_out = sdpa(*leaves, dropout_p=rate)
        times[rate] = dict(
            fwd=device_ms(lambda: fa.flash_fwd(q, k, v, None, seed, rate), flush),
            sdpa=device_ms(lambda: sdpa(q, k, v, dropout_p=rate), flush),
            bwd=device_ms(lambda: fa.flash_bwd_fused(*args), flush),
            sdpa_bwd=device_ms(
                lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), flush))
        del leaves, lib_out
    o, lse = fa.flash_fwd_reference(q, k, v, None, seed, 0.1)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, None, seed, 0.1, do, lse, delta)
    o32, lse32 = fa.flash_fwd_reference(q32, k32, v32, None, seed, 0.1)
    args32 = (q32, k32, v32, None, seed, 0.1, do32, lse32, (do32 * o32).sum(-1))
    f32_ms = device_ms(lambda: fa.flash_fwd(q32, k32, v32, None, seed, 0.1), flush)
    plain_ms = device_ms(lambda: fa.flash_fwd_reference(q, k, v, None, seed, 0.1),
                         flush, reps=5)
    bwd_f32_ms = device_ms(lambda: fa.flash_bwd_fused(*args32), flush)
    bwd_plain_ms = device_ms(lambda: fa.flash_bwd_reference(*args), flush, reps=5)
    pairs = b * h * t * t
    # bf16 q, k, v read, bf16 O and float32 LSE written; the backward reads
    # bf16 q, k, v, dO and float32 LSE, Delta and writes bf16 dQ, dK, dV: the
    # function's bytes and its five products a pair (the bf16 kernel forms S
    # and dP in each of its two roles, 7 products, and writes dQ once)
    fwd_bound = bound(4 * pairs * d, 2 * 4 * b * h * t * d + 4 * b * h * t, BF16_FLOPS)
    bwd_bound = bound(10 * pairs * d, 2 * 7 * b * h * t * d + 4 * 2 * b * h * t,
                      BF16_FLOPS)
    for rate, tm in times.items():
        print(f"[flash_bf16] B={b} H={h} T={t} D={d} rate {rate}: forward bf16 form "
              f"{tm['fwd']:.4f} ms, SDPA in bf16 at dropout_p={rate} {tm['sdpa']:.4f} ms "
              f"({tm['fwd'] / tm['sdpa']:.2f}x); fused backward bf16 form "
              f"{tm['bwd']:.4f} ms, SDPA backward in bf16 at dropout_p={rate} "
              f"{tm['sdpa_bwd']:.4f} ms ({tm['bwd'] / tm['sdpa_bwd']:.2f}x)")
    ms, library_ms = times[0.1]["fwd"], times[0.1]["sdpa"]
    bwd_ms, bwd_library_ms = times[0.1]["bwd"], times[0.1]["sdpa_bwd"]
    print(f"[flash_bf16] rate 0.1: forward bf16 form {ms:.4f} ms, float32 form on the same "
          f"values {f32_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {fwd_bound[0]:.4f} ms "
          f"({fwd_bound[1]}: {4 * pairs * d / 1e9:.3f} GFLOP at "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s, {(2 * 4 * b * h * t * d + 4 * b * h * t) / 1e6:.2f}"
          f" MB at {HBM_BYTES / 1e12:.2f} TB/s)")
    print(f"[flash_bf16] rate 0.1: fused backward bf16 form {bwd_ms:.4f} ms, float32 form "
          f"{bwd_f32_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms, bound {bwd_bound[0]:.4f} ms "
          f"({bwd_bound[1]}: {10 * pairs * d / 1e9:.3f} GFLOP at "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s)")
    src = CSRC
    fwd = {"name": "flash_fwd_bf16", "route": "cuda", "source": src + "flash_fwd_bf16.cu",
           "replaces": "multimodal_emotion_detection_tpu/ops/flash_attention.py:159",
           "max_abs_err": worst[0], "ms": ms, "plain_ms": plain_ms,
           "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": library_ms,
           "f32_ms": f32_ms, "rate0_ms": times[0.0]["fwd"],
           "rate0_library_ms": times[0.0]["sdpa"]}
    bwd = {"name": "flash_bwd_fused_bf16", "route": "cuda",
           "source": src + "flash_bwd_bf16.cu",
           "replaces": "multimodal_emotion_detection_tpu/ops/flash_attention.py:266",
           "max_abs_err": worst[1], "ms": bwd_ms, "plain_ms": bwd_plain_ms,
           "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
           "library_ms": bwd_library_ms, "f32_ms": bwd_f32_ms,
           "rate0_ms": times[0.0]["bwd"], "rate0_library_ms": times[0.0]["sdpa_bwd"]}
    return fwd, bwd


def phase_flash_long_bf16(fa, counters, flush):
    """``[flash_long_bf16]``: ``flash_attention`` forward + backward on bf16
    q, k, v at (2, 4, 5000, 64) with a key bias and dropout 0.1: the bf16
    forward once, the two-pass bf16 kernels once each, the fused form and
    every float32 form never; O and the gradients against the bf16 plain
    versions, and the dQ form's dQ bit for bit across two runs; then the two
    kernels timed at rates 0.1 and 0, each pair beside SDPA's backward in
    bf16 at the same ``dropout_p``, and at 0.1 beside their float32 forms on
    the same values."""
    bf16 = torch.bfloat16
    b, h, t, d = LONG
    rng = np.random.RandomState(31)
    valid = rng.rand(b, t) > 0.1
    valid[:, 0] = True
    q, k, v, bias, do = (x if x.dim() == 2 else x.to(bf16)
                         for x in _flash_inputs(b, h, t, t, d, 32, valid))
    seed = torch.tensor([0xA77E5710], dtype=torch.int64, device="cuda")

    def run():
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves, bias, dropout_rate=0.1, dropout_seed=seed)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        return (out.detach(), *grads)

    outs, _, launches = run_counted(
        counters, {"flash_fwd_bf16": 1, "flash_bwd_dkv_bf16": 1, "flash_bwd_dq_bf16": 1},
        "flash_long_bf16", run)
    errs, label = {}, "(2, 4, 5000, 64)"
    timing = {}
    for rate in (0.1, 0.0):
        o_ref, lse = fa.flash_fwd_reference(q, k, v, bias, seed, rate)
        args = (q, k, v, bias, seed, rate, do, lse, (do.float() * o_ref.float()).sum(-1))
        if rate > 0.0:
            _half_flash_check("flash_long_bf16", errs, label, outs[:1], (o_ref,), ("O",))
            grad_err = _half_flash_check("flash_long_bf16", errs, label, outs[1:],
                                         fa.flash_bwd_reference(*args), ("dQ", "dK", "dV"))
            dq_runs = [fa.flash_bwd_dq(*args) for _ in range(2)]
            torch.cuda.synchronize()
            if not torch.equal(*dq_runs):
                raise AssertionError("flash_long_bf16: two runs of the dQ form differ")
            plain_ms = device_ms(lambda: fa.flash_bwd_reference(*args), flush, reps=3)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        lib_out = _sdpa(*leaves, bias.to(bf16), rate)
        timing[rate] = {
            "dkv": device_ms(lambda: fa.flash_bwd_dkv(*args), flush, reps=5),
            "dq": device_ms(lambda: fa.flash_bwd_dq(*args), flush, reps=5),
            "sdpa": device_ms(
                lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True),
                flush, reps=5)}
    print(f"[flash_long_bf16] B={b} H={h} T={t} D={d}, key bias, rate 0.1: launches "
          f"{ {n: c for n, c in launches.items() if c} }; vs plain "
          + ", ".join(f"{k} {v:.3f}" for k, v in errs.items())
          + f" (bound {FLASH_BF16_ULPS} bf16 ulps of the largest entry); dQ form's dQ "
          "bit for bit across two runs")
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32, lse32 = fa.flash_fwd_reference(q32, k32, v32, bias, seed, 0.1)
    args32 = (q32, k32, v32, bias, seed, 0.1, do32, lse32, (do32 * o32).sum(-1))
    dkv_f32_ms = device_ms(lambda: fa.flash_bwd_dkv(*args32), flush, reps=5)
    dq_f32_ms = device_ms(lambda: fa.flash_bwd_dq(*args32), flush, reps=5)
    pairs = b * h * t * t
    # bf16 q, k, v, dO read and dK, dV written (dkv) or dQ written (dq);
    # float32 LSE, Delta and bias read
    dkv_bound = bound(8 * pairs * d, 2 * 6 * b * h * t * d + 4 * (2 * b * h * t + b * t),
                      BF16_FLOPS)
    dq_bound = bound(6 * pairs * d, 2 * 5 * b * h * t * d + 4 * (2 * b * h * t + b * t),
                     BF16_FLOPS)
    for rate in (0.1, 0.0):
        tm = timing[rate]
        pair = tm["dkv"] + tm["dq"]
        print(f"[flash_long_bf16] rate {rate}: dkv bf16 form {tm['dkv']:.4f} ms, dq bf16 "
              f"form {tm['dq']:.4f} ms, the pair {pair:.4f} ms against SDPA's backward in "
              f"bf16 at dropout_p={rate} (dQ, dK, dV at once) {tm['sdpa']:.4f} ms "
              f"({pair / tm['sdpa']:.2f}x)")
    print(f"[flash_long_bf16] float32 forms at rate 0.1: dkv {dkv_f32_ms:.4f} ms, dq "
          f"{dq_f32_ms:.4f} ms; bounds: dkv {dkv_bound[0]:.4f} ms, {dkv_bound[1]}: "
          f"{8 * pairs * d / 1e9:.3f} GFLOP at {BF16_FLOPS / 1e12:.0f} TFLOP/s, dq "
          f"{dq_bound[0]:.4f} ms, {dq_bound[1]}: {6 * pairs * d / 1e9:.3f} GFLOP; plain "
          f"backward (dQ, dK, dV at once) {plain_ms:.4f} ms")
    common = {"route": "cuda", "max_abs_err": grad_err, "plain_ms": plain_ms,
              "library_ms": timing[0.1]["sdpa"], "rate0_library_ms": timing[0.0]["sdpa"]}
    return launches, [
        {"name": "flash_bwd_dkv_bf16", **common, "source": CSRC + "flash_bwd_bf16.cu",
         "ms": timing[0.1]["dkv"], "rate0_ms": timing[0.0]["dkv"], "f32_ms": dkv_f32_ms,
         "replaces": "multimodal_emotion_detection_tpu/ops/flash_attention.py:255",
         "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1]},
        {"name": "flash_bwd_dq_bf16", **common, "source": CSRC + "flash_bwd_bf16.cu",
         "ms": timing[0.1]["dq"], "rate0_ms": timing[0.0]["dq"], "f32_ms": dq_f32_ms,
         "replaces": "multimodal_emotion_detection_tpu/ops/flash_attention.py:212",
         "bound_ms": dq_bound[0], "bound_by": dq_bound[1]}]


# ---------------------------------------------------------------------------
# configs/base.yaml as written: the raw waveform, 48,000 steps
# ---------------------------------------------------------------------------

RAW_T = 48000  # base.yaml's raw waveform: 3 s at 16 kHz, audio input_dim 1


def timed_ms(fn):
    """``fn()`` once, and its device time in ms (CUDA events around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


RAW_ROWS = (0, 31)  # the batch rows the raw phases' plain versions run on
RAW_PLAIN = WORK / "raw_plain"
# the plain versions of the raw phases, one worker process each: the
# pair's training forward then its reverse chain (over the forward's
# plain residuals), the pair's eval form, for the LSTM and the GRU; the
# one-layer training forward then its chain
RAW_JOBS = ("lstm_train", "lstm_eval", "gru_train", "gru_eval", "lstm1")


def _raw_rows_rand(seed: int, rows, shape, normal: bool = False) -> torch.Tensor:
    """(shape[0], len(rows), *shape[1:]) on the CPU, each batch row drawn
    from a generator of its own (seed, row), so a worker makes any rows
    alone and the card's full batch holds the same values."""
    draw = torch.randn if normal else torch.rand
    return torch.stack([draw(shape, generator=torch.Generator().manual_seed(
        seed * 1000 + r)) for r in rows], dim=1)


def _raw_keep(seed: int, rows, t: int, h: int) -> torch.Tensor:
    """The layer-0 -> 1 keep mask at dropout 0.1, (T, len(rows), H)."""
    return (_raw_rows_rand(seed, rows, (t, h)) < 0.9).float() / 0.9


def _raw_pair_inputs(seed: int, gates: int, rows=RAW_ROWS):
    """base.yaml's recurrent training shape on the raw waveform (B=32,
    T=48,000, D=1, 2 layers of H=256; ``gates`` 4 for the LSTM, 3 for the
    GRU): time-major x, keep mask at dropout 0.1, both layers' weights and
    the chain's dh_final.  ``rows`` (``RAW_ROWS``, on the CPU, for a
    worker), or ``None``: the whole batch on the card, the keep mask drawn
    there and its ``RAW_ROWS`` set to the CPU's (393M draws)."""
    b, t, d, h = 32, RAW_T, 1, 256
    dev = torch.device("cuda") if rows is None else None
    sel = list(range(b)) if rows is None else list(rows)
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)
    names = ("w_ih", "w_hh", "b") if gates == 4 else ("w_ih", "w_hh", "b_ih", "b_hh")

    def layer(d_in):
        shapes = {"w_ih": (d_in, gates * h), "w_hh": (h, gates * h)}
        return {n: torch.from_numpy(rng.uniform(
            -k, k, shapes.get(n, (gates * h,))).astype(np.float32)).to(dev)
            for n in names}

    l0, l1 = layer(d), layer(h)
    x_tm = torch.from_numpy(np.ascontiguousarray(
        rng.randn(t, b, d).astype(np.float32)[:, sel])).to(dev)
    dh = torch.from_numpy(np.random.RandomState(42).randn(b, h).astype(np.float32)[sel])
    if rows is not None:
        return x_tm, _raw_keep(seed, rows, t, h), l0, l1, dh
    gen = torch.Generator(device=dev).manual_seed(seed)
    keep = (torch.rand((t, b, h), generator=gen, device=dev) < 0.9).float() / 0.9
    _put_rows(keep, _raw_keep(seed, RAW_ROWS, t, h))
    return x_tm, keep, l0, l1, dh.to(dev)


def _raw_layer_inputs(rows=RAW_ROWS):
    """``[lstm1_raw]``'s one layer (B=32, T=48,000, D=1, H=512): the input
    x (T, B, 1), w_ih, w_hh, b and dh_final (B, H) whole, on the CPU, and
    over the batch ``rows``: the input projection ih = x w_ih + b (on the
    CPU, so the card's rows and a worker's agree bit for bit) and the
    chain's dh series."""
    b, t, d, h = 32, RAW_T, 1, 512
    rng = np.random.RandomState(43)
    k = 1.0 / np.sqrt(h)
    x = torch.from_numpy(rng.randn(t, b, d).astype(np.float32))
    w_ih, w_hh, bias = (torch.from_numpy(rng.uniform(-k, k, s).astype(np.float32))
                        for s in ((d, 4 * h), (h, 4 * h), (4 * h,)))
    return {"x": x, "w_ih": w_ih, "w_hh": w_hh, "b": bias,
            "dhf": torch.from_numpy(rng.randn(b, h).astype(np.float32)),
            "ih_rows": torch.matmul(x[:, list(rows)], w_ih) + bias,
            "dhs_rows": _raw_rows_rand(44, rows, (t, h), normal=True)}


def _raw_plain_job(job: str) -> dict:
    """One of ``RAW_JOBS``: the plain versions on the CPU over ``RAW_ROWS``
    of the batch, in a worker process of its own (one thread), while the
    card runs the other phases.  Each output goes to ``RAW_PLAIN`` as
    ``<job>_<name>.npy``; returns ``{name: seconds}`` of each plain call."""
    torch.set_num_threads(1)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel as lk

    RAW_PLAIN.mkdir(parents=True, exist_ok=True)
    secs = {}

    def run(name, fn, outs):
        t0 = time.perf_counter()
        res = fn()
        secs[name] = time.perf_counter() - t0
        for out_name, out in zip(outs, res if isinstance(res, tuple) else (res,)):
            np.save(RAW_PLAIN / f"{job}_{out_name}.npy", out.numpy())
        return res

    with torch.inference_mode():
        if job == "lstm1":
            inp = _raw_layer_inputs()
            g, _, c_prev, _ = run("lstm1_train_fwd", lambda: lk.lstm1_train_fwd_reference(
                inp["ih_rows"], inp["w_hh"]), ("g", "h_prev", "c_prev", "finals"))
            run("lstm_bwd_chain", lambda: lk.lstm_bwd_chain_reference(
                g, c_prev, inp["dhs_rows"], inp["dhf"][list(RAW_ROWS)], inp["w_hh"]),
                ("dg",))
            return secs
        cell, part = job.split("_")
        lstm = cell == "lstm"
        x_tm, keep, l0, l1, dh = _raw_pair_inputs(40 if lstm else 41, 4 if lstm else 3)
        if part == "eval":
            inf_ref = lk.lstm2_infer_reference if lstm else lk.gru2_infer_reference
            x_bt = x_tm.transpose(0, 1).contiguous()
            run(f"{cell}2_infer", lambda: inf_ref(x_bt, l0, l1), ("h1",))
            return secs
        fwd_ref, bwd_ref = ((lk.lstm2_train_fwd_reference, lk.lstm2_bwd_chain_reference)
                            if lstm else
                            (lk.gru2_train_fwd_reference, lk.gru2_bwd_chain_reference))
        outs = run(f"{cell}2_train_fwd", lambda: fwd_ref(x_tm, keep, l0, l1),
                   ("packed", "h0_prev", "h1_prev", "x1", "finals"))
        series = (outs[0],) if lstm else outs[:3]
        run(f"{cell}2_bwd_chain", lambda: bwd_ref(
            *series, keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"]),
            ("dg0", "dg1") if lstm else ("dih0", "dhn0", "dih1", "dhn1"))
    return secs


def _raw_plain(pending, job: str, names):
    """Wait for ``job``'s worker: ``({name: plain output over RAW_ROWS, on
    the CPU}, {kernel: plain seconds})``."""
    secs = pending[job].get()
    return {n: torch.from_numpy(np.load(RAW_PLAIN / f"{job}_{n}.npy")) for n in names}, secs


def split_errs(out: torch.Tensor, ref: torch.Tensor, row: int, chunk: int = 2048):
    """A time-major series (T, b, ...) against its plain version: the max
    abs error over each run of steps, cut where the full series' offsets
    (``row`` elements a step) pass 2^29 and 2^31 elements (a 32-bit byte
    offset, a 32-bit element offset), and the largest |ref|; chunked over
    T, so no temporary is as large as the series."""
    t = out.shape[0]
    cuts = sorted({c for c in (2**29 // row, 2**31 // row) if 0 < c < t})
    step_err = torch.empty(t, device=out.device)
    largest = 0.0
    for t0 in range(0, t, chunk):
        o, r = out[t0:t0 + chunk], ref[t0:t0 + chunk]
        step_err[t0:t0 + chunk] = (o - r).abs().flatten(1).amax(1)
        largest = max(largest, float(r.abs().max()))
    ends = [0, *cuts, t]
    return [(lo, hi, float(step_err[lo:hi].max())) for lo, hi in zip(ends, ends[1:])], largest


def _raw_check(tag: str, outs, refs, axes) -> float:
    """Hold ``RAW_ROWS`` of each kernel output in ``outs`` (``{name:
    tensor}``, full batch on the card; the rows along ``axes[name]``) to
    1e-4 of its plain version's largest entry (``refs``, over those rows),
    printing each series' errors per run of steps cut where the full
    series' offsets pass 2^29 and 2^31 elements; returns the largest
    error."""
    worst = 0.0
    for name, out in outs.items():
        sel = out.index_select(axes.get(name, 1), torch.tensor(RAW_ROWS, device=out.device))
        ref = refs[name].to(out.device)
        if out.dim() == 3 and out.shape[0] == RAW_T:
            segs, largest = split_errs(sel, ref, out[0].numel())
            text = ", ".join(f"steps [{lo}, {hi}) {e:.3e}" for lo, hi, e in segs)
            err = max(e for *_, e in segs)
        else:
            err, largest = float((sel - ref).abs().max()), float(ref.abs().max())
            text = f"{err:.3e}"
        print(f"[{tag}] {name} {tuple(out.shape)}, rows {RAW_ROWS}: max abs err {text}; "
              f"largest |plain| {largest:.3e} (bound 1e-4 of it)")
        if not err <= 1e-4 * largest:
            raise RuntimeError(f"[{tag}] {name} disagrees with its plain version")
        worst = max(worst, err)
        del sel, ref
    return worst


def _raw_record(kernels, name: str, tag: str, err: float, ms: float,
                plain_s: float, b: int, t: int, d: int, h: int, layers: int) -> None:
    """Print a kernel's time at the raw shape beside its bound and add the
    ``raw_*`` numbers to its entry of the kernels line."""
    flops, nbytes = _work(name, b, t, d, h)
    bound_ms, bound_by = bound(flops, nbytes)
    phases = t + 1 if layers == 2 else t
    print(f"[{tag}] {name} B={b} T={t} D={d} H={h}: kernel {ms:.4f} ms "
          f"({1e3 * ms / phases:.3f} us per {'phase' if layers == 2 else 'step'}), "
          f"plain {1e3 * plain_s:.4f} ms (on the CPU over rows {RAW_ROWS}, one thread, "
          f"beside the card), bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB) + a serial "
          f"chain of {layers * t} layer-steps")
    kernels[name].update(raw_max_abs_err=err, raw_ms=ms, raw_plain_ms=1e3 * plain_s,
                         raw_plain_rows=list(RAW_ROWS), raw_bound_ms=bound_ms,
                         raw_bound_by=bound_by)


def _put_rows(full: torch.Tensor, rows: torch.Tensor, axis: int = 1) -> None:
    """Write ``rows`` (the plain version's, on the CPU) into ``RAW_ROWS`` of
    the card tensor ``full`` along ``axis``."""
    full.index_copy_(axis, torch.tensor(RAW_ROWS, device=full.device), rows.to(full.device))


def _raw_library(kernels, tag: str, lib, x_bt: torch.Tensor, dh: torch.Tensor,
                 names) -> None:
    """cuDNN at the raw shape, TF32 off, one call each after one warm call
    (each takes seconds): the inference forward, the training forward
    (autograd on, saving what the backward needs) and the backward of
    ``h_n``, which also forms the weight gradients; into the entries of
    ``names`` (eval form, training forward, reverse chain; None skips one)
    as ``raw_library_ms``."""
    params = list(lib.parameters())

    def last_h():  # the top layer's final h (an LSTM's h_n is (h, c))
        h_n = lib(x_bt)[1]
        return (h_n[0] if isinstance(h_n, tuple) else h_n)[-1]

    times = {}
    with torch.no_grad():
        lib(x_bt)
        _, times["infer"] = timed_ms(lambda: lib(x_bt))
    torch.autograd.grad(last_h(), params, dh)
    h_last, times["train_fwd"] = timed_ms(last_h)
    _, times["bwd"] = timed_ms(lambda: torch.autograd.grad(h_last, params, dh))
    del h_last
    torch.cuda.empty_cache()
    b, t, d = x_bt.shape
    print(f"[{tag}] cuDNN {type(lib).__name__}({d}, {lib.hidden_size}, num_layers="
          f"{lib.num_layers}) at B={b} T={t}, TF32 off, one call after a warm one: "
          f"inference forward {times['infer']:.4f} ms, training forward "
          f"{times['train_fwd']:.4f} ms, backward of h_n {times['bwd']:.4f} ms")
    for name, key in zip(names, ("infer", "train_fwd", "bwd")):
        if name is not None:
            kernels[name]["raw_library_ms"] = times[key]


def phase_pair_raw(lstm_kernel, flush, kernels, cell: str, pending) -> None:
    """``[lstm_raw]`` / ``[gru_raw]``: the 2-layer pair of base.yaml (or
    base.yaml + GRU) on the raw waveform at B=32, T=48,000, D=1, H=256,
    keep p=0.1: the training forward, then the reverse chain over its
    residuals, then the eval forward, each over the whole batch on the card
    and held on ``RAW_ROWS`` against its plain version, which a worker ran
    on the CPU over those rows (the chain over the plain forward's
    residuals: the card's chain takes them in those rows); each timed
    (median of 5, L2 flushed)."""
    lstm = cell == "lstm"
    tag = f"{cell}_raw"
    x_tm, keep, l0, l1, dh = _raw_pair_inputs(40 if lstm else 41, 4 if lstm else 3,
                                              rows=None)
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    fwd, bwd, inf = (
        (lstm_kernel.lstm2_train_fwd_residuals, lstm_kernel.lstm2_bwd_chain,
         lstm_kernel.lstm2_infer) if lstm else
        (lstm_kernel.gru2_train_fwd_residuals, lstm_kernel.gru2_bwd_chain,
         lstm_kernel.gru2_infer))
    names = [f"{cell}2_train_fwd", f"{cell}2_bwd_chain", f"{cell}2_infer"]
    print(f"[{tag}] B={b} T={t} D={d} H={h}, keep p=0.1: the packed rows pass 2^31 "
          f"elements from step {2**31 // (b * (10 if lstm else 8) * h)}")

    fwd_names = ("packed", "h0_prev", "h1_prev", "x1", "finals")
    chain_names = ("dg0", "dg1") if lstm else ("dih0", "dhn0", "dih1", "dhn1")
    refs, secs = _raw_plain(pending, f"{cell}_train", fwd_names + chain_names)
    outs = fwd(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    err = _raw_check(tag, dict(zip(fwd_names, outs)), refs, {})
    series = list(outs[:1] if lstm else outs[:3])
    del outs
    ms = device_ms(lambda: fwd(x_tm, keep, l0, l1), flush, reps=5, warmup=1)
    _raw_record(kernels, names[0], tag, err, ms, secs[names[0]], b, t, d, h, 2)

    # the chain over the kernel's residuals, with the plain forward's in
    # RAW_ROWS: those rows' dgates are then the plain chain's to hold to
    for name, s in zip(fwd_names, series):
        _put_rows(s, refs[name])
    args = (*series, keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    del series
    outs = bwd(*args)
    torch.cuda.synchronize()
    err = _raw_check(tag, dict(zip(chain_names, outs)), refs, {})
    del outs, refs
    ms = device_ms(lambda: bwd(*args), flush, reps=5, warmup=1)
    _raw_record(kernels, names[1], tag, err, ms, secs[names[1]], b, t, d, h, 2)
    del args

    x_bt = x_tm.transpose(0, 1).contiguous()
    refs, secs = _raw_plain(pending, f"{cell}_eval", ("h1",))
    out = inf(x_bt, l0, l1)
    torch.cuda.synchronize()
    err = _raw_check(tag, {"h1": out}, refs, {"h1": 0})
    ms = device_ms(lambda: inf(x_bt, l0, l1), flush, reps=5, warmup=1)
    _raw_record(kernels, names[2], tag, err, ms, secs[names[2]], b, t, d, h, 2)
    del out, keep, x_tm
    torch.cuda.empty_cache()
    lib = _cudnn_lstm(l0, l1) if lstm else _cudnn_gru(l0, l1)
    _raw_library(kernels, tag, lib, x_bt, dh, (names[2], names[0], names[1]))
    del lib, x_bt
    torch.cuda.empty_cache()


def phase_lstm1_raw(lstm_kernel, lstm_vjp, flush, kernels, pending) -> None:
    """``[lstm1_raw]``: one layer of the layered route on the raw waveform
    (B=32, T=48,000, H=512, layer 0's input D=1): the training forward
    (row 6), then the reverse chain over its residuals with a dh series
    (row 4), each over the whole batch on the card, held on ``RAW_ROWS``
    against its plain version from a worker (as ``[lstm_raw]``), and timed;
    the one-layer cores are the GRU's too (rows 7f / 7), so this covers
    their addressing.  Then the big sweep config on raw (LSTM 3x512, b32),
    whose full-length residuals exceed the card, must be refused before it
    allocates them."""
    dev = torch.device("cuda")
    tag, b, t, d, h = "lstm1_raw", 32, RAW_T, 1, 512
    inp = _raw_layer_inputs()
    x, w_ih, w_hh, bias = (inp[k].to(dev) for k in ("x", "w_ih", "w_hh", "b"))
    ih = torch.matmul(x, w_ih) + bias
    _put_rows(ih, inp["ih_rows"])
    print(f"[{tag}] B={b} T={t} D={d} H={h}: g (T, B, 4H) passes 2^31 elements "
          f"from step {2**31 // (b * 4 * h)}")
    fwd_names = ("g", "h_prev", "c_prev", "finals")
    refs, secs = _raw_plain(pending, "lstm1", fwd_names + ("dg",))
    outs = lstm_kernel.lstm1_train_fwd(ih, w_hh)
    torch.cuda.synchronize()
    err = _raw_check(tag, dict(zip(fwd_names, outs)), refs, {"finals": 0})
    g, c_prev = outs[0], outs[2]
    del outs
    ms = device_ms(lambda: lstm_kernel.lstm1_train_fwd(ih, w_hh), flush, reps=5, warmup=1)
    _raw_record(kernels, "lstm1_train_fwd", tag, err, ms, secs["lstm1_train_fwd"],
                b, t, d, h, 1)
    del ih

    _put_rows(g, refs["g"])
    _put_rows(c_prev, refs["c_prev"])
    gen = torch.Generator(device=dev).manual_seed(44)
    dhs = torch.randn((t, b, h), generator=gen, device=dev)
    _put_rows(dhs, inp["dhs_rows"])
    dhf = inp["dhf"].to(dev)
    args = (g, c_prev, dhs, dhf, w_hh)
    out = lstm_kernel.lstm_bwd_chain(*args)
    torch.cuda.synchronize()
    err = _raw_check(tag, {"dg": out}, refs, {})
    del out, refs
    ms = device_ms(lambda: lstm_kernel.lstm_bwd_chain(*args), flush, reps=5, warmup=1)
    _raw_record(kernels, "lstm_bwd_chain", tag, err, ms, secs["lstm_bwd_chain"],
                b, t, d, h, 1)
    del args, g, c_prev, dhs
    torch.cuda.empty_cache()
    lib = _cudnn_lstm({"w_ih": w_ih, "w_hh": w_hh, "b": bias})
    x_bt = x.transpose(0, 1).contiguous()
    _raw_library(kernels, tag, lib, x_bt, dhf,
                 (None, "lstm1_train_fwd", "lstm_bwd_chain"))
    del lib, x_bt, x
    torch.cuda.empty_cache()

    # the big sweep config's stack on raw: the budget refuses it before any
    # residual is allocated
    layers = [{n: torch.zeros(s, device=dev, requires_grad=True)
               for n, s in (("w_ih", (d if i == 0 else h, 4 * h)), ("w_hh", (h, 4 * h)),
                            ("b", (4 * h,)))} for i in range(3)]
    x_bt = torch.zeros(b, t, d, device=dev)
    keep = torch.ones(t, 2, b, h, device=dev)
    before = torch.cuda.memory_allocated()
    need = lstm_vjp.stack_residual_bytes("lstm", 3, h, d, b, t, "layered")
    try:
        lstm_vjp.fused_lstm_final(x_bt, keep, layers)
    except NotImplementedError as e:
        if "item 17" not in str(e):
            raise
        print(f"[{tag}] the big config on raw (LSTM 3x{h}, B={b}, T={t}): "
              f"{need / 1e9:.2f} GB of residuals, refused: {e}")
    else:
        raise RuntimeError("the big config on raw was not refused")
    if torch.cuda.memory_allocated() != before:
        raise RuntimeError("the refused stack allocated device memory")
    # what the same stack holds with bf16 residual streams, beside what the
    # card can still give (not run: the float32 refusal above stands)
    need16 = lstm_vjp.stack_residual_bytes("lstm", 3, h, d, b, t, "layered",
                                           res_dtype="bfloat16")
    free = lstm_vjp.card_free_bytes(dev)
    print(f"[{tag}] the big config on raw with bf16 residual streams "
          f"(runtime.lstm_residual_dtype): {need16 / 1e9:.2f} GB of residuals, the card "
          f"can still give {free / 1e9:.2f} GB ({'fits' if need16 <= free else 'does not fit'}"
          "; not run)")
    del layers, x_bt, keep
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# bf16 residual streams (runtime.lstm_residual_dtype, configs/fast.yaml)
# ---------------------------------------------------------------------------


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bf16 ulps of two bf16 tensors: their bit
    patterns on a monotonic integer line (-0 and +0 at one point)."""
    def ordinal(t):
        u = t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, 0x8000 - u, u)

    return (ordinal(a) - ordinal(b)).abs()


def half_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |out - ref| in units of one bf16 ulp of ref plus 1e-6 of
    ref's largest entry: a bf16 output within one ulp of its plain version
    (whose float32 value may sit on the other side of a rounding boundary)
    is at most 1."""
    o, r = out.to(torch.float32), ref.to(torch.float32)
    _, e = torch.frexp(r)
    ulp = torch.ldexp(torch.ones_like(r), e - 8)
    return float(((o - r).abs() / (ulp + 1e-6 * r.abs().max())).max())


def _half_work(name: str, b: int, t: int, d: int, h: int):
    """``_work`` of a bf16 form: the same products, each bf16 series 2
    bytes a value (the float32 inputs, finals and weights 4); the remat
    pair's (rows 11n, 13: the chain's three products and the gates'
    recompute, D + H and 2H deep) too."""
    tb = t * b
    weights = 4 * (d * 4 * h + 3 * h * 4 * h + 2 * 4 * h)
    if name == "lstm2_train_fwd_nogates":  # x, keep in; packed 2H, h0p, h1p, x1 out
        return (2 * b * t * (d * 4 * h + 3 * h * 4 * h),
                4 * tb * (d + h) + 2 * tb * 5 * h + weights + 4 * 4 * b * h)
    if name == "lstm2_bwd_chain_remat":  # packed 2H, x, x1, h0p, h1p, keep in; dg out
        return (2 * t * b * 4 * h * (3 * h + d + h + 2 * h),
                2 * tb * (2 * h + d + 3 * h + 8 * h) + 4 * (tb * h + b * h) + weights)
    flops = _work(name, b, t, d, h)[0]
    if name == "lstm2_train_fwd":  # x, keep in; packed 10H, h0p, h1p, x1 out
        nbytes = (4 * tb * (d + h) + 2 * tb * 13 * h
                  + 4 * (d * 4 * h + 3 * h * 4 * h + 2 * 4 * h + 4 * b * h))
    elif name == "lstm2_bwd_chain":  # packed 10H, keep in; dg0, dg1 out
        nbytes = 2 * tb * 18 * h + 4 * (tb * h + b * h + 3 * h * 4 * h)
    elif name == "gru2_train_fwd":  # x, keep in; packed 8H, h0p, h1p, x1 out
        nbytes = (4 * tb * (d + h) + 2 * tb * 11 * h
                  + 4 * (d * 3 * h + 3 * h * 3 * h + 4 * 3 * h + 2 * b * h))
    elif name == "gru2_bwd_chain":  # packed 8H, h0p, h1p, keep in; dih, dhn out
        nbytes = 2 * tb * 18 * h + 4 * (tb * h + b * h + 3 * h * 3 * h)
    elif name == "lstm1_train_fwd":  # ih in; g, c_prev bf16, h_prev out
        nbytes = (4 * tb * 4 * h + 2 * tb * 5 * h + 4 * tb * h
                  + 4 * (h * 4 * h + 2 * b * h))
    elif name == "lstm_bwd_chain":  # g, c_prev bf16, dh_series in; dg out
        nbytes = (2 * tb * 5 * h + 4 * tb * h + 4 * tb * 4 * h
                  + 4 * (b * h + h * 4 * h))
    else:
        raise KeyError(name)
    return flops, nbytes


def _same_rule(tag: str, what: str, out16: torch.Tensor, ref32: torch.Tensor,
               facts: list, ulps_allowed: int = 1) -> None:
    """A bf16 form's output against the float32 form's rounded to bf16 on
    the card: bit for bit, or within ``ulps_allowed`` bf16 ulps (one where
    contraction differs between the two instantiations; none for the
    remat pair's bf16 forms), the count printed."""
    ulps = bf16_ulps(out16, ref32.to(torch.bfloat16))
    worst, differ = int(ulps.max()), int((ulps > 0).sum())
    facts.append(f"{what} {'bit for bit' if not differ else f'{differ} of {ulps.numel()} differ, by <= {worst} ulp'}")
    if worst > ulps_allowed:
        raise RuntimeError(f"{tag}: {what} is {worst} bf16 ulps from the float32 form's")


def _check_half_vs_plain(tag: str, names, outs, refs, errs: dict) -> float:
    """Each output against its plain version: float32 ones within 1e-4 of
    the largest entry, bf16 ones within one bf16 ulp plus 1e-6 of it.
    Returns the largest absolute difference."""
    worst = 0.0
    for name, out, ref in zip(names, outs, refs):
        worst = max(worst, max_errs(out.to(torch.float32), ref.to(torch.float32))[0])
        if out.dtype != ref.dtype:
            raise RuntimeError(f"{tag}: {name} is {out.dtype}, its plain version {ref.dtype}")
        if out.dtype == torch.bfloat16:
            errs[f"{name} (bf16 ulps)"] = err = half_err(out, ref)
            bad = err > 1.0
        else:
            errs[f"{name} (of largest)"] = err = (
                max_errs(out, ref)[0] / max(float(ref.abs().max()), 1e-30))
            bad = err > 1e-4
        if bad:
            raise RuntimeError(f"{tag}: {name} disagrees with its plain version ({err:.3e})")
    return worst


def _res_bf16_pair(tag, lstm_kernel, flush, cell, inputs, rows, lib_fwd, lib_bwd):
    """Rows 11 and 12 (``cell`` "lstm") or 14 and 15 ("gru") in bf16: the
    forward's finals bit for bit the float32 form's and its series the
    float32 form's rounded (``_same_rule``), the chain over those bf16
    residuals against the float32 chain over them upcast (the same rule),
    both against their plain versions (``_check_half_vs_plain``) at each of
    ``rows``; both forms timed at the first, beside the library's."""
    x_tm, keep, l0, l1 = inputs
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    bf16 = torch.bfloat16
    fwd = getattr(lstm_kernel, f"{cell}2_train_fwd_residuals")
    fwd_ref = getattr(lstm_kernel, f"{cell}2_train_fwd_reference")
    chain = getattr(lstm_kernel, f"{cell}2_bwd_chain")
    chain_ref = getattr(lstm_kernel, f"{cell}2_bwd_chain_reference")
    series = ("packed", "h0_prev", "h1_prev", "x1")
    outs_names = (("dg0", "dg1") if cell == "lstm" else ("dih0", "dhn0", "dih1", "dhn1"))
    dh_all = torch.from_numpy(np.random.RandomState(7).randn(b, h).astype(np.float32)).cuda()
    w_chain = ((l0["w_hh"], l1["w_hh"], l1["w_ih"]))

    def chain_args(res, n, dh):
        packed, h0p, h1p = res[0], res[1], res[2]
        lead = (packed, keep_n(n)) if cell == "lstm" else (packed, h0p, h1p, keep_n(n))
        return (*lead, dh, *w_chain)

    def keep_n(n):
        return keep[:, :n].contiguous()

    facts, errs, abs_err = [], {}, {"fwd": 0.0, "chain": 0.0}
    for n in rows:
        sub = (x_tm[:, :n].contiguous(), keep_n(n), l0, l1)
        outs32 = fwd(*sub)
        outs16 = fwd(*sub, res_dtype=bf16)
        torch.cuda.synchronize()
        if not torch.equal(outs16[4], outs32[4]):
            raise RuntimeError(f"{tag}: B={n}: the bf16 form's finals are not the "
                               "float32 form's bit for bit")
        facts.append(f"B={n}: finals bit for bit")
        for name, o16, o32 in zip(series, outs16, outs32):
            _same_rule(tag, f"B={n} {name}", o16, o32, facts)
        abs_err["fwd"] = max(abs_err["fwd"], _check_half_vs_plain(
            f"{tag} B={n}", (*series, "finals"), outs16, fwd_ref(*sub, res_dtype=bf16),
            errs))
        del outs32
        dh = dh_all[:n].contiguous()
        args16 = chain_args(outs16, n, dh)
        args32 = tuple(a.to(torch.float32) if a.dtype == bf16 else a for a in args16)
        d16, d32 = chain(*args16), chain(*args32)
        torch.cuda.synchronize()
        for name, o16, o32 in zip(outs_names, d16, d32):
            _same_rule(tag, f"B={n} {name}", o16, o32, facts)
        abs_err["chain"] = max(abs_err["chain"], _check_half_vs_plain(
            f"{tag} B={n}", outs_names, d16, chain_ref(*args16), errs))
        del outs16, d16, d32, args32
    print(f"[{tag}] B={rows} T={t} D={d} H={h}: bf16 forms vs float32 forms on the "
          f"card: {'; '.join(facts)}")
    print(f"[{tag}] vs the plain versions (bf16 outputs within one bf16 ulp + 1e-6 "
          "of the largest entry = 1, float32 within 1e-4 of the largest): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    # both forms in one call, at the first shape: each bf16 form against
    # the float32 form of the same source on the same inputs
    res16 = fwd(x_tm, keep, l0, l1, res_dtype=bf16)
    args16 = chain_args(res16, b, dh_all)
    res32 = fwd(x_tm, keep, l0, l1)
    args32 = chain_args(res32, b, dh_all)
    times = {
        "fwd_bf16": device_ms(lambda: fwd(x_tm, keep, l0, l1, res_dtype=bf16), flush),
        "fwd_f32": device_ms(lambda: fwd(x_tm, keep, l0, l1), flush),
        "chain_bf16": device_ms(lambda: chain(*args16), flush),
        "chain_f32": device_ms(lambda: chain(*args32), flush),
        "fwd_plain": device_ms(lambda: fwd_ref(x_tm, keep, l0, l1, res_dtype=bf16),
                               flush, reps=3),
        "chain_plain": device_ms(lambda: chain_ref(*args16), flush, reps=3),
        "fwd_library": device_ms(lib_fwd, flush),
        "chain_library": device_ms(lib_bwd, flush),
    }
    del res32, args32
    kerns = []
    for part, row_name in (("fwd", f"{cell}2_train_fwd"), ("chain", f"{cell}2_bwd_chain")):
        flops, nbytes = _half_work(row_name, b, t, d, h)
        bound_ms, bound_by = bound(flops, nbytes)
        ms, f32_ms = times[f"{part}_bf16"], times[f"{part}_f32"]
        print(f"[{tag}] {row_name} bf16 form {ms:.4f} ms, float32 form {f32_ms:.4f} ms "
              f"({100 * (ms / f32_ms - 1):+.1f}%), {1e3 * ms / (t + 1):.3f} us per "
              f"phase; plain {times[f'{part}_plain']:.4f} ms, library "
              f"{times[f'{part}_library']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
        kerns.append({"name": f"{row_name}_bf16", "route": "cuda",
                      "source": f"{CSRC}{row_name}.cu",
                      "core": CSRC + ("rnn2_fwd_chain.cuh" if part == "fwd"
                                      else "rnn2_bwd_chain.cuh"),
                      "max_abs_err": abs_err[part],
                      "ms": ms, "plain_ms": times[f"{part}_plain"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": times[f"{part}_library"],
                      "f32_ms": f32_ms})
    return kerns


def phase_lstm2_res_bf16(lstm_kernel, flush):
    """``[lstm2_res_bf16]``: rows 11 and 12's bf16 forms at the flagship's
    B 32, T 372, D 64, H 256 and at B 17 and 1 (``_res_bf16_pair``)."""
    x_tm, keep, l0, l1 = _lstm_train_inputs(21)
    lib = _cudnn_lstm(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()
    lib_params = list(lib.parameters())
    h_lib = lib(x_bt)[1][0][-1]
    dh = torch.ones_like(h_lib)
    kerns = _res_bf16_pair(
        "lstm2_res_bf16", lstm_kernel, flush, "lstm", (x_tm, keep, l0, l1), (32, 17, 1),
        lambda: lib(x_bt),
        lambda: torch.autograd.grad(h_lib, lib_params, dh, retain_graph=True))
    kerns[0]["replaces"] = "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:2270"
    kerns[1]["replaces"] = "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:2482"
    return kerns


def phase_gru2_res_bf16(lstm_kernel, flush):
    """``[gru2_res_bf16]``: rows 14 and 15's bf16 forms at the GRU config's
    B 32, T 372, D 64, H 256 and at B 1 (``_res_bf16_pair``)."""
    x_tm, keep, l0, l1 = _gru_inputs(22)
    lib = _cudnn_gru(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()
    lib_params = list(lib.parameters())
    h_lib = lib(x_bt)[1][-1]
    dh = torch.ones_like(h_lib)
    kerns = _res_bf16_pair(
        "gru2_res_bf16", lstm_kernel, flush, "gru", (x_tm, keep, l0, l1), (32, 1),
        lambda: lib(x_bt),
        lambda: torch.autograd.grad(h_lib, lib_params, dh, retain_graph=True))
    kerns[0]["replaces"] = "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:2812"
    kerns[1]["replaces"] = "multimodal_emotion_detection_tpu/ops/lstm_kernel.py:3053"
    return kerns


def phase_lstm1_res_bf16(lstm_kernel, flush):
    """``[lstm1_res_bf16]``: rows 6 and 4's bf16 forms at the big config's
    deeper layer (B 32, T 372, H 512): the forward's h_prev and finals bit
    for bit the float32 form's, its g and c_prev the float32 form's
    rounded; the chain (with a dh_series, as a lower layer's) over those
    bf16 residuals against the float32 chain over them upcast, rounded to
    bf16 (float32 outputs: the same rule); both against the plain
    versions; both forms timed beside cuDNN's."""
    tag, bf16 = "lstm1_res_bf16", torch.bfloat16
    inputs, w_hh = _big_layer_inputs(23)
    x, w_ih, bias = inputs["D=512"]
    t, b, _ = x.shape
    h = w_hh.shape[0]
    ih = torch.matmul(x, w_ih) + bias
    rng = np.random.RandomState(24)
    dhf = torch.from_numpy(rng.randn(b, h).astype(np.float32)).cuda()
    dhs = torch.from_numpy(rng.randn(t, b, h).astype(np.float32)).cuda()
    names = ("g", "h_prev", "c_prev", "finals")
    facts, errs, abs_err = [], {}, {"fwd": 0.0, "chain": 0.0}
    for n in (32, 1):
        ih_n, dhf_n, dhs_n = (a[:, :n].contiguous() if a.dim() == 3 else a[:n].contiguous()
                              for a in (ih, dhf, dhs))
        o32 = lstm_kernel.lstm1_train_fwd(ih_n, w_hh)
        o16 = lstm_kernel.lstm1_train_fwd(ih_n, w_hh, bf16)
        torch.cuda.synchronize()
        for name, a16, a32 in zip(names, o16, o32):
            if a16.dtype == bf16:
                _same_rule(tag, f"B={n} {name}", a16, a32, facts)
            elif not torch.equal(a16, a32):
                raise RuntimeError(f"{tag}: B={n} {name} is not the float32 form's bit "
                                   "for bit")
            else:
                facts.append(f"B={n} {name} bit for bit")
        abs_err["fwd"] = max(abs_err["fwd"], _check_half_vs_plain(
            f"{tag} B={n}", names, o16,
            lstm_kernel.lstm1_train_fwd_reference(ih_n, w_hh, bf16), errs))
        g16, c16 = o16[0], o16[2]
        d16 = lstm_kernel.lstm_bwd_chain(g16, c16, dhs_n, dhf_n, w_hh)
        d32 = lstm_kernel.lstm_bwd_chain(g16.float(), c16.float(), dhs_n, dhf_n, w_hh)
        torch.cuda.synchronize()
        if torch.equal(d16, d32):
            facts.append(f"B={n} dg bit for bit")
        else:
            _same_rule(tag, f"B={n} dg", d16.to(bf16), d32, facts)
        abs_err["chain"] = max(abs_err["chain"], _check_half_vs_plain(
            f"{tag} B={n}", ("dg",), (d16,),
            (lstm_kernel.lstm_bwd_chain_reference(g16, c16, dhs_n, dhf_n, w_hh),), errs))
    print(f"[{tag}] B=(32, 1) T={t} H={h}: bf16 forms vs float32 forms on the card: "
          f"{'; '.join(facts)}")
    print(f"[{tag}] vs the plain versions (bf16 outputs within one bf16 ulp + 1e-6 "
          "of the largest entry = 1, float32 within 1e-4 of the largest): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    lib = _cudnn_lstm({"w_ih": w_ih, "w_hh": w_hh, "b": bias}, batch_first=False)
    lib_params = list(lib.parameters())
    h_lib = lib(x)[1][0][-1]
    g16, _, c16, _ = lstm_kernel.lstm1_train_fwd(ih, w_hh, bf16)
    g32, c32 = g16.float(), c16.float()
    times = {
        "fwd_bf16": device_ms(lambda: lstm_kernel.lstm1_train_fwd(ih, w_hh, bf16), flush),
        "fwd_f32": device_ms(lambda: lstm_kernel.lstm1_train_fwd(ih, w_hh), flush),
        "chain_bf16": device_ms(
            lambda: lstm_kernel.lstm_bwd_chain(g16, c16, dhs, dhf, w_hh), flush),
        "chain_f32": device_ms(
            lambda: lstm_kernel.lstm_bwd_chain(g32, c32, dhs, dhf, w_hh), flush),
        "fwd_plain": device_ms(
            lambda: lstm_kernel.lstm1_train_fwd_reference(ih, w_hh, bf16), flush, reps=3),
        "chain_plain": device_ms(
            lambda: lstm_kernel.lstm_bwd_chain_reference(g16, c16, dhs, dhf, w_hh), flush,
            reps=3),
        "fwd_library": device_ms(lambda: lib(x), flush),
        "chain_library": device_ms(
            lambda: torch.autograd.grad(h_lib, lib_params, dhf, retain_graph=True), flush),
    }
    kerns = []
    for part, row_name, source, core, line in (
            ("fwd", "lstm1_train_fwd", "lstm1_fwd", "rnn_fwd_chain.cuh", 1078),
            ("chain", "lstm_bwd_chain", "lstm_bwd_chain", "rnn_bwd_chain.cuh", 514)):
        flops, nbytes = _half_work(row_name, b, t, 0, h)
        bound_ms, bound_by = bound(flops, nbytes)
        ms, f32_ms = times[f"{part}_bf16"], times[f"{part}_f32"]
        print(f"[{tag}] {row_name} bf16 form {ms:.4f} ms, float32 form {f32_ms:.4f} ms "
              f"({100 * (ms / f32_ms - 1):+.1f}%), {1e3 * ms / t:.3f} us per step; plain "
              f"{times[f'{part}_plain']:.4f} ms, cuDNN nn.LSTM({h}, {h}) "
              f"{times[f'{part}_library']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
        kerns.append({"name": f"{row_name}_bf16", "route": "cuda",
                      "source": f"{CSRC}{source}.cu", "core": CSRC + core,
                      "replaces": f"multimodal_emotion_detection_tpu/ops/lstm_kernel.py:{line}",
                      "max_abs_err": abs_err[part], "ms": ms, "plain_ms": times[f"{part}_plain"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": times[f"{part}_library"],
                      "f32_ms": f32_ms})
    return kerns


def phase_lstm2_remat_bf16(lstm_kernel, lstm_vjp, flush):
    """``[lstm2_remat_bf16]``: rows 11n and 13's bf16 forms (the remat pair
    with bf16 streams) at the flagship's training shape (B 32, T 372, D 64,
    H 256, keep p 0.1).  The no-gates forward's finals bit for bit the
    float32 no-gates form's and its series that form's rounded, bit for bit,
    at B 32, 17 and 1; the remat chain over those streams (x cast to bf16)
    against the float32 chain over them upcast, rounded, bit for bit, at B
    32, 17, 1 and 128 (slices of the batch); both against their plain
    versions (one bf16 ulp + 1e-6 of the largest entry); both timed beside
    their float32 forms, row 12b (over row 11b's streams), cuDNN and the
    plain versions; the whole recurrence gradient against the same route's
    on the CPU, where the wrappers run the plain versions and round at the
    same points (2e-3 of each largest entry, the bf16 streams' rule), and
    further from the card's float32 remat gradient than that (the rounding
    engaged); its peak memory beside the stored-gates bf16 route's, the
    float32 remat route's and ``stack_residual_bytes``' figure."""
    tag, bf16 = "lstm2_remat_bf16", torch.bfloat16
    x_tm, keep, l0, l1 = _lstm_train_inputs(27)
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    fwd, fwd_ref = lstm_kernel.lstm2_train_fwd_residuals, lstm_kernel.lstm2_train_fwd_reference
    chain, chain_ref = lstm_kernel.lstm2_bwd_chain_remat, lstm_kernel.lstm2_bwd_chain_remat_reference
    fwd16, chain16 = lstm_kernel.LSTM2_TRAIN_FWD_NOGATES_BF16, lstm_kernel.LSTM2_BWD_CHAIN_REMAT_BF16
    series = ("packed", "h0_prev", "h1_prev", "x1")
    facts, errs, abs_err = [], {}, {"fwd": 0.0, "chain": 0.0}

    def chain_args(res, xs, ks, dh, w0, w1):
        return (res[0], ks, xs.to(bf16), res[3], res[1], res[2], dh, w0, w1)

    wide = _lstm_train_inputs(28, b=128)
    for n in (32, 17, 1, 128):
        xs, ks, w0, w1 = wide if n == 128 else (
            x_tm[:, :n].contiguous(), keep[:, :n].contiguous(), l0, l1)
        before = (fwd16.launches, chain16.launches)
        o16 = fwd(xs, ks, w0, w1, store_gates=False, res_dtype=bf16)
        o32 = fwd(xs, ks, w0, w1, store_gates=False)
        torch.cuda.synchronize()
        if not torch.equal(o16[4], o32[4]):
            raise RuntimeError(f"{tag}: B={n}: the finals are not the float32 form's")
        facts.append(f"B={n} finals bit for bit")
        for name, a16, a32 in zip(series, o16, o32):
            _same_rule(tag, f"B={n} {name}", a16, a32, facts, 0)
        abs_err["fwd"] = max(abs_err["fwd"], _check_half_vs_plain(
            f"{tag} B={n}", (*series, "finals"), o16,
            fwd_ref(xs, ks, w0, w1, store_gates=False, res_dtype=bf16), errs))
        del o32
        dh = torch.from_numpy(np.random.RandomState(n).randn(n, h).astype(np.float32)).cuda()
        args16 = chain_args(o16, xs, ks, dh, w0, w1)
        d16 = chain(*args16)
        torch.cuda.synchronize()
        plan = lstm_kernel.chain_plan_on("lstm2_bwd_chain_remat", 4, h, n,
                                         torch.device("cuda"), layers=2, remat_d=d)
        launches = -(-n // (plan.batch_slice or n))
        if (fwd16.launches - before[0], chain16.launches - before[1]) != (1, launches):
            raise RuntimeError(f"{tag}: B={n}: the bf16 forms were not launched once "
                               f"(the chain once a slice, {launches})")
        d32 = chain(*(a.float() if torch.is_tensor(a) else a for a in args16))
        for name, a16, a32 in zip(("dg0", "dg1"), d16, d32):
            _same_rule(tag, f"B={n} {name}", a16, a32, facts, 0)
        abs_err["chain"] = max(abs_err["chain"], _check_half_vs_plain(
            f"{tag} B={n}", ("dg0", "dg1"), d16, chain_ref(*args16), errs))
        if plan.batch_slice:
            facts.append(f"B={n} the chain in {launches} launches of {plan.batch_slice} rows")
        del o16, d16, d32, args16
    del wide
    print(f"[{tag}] T={t} D={d} H={h}: bf16 forms vs float32 forms on the card: "
          f"{'; '.join(facts)}")
    print(f"[{tag}] vs the plain versions (bf16 outputs within one bf16 ulp + 1e-6 "
          "of the largest entry = 1, float32 within 1e-4 of the largest): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    # each form in one call beside its float32 form, row 12b and cuDNN
    dh = torch.from_numpy(np.random.RandomState(29).randn(b, h).astype(np.float32)).cuda()
    res16 = fwd(x_tm, keep, l0, l1, store_gates=False, res_dtype=bf16)
    args16 = chain_args(res16, x_tm, keep, dh, l0, l1)
    args32 = tuple(a.float() if torch.is_tensor(a) else a for a in args16)
    stored16 = fwd(x_tm, keep, l0, l1, res_dtype=bf16)
    args12b = (stored16[0], keep, dh, l0["w_hh"], l1["w_hh"], l1["w_ih"])
    lib = _cudnn_lstm(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()
    lib_params = list(lib.parameters())
    h_lib = lib(x_bt)[1][0][-1]
    times = {
        "fwd_bf16": device_ms(lambda: fwd(x_tm, keep, l0, l1, store_gates=False,
                                          res_dtype=bf16), flush),
        "fwd_f32": device_ms(lambda: fwd(x_tm, keep, l0, l1, store_gates=False), flush),
        "fwd_11b": device_ms(lambda: fwd(x_tm, keep, l0, l1, res_dtype=bf16), flush),
        "chain_bf16": device_ms(lambda: chain(*args16), flush),
        "chain_f32": device_ms(lambda: chain(*args32), flush),
        "chain_12b": device_ms(lambda: lstm_kernel.lstm2_bwd_chain(*args12b), flush),
        "fwd_plain": device_ms(lambda: fwd_ref(x_tm, keep, l0, l1, store_gates=False,
                                               res_dtype=bf16), flush, reps=3),
        "chain_plain": device_ms(lambda: chain_ref(*args16), flush, reps=3),
        "fwd_library": device_ms(lambda: lib(x_bt), flush),
        "chain_library": device_ms(
            lambda: torch.autograd.grad(h_lib, lib_params, dh, retain_graph=True), flush),
    }
    del res16, args16, args32, stored16, args12b
    kerns = []
    for part, name, source, core, line, beside in (
            ("fwd", "lstm2_train_fwd_nogates_bf16", "lstm2_train_fwd", "rnn2_fwd_chain.cuh",
             2326, "11b"),
            ("chain", "lstm2_bwd_chain_remat_bf16", "lstm2_bwd_chain_remat",
             "rnn2_bwd_chain.cuh", 2751, "12b")):
        flops, nbytes = _half_work(name.removesuffix("_bf16"), b, t, d, h)
        bound_ms, bound_by = bound(flops, nbytes)
        ms, f32_ms = times[f"{part}_bf16"], times[f"{part}_f32"]
        other = times["fwd_11b" if part == "fwd" else "chain_12b"]
        print(f"[{tag}] {name} {ms:.4f} ms, its float32 form {f32_ms:.4f} ms "
              f"({100 * (ms / f32_ms - 1):+.1f}%), row {beside} {other:.4f} ms, "
              f"{1e3 * ms / (t + 1):.3f} us per phase; plain {times[f'{part}_plain']:.4f} "
              f"ms, cuDNN {'training forward' if part == 'fwd' else 'backward of h_n'} at "
              f"keep=1 {times[f'{part}_library']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
        kerns.append({"name": name, "route": "cuda", "source": f"{CSRC}{source}.cu",
                      "core": CSRC + core,
                      "replaces": f"multimodal_emotion_detection_tpu/ops/lstm_kernel.py:{line}",
                      "max_abs_err": abs_err[part], "ms": ms,
                      "plain_ms": times[f"{part}_plain"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": times[f"{part}_library"],
                      "f32_ms": f32_ms})

    # the whole recurrence gradient: fused_lstm_final with both overrides
    # against autograd through the plain float32 forward, and its peak
    # memory beside the routes it stands between
    weight = torch.from_numpy(np.random.RandomState(30).randn(b, h).astype(np.float32)).cuda()

    def grads(remat, dtype, device="cuda"):
        dev = torch.device(device)
        xg = x_bt.detach().clone().to(dev).requires_grad_()
        p0, p1 = ({k: v.detach().clone().to(dev).requires_grad_() for k, v in p.items()}
                  for p in (l0, l1))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        out = lstm_vjp.fused_lstm_final(xg, keep[:, None].to(dev), (p0, p1),
                                        remat_gates=remat, res_dtype=dtype)
        (out * weight.to(dev)).sum().backward()
        peak = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        return (out.detach().cpu(),
                [g.grad.cpu() for g in (xg, *p0.values(), *p1.values())], peak)

    grads(True, "bfloat16")  # the first call's one-time allocations (cuBLAS's workspace)
    before = {k: c.launches for k, c in (("fwd", fwd16), ("chain", chain16))}
    h16, ours, peak16 = grads(True, "bfloat16")
    if (fwd16.launches - before["fwd"], chain16.launches - before["chain"]) != (1, 1):
        raise RuntimeError(f"{tag}: the whole gradient did not launch each bf16 form once")
    h32, ours32, peak32 = grads(True, "float32")
    _, _, peak_stored = grads(False, "bfloat16")
    _, plain, _ = grads(True, "bfloat16", "cpu")

    def dist(a, b):
        return max(float((g - r).abs().max()) / float(r.abs().max()) for g, r in zip(a, b))

    gap, engaged = dist(ours, plain), dist(ours, ours32)
    keep_bytes = keep.numel() * keep.element_size()
    figure = {k: lstm_vjp.stack_residual_bytes("lstm", 2, h, d, b, t, "pair", *k) - keep_bytes
              for k in ((True, "bfloat16"), (False, "bfloat16"), (True, "float32"))}
    print(f"[{tag}] whole recurrence gradient, remat + bf16 streams: forward value bit "
          f"for bit the float32 remat route's: {torch.equal(h16, h32)}; gradients vs "
          f"the CPU's (plain versions) {gap:.3e} of each largest entry (bound 2e-3), vs "
          f"the card's float32 remat route {engaged:.3e} (must exceed the first); peak {peak16 / 1e6:.2f} MB above the inputs (the budget's "
          f"figure {figure[(True, 'bfloat16')] / 1e6:.2f} MB, "
          f"{peak16 / figure[(True, 'bfloat16')]:.3f}x), the stored-gates bf16 route "
          f"{peak_stored / 1e6:.2f} MB (figure {figure[(False, 'bfloat16')] / 1e6:.2f}), "
          f"the float32 remat route {peak32 / 1e6:.2f} MB (figure "
          f"{figure[(True, 'float32')] / 1e6:.2f})")
    # the bias gradients' row sums over the (T B, 4H) float32 dgates: the
    # route's product with a ones row against torch's sum over the rows
    dgf = torch.randn(t * b, 4 * h, device="cuda")
    transient = {}
    for name, fn in (("sum(0)", lambda: dgf.sum(0)), ("row_sums", lambda: lstm_vjp._row_sums(dgf))):
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        transient[name] = torch.cuda.max_memory_allocated() - base
    print(f"[{tag}] a bias gradient's row sums over ({t * b}, {4 * h}) float32 dgates "
          f"({dgf.numel() * 4 / 1e6:.2f} MB): torch's sum(0) holds {transient['sum(0)'] / 1e6:.2f} "
          f"MB above its input, the route's product with a ones row "
          f"{transient['row_sums'] / 1e6:.2f} MB")
    del dgf
    if not torch.equal(h16, h32) or not gap < 2e-3 or not engaged > gap:
        raise RuntimeError(f"{tag}: the whole gradient disagrees with the plain version")
    # the route keeps the least of the three, as its figure says, and its
    # figure (the long-sequence budget check's) under-counts by at most 15%
    if not (peak16 < peak_stored and peak16 < peak32
            and figure[(True, "bfloat16")] < min(figure[(False, "bfloat16")],
                                                 figure[(True, "float32")])
            and peak16 <= 1.15 * figure[(True, "bfloat16")]):
        raise RuntimeError(f"{tag}: the peak memory does not order as the budget's figures")
    return kerns


def _write_split(root: Path, split: str, n: int, seed: int) -> None:
    d = root / split
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    np.save(d / "audio.npy", rng.randn(n, 48000, 1).astype(np.float32))
    np.save(d / "video.npy", rng.rand(n, 24, 4096).astype(np.float32))
    np.save(d / "labels.npy", rng.randint(0, 8, n).astype(np.int32))


TRAIN_ARTIFACTS = ("results.json", "best.ckpt", "checkpoints/last.ckpt",
                   "confusion_matrix.npy", "csv_logs/version_0/metrics.csv")


# each phase_train path's train step: p50 (ms), device busy share, peak
# allocated (GB)
STEPS = {}
# each serve_path path's forward p50 (ms) at b32 and b1
SERVES = {}
# each phase_train path's config file and overrides, for [flops]
TRAINED = {}


def phase_train(counters, tag: str, model_overrides, expected_fn,
                check_clips: int = 0, reps: int = 60, profile_reps: int = 10,
                config: str = "base.yaml", artifacts=TRAIN_ARTIFACTS,
                kinked: bool = False, grad_bound: float = 1e-4,
                contrast_f32: bool = False, half_encoders: bool = False,
                contrast_stored: bool = False):
    """The train CLI with ``configs/<config>`` for 2 epochs on synthetic 96
    / 64 / 64 clip splits at batch 32, from the work directory (relative
    outputs land there), with the launch counts checked
    (``expected_fn(steps, eval_batches)``) and ``artifacts`` (paths in the
    run directory) written; one card step against the CPU step (on the
    first ``check_clips`` clips of the batch, where given, on both sides;
    ``kinked``: ``kinked_step_check`` instead), its gradients to
    ``grad_bound`` of the largest, and with ``contrast_f32`` (bf16 residual
    streams) the card step with float32 streams on the same batch and masks
    differing from it by more than three times that card-vs-CPU gap (the
    rounding engaged), with ``contrast_stored`` (the remat pair) the card
    step with the gates stored on the same batch and masks further from it
    than that gap (the recompute engaged), and with ``half_encoders`` (bf16 encoders)
    ``half_step_check`` instead of the float32 bound; the train step's
    latency over ``reps`` steps and its profile over ``profile_reps``.  Returns ``(launches, run directory,
    overrides)``."""
    import contextlib
    import csv

    from multimodal_emotion_detection_tpu_torch import train
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.data.loader import (
        create_dataloaders,
    )
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )

    sizes = TRAIN_SPLITS
    data = WORK / "train_data"
    if not (data / "test" / "labels.npy").exists():
        for seed, (split, n) in enumerate(sizes.items()):
            _write_split(data, split, n, 10 + seed)
    config_path = str(ROOT / "configs" / config)
    overrides = [*model_overrides, "training.max_epochs=2",
                 f"dataset.data_dir={data}", f"experiment.save_dir={WORK}",
                 f"experiment.name={tag}_run"]
    cfg = load_config(config_path, overrides)
    TRAINED[tag] = (config_path, overrides)
    bsz = cfg.dataset.batch_size
    steps = 2 * sizes["train"] // bsz
    # validation every val_every_n_epochs epochs and at the last
    every = max(1, int(cfg.training.val_every_n_epochs))
    validations = sum(1 for e in range(2) if (e + 1) % every == 0 or e == 1)
    evals = validations * sizes["val"] // bsz + sizes["test"] // bsz
    with contextlib.chdir(WORK):
        results, train_s, launches = run_counted(
            counters, expected_fn(steps, evals), tag,
            lambda: train.main(["--config", config_path, *overrides]))
    print(f"[{tag}] train.main, 2 epochs of {sizes['train']} clips at batch "
          f"{bsz} ({steps} steps, {evals} eval batches): {train_s:.3f} s wall "
          f"(first call: data load and set-up included); launches {launches}")
    run_dir = WORK / f"{tag}_run"
    for rel in artifacts:
        if not (run_dir / rel).exists():
            raise RuntimeError(f"train.main did not write {rel}")
    if not all(np.isfinite(v) for v in results.values()):
        raise RuntimeError(f"non-finite results: {results}")
    with open(run_dir / "csv_logs/version_0/metrics.csv") as f:
        rows = [r for r in csv.DictReader(f) if r.get("train/clips_per_sec")]
    print(f"[{tag}] results {json.dumps(results)}; the Trainer's own "
          "train/clips_per_sec (host clock around each epoch, card synchronised): "
          + ", ".join(f"epoch {r['epoch']} {float(r['train/clips_per_sec']):.2f}"
                      for r in rows))

    step_kw = dict(lr=cfg.training.learning_rate,
                   clip_norm=cfg.training.gradient_clip_norm,
                   modality_dropout=cfg.training.augmentation.modality_dropout)
    if kinked:
        kinked_step_check(tag, cfg, step_kw)

    # one train step on the card against the same step on the CPU (plain
    # versions), same weights, batch and masks
    dev = torch.device("cuda")
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(0))
    train_loader = create_dataloaders(
        cfg.dataset.name, cfg.dataset.data_dir, cfg.dataset.modalities,
        batch_size=bsz, seed=cfg.seed, device=dev)[0]
    if cfg.model.frontend.cache:
        _cache_logmel(cfg, train_loader)
    if half_encoders:
        half_step_check(tag, cfg, model, train_loader, check_clips or bsz, step_kw)
    elif not kinked:
        rows = check_clips or bsz
        if check_clips:
            print(f"[{tag}] the card step against the CPU step on the first {rows} "
                  f"clips of the batch: the CPU's plain versions would hold the b{bsz} "
                  "residuals in host memory; the kernels' b32 addressing is held by "
                  "their own raw-length phases")
        sides = _step_sides(cfg, model, train_loader, rows, step_kw)
        gap = _step_check(tag, cfg, sides["card"], sides["cpu"], rows, grad_bound)
        if contrast_f32:
            _contrast_f32(tag, cfg, model, train_loader, rows, step_kw, sides, gap)
        if contrast_stored:
            _contrast_stored(tag, cfg, model, train_loader, rows, step_kw, sides, gap)

    _step_latency(tag, cfg, model, train_loader, step_kw, reps, profile_reps)
    return launches, run_dir, overrides


def _cache_logmel(cfg, loader) -> None:
    """As the Trainer caches it: the split's log-mel features, once, by
    the kernel."""
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        logmel_params_from_config,
    )
    from multimodal_emotion_detection_tpu_torch.ops import logmel

    raw = torch.from_numpy(loader.arrays.features["audio"]).cuda()
    with torch.inference_mode():
        feats = logmel.logmel_cuda(raw, logmel_params_from_config(cfg.model.frontend))
    loader.replace_features("audio", feats.cpu().numpy())


def _contrast_f32(tag: str, cfg, model, loader, rows: int, step_kw, sides,
                  gap: float) -> None:
    """The card step of ``model`` with float32 residual streams on the
    same batch and masks as ``sides``' card step (bf16 streams): their
    gradients must differ by more than three times ``gap``, the card-vs-CPU
    gradient error (of the largest gradient), or the rounding did not
    engage."""
    import copy

    from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN

    model32 = copy.deepcopy(model)
    for module in model32.modules():
        if isinstance(module, FusedStackedRNN):
            module.residual_dtype = torch.float32
    card32 = _step_sides(cfg, model32, loader, rows, step_kw, with_cpu=False)["card"]
    card, cpu = sides["card"], sides["cpu"]
    g_max = max(float(g.abs().max()) for g in cpu["grads"].values())
    diff = {k: float((card["grads"][k] - g).abs().max()) / g_max
            for k, g in card32["grads"].items()}
    worst = max(diff, key=diff.get)
    print(f"[{tag}] the card step with float32 residual streams on the same batch and "
          f"masks: loss {card32['loss']:.6f} vs {card['loss']:.6f}; gradients differ by "
          f"{diff[worst]:.3e} of the largest ({worst}), {diff[worst] / gap:.1f}x the "
          f"card-vs-CPU gap {gap:.3e} (must exceed 3x: the bf16 rounding engaged)")
    if not diff[worst] > 3 * gap:
        raise RuntimeError(f"{tag}: the bf16 step is not told apart from the float32 one")


def _contrast_stored(tag: str, cfg, model, loader, rows: int, step_kw, sides,
                     gap: float) -> None:
    """The card step of ``model`` with the gates stored (the pair route
    without ``remat_gates``, as ``[train_fast]`` steps) on the same batch
    and masks as ``sides``' card step (the remat route): the stored route's
    bf16 gates against the recomputed float32 ones move the gradients by
    more than ``gap``, the card-vs-CPU gradient error, or the recompute did
    not engage."""
    import copy

    from multimodal_emotion_detection_tpu_torch.models.recurrent import FusedStackedRNN

    stored = copy.deepcopy(model)
    for module in stored.modules():
        if isinstance(module, FusedStackedRNN):
            module.remat_gates = False
    card_s = _step_sides(cfg, stored, loader, rows, step_kw, with_cpu=False)["card"]
    card, cpu = sides["card"], sides["cpu"]
    g_max = max(float(g.abs().max()) for g in cpu["grads"].values())
    diff = {k: float((card["grads"][k] - g).abs().max()) / g_max
            for k, g in card_s["grads"].items()}
    worst = max(diff, key=diff.get)
    print(f"[{tag}] the card step with the gates stored ([train_fast]'s route) on the "
          f"same batch and masks: loss {card_s['loss']:.6f} vs {card['loss']:.6f}; "
          f"gradients differ by {diff[worst]:.3e} of the largest ({worst}), "
          f"{diff[worst] / gap:.1f}x the card-vs-CPU gap {gap:.3e} (must exceed 1x: the "
          "recompute engaged)")
    if not diff[worst] > gap:
        raise RuntimeError(f"{tag}: the remat step is not told apart from the stored one")


def _step_sides(cfg, model, loader, rows: int, step_kw, f64: bool = False,
                with_cpu: bool = True, streamed: bool = False, reference=None):
    """One ``train_step`` of a copy of ``model`` on the first ``rows`` clips
    of ``loader``'s first batch: on the card, then on the CPU with the
    card's masks replayed (plain versions), and with ``f64`` on the CPU in
    float64 too (``cpu64``); without ``with_cpu`` the card's alone; with
    ``streamed`` the card takes the batch as ``loader.stream`` copies it and
    gathers it by the identity, as the host-streaming trainer does; with
    ``reference`` (a model of the same tree) that model's step on the CPU
    with the card's masks too (``cpu_ref``).  Returns
    ``{side: {noise, loss, grads, params, buffers}}``, every tensor on the
    CPU."""
    import copy

    from multimodal_emotion_detection_tpu_torch.models.noise import Noise
    from multimodal_emotion_detection_tpu_torch.training.optim import (
        build_optimizer,
    )
    from multimodal_emotion_detection_tpu_torch.training.steps import train_step

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    idx = torch.from_numpy(loader.epoch_batch_indices(0)[0].astype(np.int64))
    valid = torch.from_numpy(loader.epoch_batch_valid()[0])
    if streamed:
        feats, labels = next(loader.stream(0))
        idx = torch.arange(idx.shape[0])
    else:
        feats, labels = loader.device_arrays()
    plan = [("card", dev, torch.float32, model)] + (
        [("cpu", cpu, torch.float32, model)] if with_cpu else [])
    if f64:
        plan.append(("cpu64", cpu, torch.float64, model))
    if reference is not None:
        plan.append(("cpu_ref", cpu, torch.float32, reference))
    sides = {}
    for side, device, dtype, source in plan:
        m = copy.deepcopy(source).to(device, dtype)
        opt, _ = build_optimizer(cfg.training, m.parameters(), len(loader))
        if side == "card":
            noise = Noise(torch.Generator(device=dev).manual_seed(0))
            f, lab, i = feats, labels, idx[:rows].to(dev)
        else:
            noise = Noise(replay=sides["card"]["noise"].drawn)
            f = {k: v[idx[:rows].to(dev)].to(cpu, dtype) for k, v in feats.items()}
            lab, i = labels[idx[:rows].to(dev)].cpu(), torch.arange(rows)
        metrics = train_step(m, opt, f, lab, i, valid[:rows].to(device), noise=noise,
                             **step_kw)
        sides[side] = {"noise": noise, "loss": float(metrics["loss"]),
                       "grads": {k: p.grad.detach().cpu() for k, p in m.named_parameters()},
                       "params": {k: p.detach().cpu() for k, p in m.named_parameters()},
                       "buffers": {k: b.detach().cpu() for k, b in m.named_buffers()}}
    return sides


def kinked_step_check(tag: str, cfg, step_kw) -> None:
    """The card step of a model whose gradient jumps at ReLU kinks that
    every (clip, step) element reaches (audio_only.yaml's CNN and its MLP
    form: ReLU after BatchNorm over (B, T, C)), held to the exact step.

    There a float32 gradient is not a continuous function of its inputs at
    round-off scale: a perturbation of 1e-7 of the log-mel's spread moves
    the float64 gradient by ~2e-5 of its largest entry, the log-mel
    kernel's FFT (within ~3e-5 of the plain DFT, its own phase) by ~2e-4,
    so two float32 steps on different inputs or in different summation
    orders disagree past the 1e-4 the smooth models are held to.  So both
    sides take the same log-mel features (the kernel's, computed once as
    ``frontend.cache`` does), and the card step and the CPU's float32 step
    are each held to the CPU's float64 step (plain versions, the card's
    masks replayed): the loss to 1e-4, the running statistics to 1e-5 of
    each buffer's largest entry, the gradients to 1e-4 of the largest, or
    to 4x the CPU float32 step's own distance where that is larger, and
    the updated parameters to 1e-5 where |g| is 10x past the card's
    gradient error (Adam's step is lr * sign there), 2.2 lr anywhere."""
    import copy

    from multimodal_emotion_detection_tpu_torch.data.loader import (
        create_dataloaders,
    )
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )

    cfg = copy.deepcopy(cfg)
    cfg.model.frontend.cache = True
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(0))
    loader = create_dataloaders(
        cfg.dataset.name, cfg.dataset.data_dir, cfg.dataset.modalities,
        batch_size=cfg.dataset.batch_size, seed=cfg.seed, device=torch.device("cuda"))[0]
    _cache_logmel(cfg, loader)
    rows = cfg.dataset.batch_size
    sides = _step_sides(cfg, model, loader, rows, step_kw, f64=True)
    exact = sides["cpu64"]
    g_max = max(float(g.abs().max()) for g in exact["grads"].values())

    def grad_errs(side):
        errs = {k: float((sides[side]["grads"][k].double() - g).abs().max())
                for k, g in exact["grads"].items()}
        worst = max(errs, key=errs.get)
        return errs[worst], worst

    card_abs, card_worst = grad_errs("card")
    cpu_abs, cpu_worst = grad_errs("cpu")
    pair = max(float((sides["card"]["grads"][k] - g).abs().max())
               for k, g in sides["cpu"]["grads"].items())
    grad_bound = max(1e-4, 4 * cpu_abs / g_max)
    loss_err = abs(sides["card"]["loss"] - exact["loss"])
    lr = cfg.training.learning_rate
    floor = max(1e-6, 10 * card_abs)
    param_err = max(float(((sides["card"]["params"][k].double() - p).abs()
                           * (exact["grads"][k].abs() > floor)).max())
                    for k, p in exact["params"].items())
    param_any = max(float((sides["card"]["params"][k].double() - p).abs().max())
                    for k, p in exact["params"].items())
    buf_err = {k: float((sides["card"]["buffers"][k].double() - b).abs().max())
               / float(b.abs().max()) for k, b in exact["buffers"].items()}
    buf_cpu = max(float((sides["cpu"]["buffers"][k].double() - b).abs().max())
                  / float(b.abs().max()) for k, b in exact["buffers"].items())
    worst_buf = max(buf_err, key=buf_err.get)
    print(f"[{tag}] one step on the same {rows} clips' log-mel features and masks, "
          f"against the CPU's float64 step: loss card {sides['card']['loss']:.6f}, "
          f"float64 {exact['loss']:.6f}, abs err {loss_err:.3e} (bound 1e-4); gradients "
          f"max abs err card {card_abs / g_max:.3e} ({card_worst}), CPU float32 "
          f"{cpu_abs / g_max:.3e} ({cpu_worst}), card vs CPU float32 {pair / g_max:.3e}, "
          f"of the largest gradient {g_max:.3e} (bound for the card {grad_bound:.3e}); "
          f"updated parameters max abs err {param_err:.3e} where |g| > {floor:.1e} "
          f"(bound 1e-5), {param_any:.3e} anywhere (bound 2.2 lr = {2.2 * lr:.1e}); "
          f"running statistics card {buf_err[worst_buf]:.3e} of the buffer's largest "
          f"entry ({worst_buf}), CPU float32 {buf_cpu:.3e} (bound 1e-5)")
    if not (loss_err < 1e-4 and card_abs / g_max <= grad_bound and param_err < 1e-5
            and param_any < 2.2 * lr and buf_err[worst_buf] <= 1e-5):
        raise RuntimeError("the card's train step disagrees with the exact step")


# the bf16-encoder step rule: the card's gradient distance from the CPU's
# float32 step at most max(HALF_GRAD_FLOOR, 2 x the CPU bf16 step's), of
# the largest gradient; the card's loss within HALF_LOSS_BOUND of the CPU
# bf16 step's (under one bf16 ulp of a loss of ~2, 2^-6)
HALF_GRAD_FLOOR = 2e-2
HALF_LOSS_BOUND = 1e-2


def half_step_check(tag: str, cfg, model, loader, rows: int, step_kw) -> None:
    """The card step of ``model`` (bf16 encoders) held to the CPU's float32
    step, not to the CPU bf16 step: bf16 rounds float32 values that cuBLAS
    and the CPU sum in other orders to other ulps, so the two bf16 steps
    cannot agree to the float32 steps' 1e-4.  The CPU's bf16 step (plain
    versions) and its float32 step (the same weights with every encoder's
    compute dtype float32) take the card's batch and masks; the card's
    gradient distance from the float32 step must be within
    max(HALF_GRAD_FLOOR, 2 x the CPU bf16 step's distance) of the largest
    gradient, and its loss within HALF_LOSS_BOUND of the CPU bf16 step's.
    The CPU bf16 step must differ from the float32 one (the rounding
    engaged)."""
    import copy

    reference = copy.deepcopy(model)
    for module in reference.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.float32
    sides = _step_sides(cfg, model, loader, rows, step_kw, reference=reference)
    ref = sides["cpu_ref"]
    g_max = max(float(g.abs().max()) for g in ref["grads"].values())

    def dist(side):
        errs = {k: float((sides[side]["grads"][k] - g).abs().max()) / g_max
                for k, g in ref["grads"].items()}
        worst = max(errs, key=errs.get)
        return errs[worst], worst

    (card_d, card_w), (cpu_d, cpu_w) = dist("card"), dist("cpu")
    pair = max(float((sides["card"]["grads"][k] - g).abs().max())
               for k, g in sides["cpu"]["grads"].items()) / g_max
    bound_d = max(HALF_GRAD_FLOOR, 2 * cpu_d)
    loss_err = abs(sides["card"]["loss"] - sides["cpu"]["loss"])
    print(f"[{tag}] one step, card (bf16 encoders) and CPU bf16 (plain versions) each "
          f"against the CPU float32 step on the same weights, {rows} clips and masks: "
          f"loss card {sides['card']['loss']:.6f}, CPU bf16 {sides['cpu']['loss']:.6f}, "
          f"CPU float32 {ref['loss']:.6f}; card vs CPU bf16 {loss_err:.3e} (bound "
          f"{HALF_LOSS_BOUND:.0e}); gradient distance from float32, of the largest "
          f"gradient {g_max:.3e}: card {card_d:.3e} ({card_w}), CPU bf16 {cpu_d:.3e} "
          f"({cpu_w}) (card bound max({HALF_GRAD_FLOOR:.0e}, 2 x CPU) = {bound_d:.3e}); "
          f"card vs CPU bf16 {pair:.3e}")
    if not (card_d <= bound_d and loss_err <= HALF_LOSS_BOUND and cpu_d > 0.0):
        raise RuntimeError(f"{tag}: the card's bf16 step fails the bf16 step rule")


def _step_check(tag: str, cfg, card, cpu, rows: int, grad_bound: float = 1e-4) -> float:
    """The card step's loss, gradients (to ``grad_bound`` of the largest),
    updated parameters and running statistics against the CPU step's;
    returns the gradients' error, of the largest gradient."""
    loss_err = abs(card["loss"] - cpu["loss"])
    # relative to the largest gradient entry: a tensor whose true gradient
    # is zero (the attention pool's score bias, which softmax over time does
    # not see) holds only round-off, against which no relative error means
    # anything
    grad_abs = {k: float((card["grads"][k] - g).abs().max())
                for k, g in cpu["grads"].items()}
    g_max = max(float(g.abs().max()) for g in cpu["grads"].values())
    worst = max(grad_abs, key=grad_abs.get)
    grad_err = grad_abs[worst] / g_max
    # how much of the difference is one factor on every gradient (the
    # global-norm clip's), and what is left after it
    dot = sum(float((card["grads"][k] * g).sum()) for k, g in cpu["grads"].items())
    sq = sum(float((g * g).sum()) for g in cpu["grads"].values())
    fit = dot / sq
    residual = max(float((card["grads"][k] - fit * g).abs().max())
                   for k, g in cpu["grads"].items()) / g_max
    # an Adam step is lr * g / (|g| + eps): where |g| nears eps it turns
    # round-off into a step of up to lr, so only well-conditioned elements
    # are held to the bound
    lr = cfg.training.learning_rate
    param_err = max(float(((card["params"][k] - p).abs()
                           * (cpu["grads"][k].abs() > 1e-6)).max())
                    for k, p in cpu["params"].items())
    param_any = max(float((card["params"][k] - p).abs().max())
                    for k, p in cpu["params"].items())
    print(f"[{tag}] one step on the card vs the CPU (plain versions, same "
          f"{rows} clips and masks): loss {card['loss']:.6f} vs {cpu['loss']:.6f}, abs err "
          f"{loss_err:.3e} (bound 1e-4); gradients max abs err {grad_abs[worst]:.3e} "
          f"({worst}) = {grad_err:.3e} of the largest gradient {g_max:.3e} "
          f"(bound {grad_bound:.0e}; card = {fit:.7f} x CPU fits them to {residual:.3e} of "
          f"the largest); updated parameters max "
          f"abs err {param_err:.3e} where |g| > 1e-6 (bound 1e-5), {param_any:.3e} "
          f"anywhere (bound 2.2 lr = {2.2 * lr:.1e})")
    # BatchNorm's running statistics, moved by the step's forward: each
    # buffer to 1e-5 of its largest entry
    buf_err = {k: float((card["buffers"][k] - b).abs().max()) / float(b.abs().max())
               for k, b in cpu["buffers"].items()}
    if buf_err:
        worst_buf = max(buf_err, key=buf_err.get)
        print(f"[{tag}] running statistics after the step, card vs CPU: max abs err "
              f"{buf_err[worst_buf]:.3e} of the buffer's largest entry ({worst_buf}; "
              f"{len(buf_err)} buffers, bound 1e-5)")
    if not (loss_err < 1e-4 and grad_err < grad_bound and param_err < 1e-5
            and param_any < 2.2 * lr and max(buf_err.values(), default=0.0) <= 1e-5):
        raise RuntimeError("the card's train step disagrees with the CPU's")
    return grad_err


B256_SPLITS = {"train": 256, "val": 32, "test": 32}


def phase_steps_b256(counters, tag: str, model_overrides, per_step, steps: int = 3,
                     check_clips: int = 4):
    """The JAX bench legs' b256 train step (``dataset.batch_size=256``) in
    bf16 compute on synthetic 256-clip splits: ``half_step_check`` on the
    first ``check_clips`` clips of the batch (both sides), then ``steps``
    timed steps on the card (host clock around each step and synchronize,
    one untimed step first) with their launches counted (``per_step(steps)``,
    exactly), and the same steps of the float32 model on the same weights in
    the same call (not counted).  Returns the counted launches."""
    import copy

    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.data.loader import create_dataloaders
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise
    from multimodal_emotion_detection_tpu_torch.training.optim import build_optimizer
    from multimodal_emotion_detection_tpu_torch.training.steps import train_step

    data = WORK / "train_data_b256"
    if not (data / "test" / "labels.npy").exists():
        for seed, (split, n) in enumerate(B256_SPLITS.items()):
            _write_split(data, split, n, 30 + seed)
    cfg = load_config(str(ROOT / "configs" / "base.yaml"),
                      [*model_overrides, "dataset.batch_size=256", f"dataset.data_dir={data}"])
    dev = torch.device("cuda")
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(0))
    loader = create_dataloaders(cfg.dataset.name, cfg.dataset.data_dir,
                                cfg.dataset.modalities, batch_size=256, seed=cfg.seed,
                                device=dev)[0]
    if cfg.model.frontend.cache:
        _cache_logmel(cfg, loader)
    step_kw = dict(lr=cfg.training.learning_rate, clip_norm=cfg.training.gradient_clip_norm,
                   modality_dropout=cfg.training.augmentation.modality_dropout)
    print(f"[{tag}] the card step against the CPU steps on the first {check_clips} clips "
          "of the batch (the CPU's plain versions would hold the b256 residuals in host "
          "memory); the timed steps run the whole batch of 256")
    half_step_check(tag, cfg, model, loader, check_clips, step_kw)

    feats, labels = loader.device_arrays()
    idx = torch.from_numpy(loader.epoch_batch_indices(0)[0].astype(np.int64)).to(dev)
    valid = torch.from_numpy(loader.epoch_batch_valid()[0]).to(dev)
    model32 = copy.deepcopy(model)
    for module in model32.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.float32
    p50s = {}
    launches = None
    for label, m in (("bf16", model), ("float32", model32)):
        m = m.to(dev)
        opt, _ = build_optimizer(cfg.training, m.parameters(), len(loader))
        gen = torch.Generator(device=dev)

        def one_step(s):
            gen.manual_seed(s)
            train_step(m, opt, feats, labels, idx, valid, noise=Noise(gen), **step_kw)

        one_step(0)
        torch.cuda.synchronize()
        times = []

        def timed_steps():
            for s in range(1, steps + 1):
                t0 = time.perf_counter()
                one_step(s)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))

        if label == "bf16":
            _, _, launches = run_counted(counters, per_step(steps), tag, timed_steps)
        else:
            timed_steps()
        p50s[label] = statistics.median(times)
        print(f"[{tag}] {label} compute: {steps} train steps at batch 256 (host clock "
              f"around each step and synchronize): " + ", ".join(f"{t:.4f}" for t in times)
              + f" ms; p50 {p50s[label]:.4f} ms = {256e3 / p50s[label]:.1f} clips/s")
    print(f"[{tag}] train step p50 at b256: bf16 compute {p50s['bf16']:.4f} ms, float32 "
          f"{p50s['float32']:.4f} ms in the same call ({p50s['float32'] / p50s['bf16']:.3f}x)"
          f"; launches {launches}")
    STEPS[tag] = (p50s["bf16"], None, torch.cuda.max_memory_allocated() / 1e9)
    return launches


def phase_lstm2_train_fwd_b320(lstm_kernel, flush, kern) -> None:
    """Row 11 at the MC-dropout fold's 320 rows (10 samples x batch 32):
    against its plain version, to 1e-4 of the largest entry, with its
    launch plan; its error and time go into the kernel's entry as
    ``b320_*``."""
    x_tm, keep, l0, l1 = _lstm_train_inputs(6, b=320)
    t, b, d = x_tm.shape
    h = l0["w_hh"].shape[0]
    refs = lstm_kernel.lstm2_train_fwd_reference(x_tm, keep, l0, l1)
    outs = lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1)
    torch.cuda.synchronize()
    errs = {}
    for name, out, ref in zip(("packed", "h0_prev", "h1_prev", "x1", "finals"),
                              outs, refs):
        errs[name] = max_errs(out, ref)[0] / float(ref.abs().max())
    del outs, refs
    print(f"[lstm2_train_fwd] B={b} T={t} D={d} H={h} (the MC-dropout fold): max abs "
          "err / largest entry " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (bound 1e-4)")
    print(f"[lstm2_train_fwd] "
          f"{_chain_plan_text(lstm_kernel, 'lstm2_train_fwd', 4, h, b, True, 2)}")
    if max(errs.values()) > 1e-4:
        raise RuntimeError("lstm2_train_fwd disagrees with its plain version at B=320")
    ms = device_ms(lambda: lstm_kernel.lstm2_train_fwd_residuals(x_tm, keep, l0, l1),
                   flush, reps=5)
    flops, nbytes = _work("lstm2_train_fwd", b, t, d, h)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[lstm2_train_fwd] B={b}: kernel {ms:.4f} ms ({1e3 * ms / (t + 1):.3f} us "
          f"per phase), bound {bound_ms:.4f} ms ({bound_by})")
    lib = _cudnn_lstm(l0, l1)
    x_bt = x_tm.transpose(0, 1).contiguous()
    library_ms = device_ms(lambda: lib(x_bt), flush, reps=5)
    print(f"[lstm2_train_fwd] B={b}: cuDNN nn.LSTM({d}, {h}, num_layers=2) training "
          f"forward at keep=1 {library_ms:.4f} ms")
    kern.update({"b320_max_err_of_largest": max(errs.values()), "b320_ms": ms,
                 "b320_bound_ms": bound_ms, "b320_library_ms": library_ms})
    del lib, x_bt
    del x_tm, keep, l0, l1
    torch.cuda.empty_cache()


def phase_mc_dropout(counters, tag: str, ckpt: Path, overrides, samples: int,
                     audio: np.ndarray, video: np.ndarray, out_dir: Path,
                     config: str, reps: int = 20, profile_reps: int = 5,
                     expected_per_batch=None):
    """The predict CLI with ``--mc-dropout samples`` on ``ckpt`` over the
    test split at batch 32, the launch counts checked
    (``expected_per_batch``, by default one log-mel (the frontend runs
    inside the fold, on all S·B rows) and one training forward (row 11) per
    batch, no eval form); ``uncertainty.npy`` finite, >= 0 and not all 0.
    Then the first batch again on the card with the CLI's seed, which must
    give the CLI's numbers, and on the CPU with the card's masks replayed
    (plain versions): mean logits 1e-3, uncertainty 1e-4 absolute.  The MC
    forward's latency at b32 and its profile.  A model with BatchNorm keeps
    its running statistics bit for bit through every MC forward."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise
    from multimodal_emotion_detection_tpu_torch.tools import predict
    from multimodal_emotion_detection_tpu_torch.tools._restore import (
        restore_for_eval,
    )
    from multimodal_emotion_detection_tpu_torch.uncertainty.mc_dropout import (
        mc_dropout_predict,
    )

    config_path = str(ROOT / "configs" / config)
    n, batches = audio.shape[0], audio.shape[0] // 32
    per_batch = expected_per_batch or {"logmel": 1, "lstm2_train_fwd": 1}
    metrics, predict_s, launches = run_counted(
        counters, {k: v * batches for k, v in per_batch.items()}, tag,
        lambda: predict.main([
            "--checkpoint", str(ckpt), "--config", config_path, "--split", "test",
            "--mc-dropout", str(samples), "--out", str(out_dir), *overrides]))
    print(f"[{tag}] predict --mc-dropout {samples} over {n} clips at batch 32 "
          f"({samples * 32} rows a forward): {predict_s:.3f} s wall (first call, data "
          f"load included); launches {launches}")
    logits = np.load(out_dir / "logits.npy")
    unc = np.load(out_dir / "uncertainty.npy")
    if logits.shape != (n, 8) or not np.isfinite(logits).all():
        raise RuntimeError(f"bad MC logits: shape {logits.shape}")
    if unc.shape != (n,) or not np.isfinite(unc).all() or unc.min() < 0 or unc.max() <= 0:
        raise RuntimeError(f"bad uncertainty.npy: shape {unc.shape}, "
                           f"range [{unc.min()}, {unc.max()}]")
    print(f"[{tag}] uncertainty over {n} clips: min {unc.min():.4e}, median "
          f"{np.median(unc):.4e}, max {unc.max():.4e}; metrics {json.dumps(metrics)}")

    cfg = load_config(config_path, overrides)
    cfg.model.frontend.cache = False  # as predict: raw features in
    dev = torch.device("cuda")
    model, _, _ = restore_for_eval(cfg, ckpt, "test", dev)
    stats = {k: b.clone() for k, b in model.named_buffers()}
    clips = {m: {"audio": audio, "video": video}[m] for m in cfg.dataset.modalities}
    b32 = {m: torch.from_numpy(a[:32]).to(dev) for m, a in clips.items()}
    noise = Noise(torch.Generator(device=dev).manual_seed(cfg.seed))
    mean, u = mc_dropout_predict(model, b32, samples, noise=noise)
    again = max(float(np.abs(mean.cpu().numpy() - logits[:32]).max()),
                float(np.abs(u.cpu().numpy() - unc[:32]).max()))
    cpu_model, _, _ = restore_for_eval(cfg, ckpt, "test", torch.device("cpu"))
    cpu_mean, cpu_u = mc_dropout_predict(
        cpu_model, {k: v.cpu() for k, v in b32.items()}, samples,
        noise=Noise(replay=[m.cpu() for m in noise.drawn]))
    mean_err = float((mean.cpu() - cpu_mean).abs().max())
    unc_err = float((u.cpu() - cpu_u).abs().max())
    print(f"[{tag}] the first batch's 32 clips ({samples * 32} rows) again on the card "
          f"with the CLI's seed: max abs diff from the CLI {again:.3e} (bound 1e-6); on "
          f"the CPU with the card's {len(noise.drawn)} masks replayed: mean logits max "
          f"abs err {mean_err:.3e} (bound 1e-3), uncertainty {unc_err:.3e} (bound "
          f"1e-4; largest {float(cpu_u.max()):.3e})")
    if again > 1e-6 or mean_err > 1e-3 or unc_err > 1e-4:
        raise RuntimeError("MC dropout on the card disagrees with the CPU")

    gen = torch.Generator(device=dev)

    def mc():
        gen.manual_seed(cfg.seed)
        mc_dropout_predict(model, b32, samples, noise=Noise(gen))

    p50, p90 = host_ms(mc, reps=reps)
    print(f"[{tag}] MC forward latency b32 x {samples} samples (host clock around "
          f"synchronize, {reps} requests, inputs on the card): p50 {p50:.4f} ms, p90 "
          f"{p90:.4f} ms")
    profile_forward(f"{tag} b32", mc, reps=profile_reps, what="MC forward")
    if stats:
        moved = [k for k, b in model.named_buffers() if not torch.equal(b, stats[k])]
        print(f"[{tag}] BatchNorm running statistics after {reps + profile_reps + 7} MC "
              f"forwards on the card: {len(stats) - len(moved)} of {len(stats)} buffers "
              "bit for bit unchanged")
        if moved:
            raise RuntimeError(f"MC dropout moved the running statistics: {moved}")
    return launches


def profile_forward(label: str, fn, reps: int = 20, what: str = "forward"):
    """Where a forward's (or train step's) time goes: device time by kernel
    over ``reps`` back-to-back calls under torch.profiler, and the device's
    busy share of the host-clock window they took, which it returns (None
    where the profiler saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        # a user annotation (e.g. "Optimizer.step#AdamW.step") spans the
        # kernels inside it on the device track: counting it would count
        # them twice
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if not busy_us:
        print(f"[profile] {label}: device time not measured (the profiler "
              "recorded no device activity)")
        return None
    print(f"[profile] {label}: {reps} {what}s in {window_us / 1e3:.4f} ms "
          f"(host clock, profiler on); device busy {busy_us / 1e3:.4f} ms = "
          f"{100 * busy_us / window_us:.1f}% of it, idle "
          f"{100 * (1 - busy_us / window_us):.1f}%")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile] {label}:   {us / reps:9.2f} us/{what} "
              f"{100 * us / busy_us:5.1f}%  {name[:90]}")
    return busy_us / window_us


# ---------------------------------------------------------------------------
# synthetic data, the host-streaming loader, the epoch trace, the debug
# probes and the streaming monitor
# ---------------------------------------------------------------------------

SYNTH_ENC = ("{type: sequence, encoder_type: lstm, input_dim: 32, hidden_dim: 256, "
             "num_layers: 2, output_dim: 128}")
# the reference's synthetic fixture (three sensors of 32 features over 100
# steps, 5 classes) at the flagship's recurrent width: each sensor through
# an LSTM 2x256 -> Dense 128, the concat head 256; 96 train rows, val and
# test num_samples_eval // 5 = 64 rows each
SYNTHETIC = ["dataset.name=synthetic", "dataset.modalities=[sensor1,sensor2,sensor3]",
             "dataset.num_samples=96", "dataset.num_samples_eval=320",
             "dataset.num_classes=5",
             "model.encoders={" + ", ".join(f"sensor{i}: {SYNTH_ENC}" for i in (1, 2, 3))
             + "}"]
# the kernels of rows 11, 12 and 2 as the profiler names them: the 2-layer
# forward core with the stored-gates LSTM cell (float32 storage) in its
# training and eval forms, and the 2-layer reverse core with the LSTM cell
TRACE_KERNELS = {
    "lstm2_train_fwd": r"rnn2_fwd::pair_kernel<rnn2_fwd::LstmCellT<true, float>, \d+, true>",
    "lstm2_bwd_chain": r"rnn2_bwd::pair_kernel<rnn2_bwd::LstmCellT<float>, \d+>",
    "lstm2_infer": r"rnn2_fwd::pair_kernel<rnn2_fwd::LstmCellT<true, float>, \d+, false>",
}


def synthetic_counts(steps: int, evals: int):
    """The synthetic model's launches: each of the three sensors' LSTMs
    takes rows 11 and 12 once a train step and row 2 once an eval batch."""
    return {"lstm2_train_fwd": 3 * steps, "lstm2_bwd_chain": 3 * steps,
            "lstm2_infer": 3 * evals}


def _step_latency(tag: str, cfg, model, loader, step_kw, reps: int = 60,
                  profile_reps: int = 10):
    """The b32 train step's p50 / p90 (host clock around synchronize) and
    device busy share on ``loader``: resident, each step gathering its batch
    on the card; streamed, each step copying its batch from the host first,
    as the trainer does.  Into ``STEPS[tag]``."""
    from multimodal_emotion_detection_tpu_torch.models.noise import Noise
    from multimodal_emotion_detection_tpu_torch.training.optim import build_optimizer
    from multimodal_emotion_detection_tpu_torch.training.steps import train_step

    dev = torch.device("cuda")
    model = model.to(dev)
    opt, _ = build_optimizer(cfg.training, model.parameters(), len(loader))
    gen = torch.Generator(device=dev)
    valid = torch.from_numpy(loader.epoch_batch_valid()[0]).to(dev)
    if loader.device_resident:
        feats, labels = loader.device_arrays()
        idx = torch.from_numpy(loader.epoch_batch_indices(0).astype(np.int64)).to(dev)
    identity = torch.arange(loader.batch_size, device=dev)
    state = {"step": 0, "batches": iter(())}

    def one_step():
        s = state["step"]
        gen.manual_seed(s)
        if loader.device_resident:
            f, lab, i = feats, labels, idx[s % idx.shape[0]]
        else:
            batch = next(state["batches"], None)
            if batch is None:
                state["batches"] = loader.stream(s)
                batch = next(state["batches"])
            (f, lab), i = batch, identity
        train_step(model, opt, f, lab, i, valid, noise=Noise(gen), **step_kw)
        state["step"] = s + 1

    torch.cuda.reset_peak_memory_stats()
    p50, p90 = host_ms(one_step, reps=reps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    how = "split on the card" if loader.device_resident else "each batch copied from the host"
    print(f"[{tag}] train-step latency b32 (host clock around synchronize, {reps} "
          f"steps, {how}): p50 {p50:.4f} ms, p90 {p90:.4f} ms = {32e3 / p50:.1f} clips/s "
          f"at p50; peak allocated {peak:.4f} GB")
    busy = profile_forward(f"{tag} b32", one_step, reps=profile_reps, what="train step")
    STEPS[tag] = (p50, busy, peak)
    if not loader.device_resident:
        # the same steps on an epoch's batches streamed and copied to the
        # card beforehand: what the step costs apart from making its batch
        ready = list(loader.stream(0))

        def ready_step():
            s = state["step"]
            gen.manual_seed(s)
            f, lab = ready[s % len(ready)]
            train_step(model, opt, f, lab, identity, valid, noise=Noise(gen), **step_kw)
            state["step"] = s + 1

        q50, q90 = host_ms(ready_step, reps=reps)
        print(f"[{tag}] the same steps on batches copied to the card beforehand: p50 "
              f"{q50:.4f} ms, p90 {q90:.4f} ms")


def phase_train_synthetic(counters, tag: str, extra=()):
    """The train CLI with ``dataset.name=synthetic`` (``SYNTHETIC``) for 2
    epochs at batch 32, from the work directory, with the launch counts
    checked and the artifacts written; one card step against the CPU step
    (``streamed``: on the batch as the host-streaming loader copies it);
    the train step's latency and busy share.  Returns ``(launches, run
    directory, overrides, results)``."""
    import contextlib

    from multimodal_emotion_detection_tpu_torch import train
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.data.loader import (
        SYNTHETIC_KEYS,
        create_dataloaders,
    )
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )

    config_path = str(ROOT / "configs" / "base.yaml")
    overrides = [*SYNTHETIC, "training.max_epochs=2", f"experiment.save_dir={WORK}",
                 f"experiment.name={tag}_run", *extra]
    cfg = load_config(config_path, overrides)
    steps, evals = 2 * 96 // 32, 2 * 64 // 32 + 64 // 32
    with contextlib.chdir(WORK):
        results, train_s, launches = run_counted(
            counters, synthetic_counts(steps, evals), tag,
            lambda: train.main(["--config", config_path, *overrides]))
    print(f"[{tag}] train.main, 2 epochs of 96 synthetic rows (3 sensors, T 100, D 32) at "
          f"batch 32 ({steps} steps, {evals} eval batches): {train_s:.3f} s wall; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    run_dir = WORK / f"{tag}_run"
    for rel in TRAIN_ARTIFACTS:
        if not (run_dir / rel).exists():
            raise RuntimeError(f"train.main did not write {rel}")
    if not all(np.isfinite(v) for v in results.values()):
        raise RuntimeError(f"non-finite results: {results}")
    print(f"[{tag}] results {json.dumps(results)}")

    dev = torch.device("cuda")
    streamed = not cfg.dataset.device_resident
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(0))
    loader = create_dataloaders(
        cfg.dataset.name, cfg.dataset.data_dir, cfg.dataset.modalities,
        batch_size=32, seed=cfg.seed, device_resident=not streamed, device=dev,
        **{k: getattr(cfg.dataset, k) for k in SYNTHETIC_KEYS})[0]
    step_kw = dict(lr=cfg.training.learning_rate,
                   clip_norm=cfg.training.gradient_clip_norm,
                   modality_dropout=cfg.training.augmentation.modality_dropout)
    sides = _step_sides(cfg, model, loader, 32, step_kw, streamed=streamed)
    _step_check(tag, cfg, sides["card"], sides["cpu"], 32)
    _step_latency(tag, cfg, model, loader, step_kw)
    return launches, run_dir, overrides, results


def _trace_kernels(path: Path):
    """Kernel events of a Chrome trace by name."""
    from collections import Counter

    events = json.loads(path.read_text())["traceEvents"]
    return Counter(e["name"] for e in events if e.get("cat") == "kernel")


def phase_train_synthetic_stream(counters, resident_results, resident_dir):
    """``[train_synthetic_stream]``: ``[train_synthetic]`` again with
    ``dataset.device_resident=false`` (each batch copied to the card as its
    step needs it) and ``runtime.profile_dir``: its losses, validation and
    test metrics bit for bit the resident run's; the trace of epoch 1 alone
    naming rows 11 and 12 three times a step of it and row 2 never; then one
    streamed and one resident epoch under ``torch.cuda.set_sync_debug_mode``:
    the streamed steps synchronise no more often than the resident ones."""
    import csv
    import re
    import warnings

    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.data.loader import (
        SYNTHETIC_KEYS,
        create_dataloaders,
    )
    from multimodal_emotion_detection_tpu_torch.training.loop import Trainer

    tag = "train_synthetic_stream"
    trace_dir = WORK / "synthetic_trace"
    launches, run_dir, overrides, results = phase_train_synthetic(
        counters, tag, ["dataset.device_resident=false", f"runtime.profile_dir={trace_dir}"])

    def rows(d):
        with open(d / "csv_logs/version_0/metrics.csv") as f:
            return [{k: v for k, v in r.items() if k != "train/clips_per_sec"}
                    for r in csv.DictReader(f)]

    same_csv = rows(run_dir) == rows(resident_dir)
    print(f"[{tag}] against [train_synthetic]: metrics.csv (every loss, accuracy, "
          f"validation and test value, lr) {'bit for bit equal' if same_csv else 'DIFFERENT'}; "
          f"results {'bit for bit equal' if results == resident_results else 'DIFFERENT'}")
    if not same_csv or results != resident_results:
        raise RuntimeError("the streamed run is not the resident run")

    traces = sorted(trace_dir.iterdir())
    if [p.name for p in traces] != ["trace_epoch1.json"]:
        raise RuntimeError(f"{tag}: expected one trace of epoch 1, found {traces}")
    kernels = _trace_kernels(traces[0])
    per_row = {row: sum(n for name, n in kernels.items() if re.search(pat, name))
               for row, pat in TRACE_KERNELS.items()}
    print(f"[{tag}] {traces[0].name}: {traces[0].stat().st_size / 1e6:.1f} MB, "
          f"{sum(kernels.values())} kernel events; rows 11 / 12 / 2 "
          f"{per_row['lstm2_train_fwd']} / {per_row['lstm2_bwd_chain']} / "
          f"{per_row['lstm2_infer']} (expected 9 / 9 / 0: 3 sensors x 3 steps, no eval)")
    for name, n in kernels.most_common():
        if "pair_kernel" in name:
            print(f"[{tag}]   {n:4d}  {name[:100]}")
    if per_row != {"lstm2_train_fwd": 9, "lstm2_bwd_chain": 9, "lstm2_infer": 0}:
        raise RuntimeError(f"{tag}: the trace does not hold epoch 1's kernels")

    # one epoch of each path under the sync debug mode, after a warm epoch
    dev = torch.device("cuda")
    cfg = load_config(str(ROOT / "configs" / "base.yaml"), overrides[:-1])
    trainer = Trainer(cfg, save_dir=WORK / "sync_check")
    gen = torch.Generator(device=dev)
    syncs = {}
    for resident in (True, False):
        loader = create_dataloaders(
            cfg.dataset.name, "", cfg.dataset.modalities, batch_size=32, seed=cfg.seed,
            device_resident=resident, device=dev,
            **{k: getattr(cfg.dataset, k) for k in SYNTHETIC_KEYS})[0]
        trainer._build(loader)
        trainer._train_epoch(loader, 0, *trainer._place(loader, 0)[1:], gen)
        _, idx_dev, valid_dev = trainer._place(loader, 1)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                trainer._train_epoch(loader, 1, idx_dev, valid_dev, gen)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs["resident" if resident else "streamed"] = [
            f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]
    print(f"[{tag}] torch.cuda.set_sync_debug_mode over one epoch (3 steps) of each path: "
          f"synchronising calls resident {len(syncs['resident'])} {syncs['resident']}, "
          f"streamed {len(syncs['streamed'])} {syncs['streamed']}")
    if len(syncs["streamed"]) > len(syncs["resident"]):
        raise RuntimeError("the streamed steps synchronise more than the resident ones")
    # the host's cost of one streamed batch alone: the loader is the last
    # one the loop made, the streamed one
    state = {"batches": iter(())}

    def one_batch():
        if next(state["batches"], None) is None:
            state["batches"] = loader.stream(0)
            next(state["batches"])

    b50, b90 = host_ms(one_batch)
    print(f"[{tag}] one streamed batch alone (3 x (32, 100, 32) float32 and the labels: "
          f"gathered on the host, pinned, copied; host clock around synchronize, 110 "
          f"batches): p50 {b50:.4f} ms, p90 {b90:.4f} ms")
    (p50, busy, _), (p50_r, busy_r, _) = STEPS[tag], STEPS["train_synthetic"]
    print(f"[{tag}] train step p50 {p50:.4f} ms, device busy "
          f"{100 * busy if busy else float('nan'):.1f}%; [train_synthetic] (resident) p50 "
          f"{p50_r:.4f} ms, busy {100 * busy_r if busy_r else float('nan'):.1f}%")
    return launches


def phase_serve_synthetic(counters, ckpt: Path, overrides):
    """``[serve_synthetic]``: the predict CLI on ``[train_synthetic]``'s
    ``best.ckpt`` over the synthetic test split (64 rows, 2 batches of 32):
    row 2 three times a batch; the logits against the model's forward on
    the CPU (plain versions) within 1e-3; the b32 forward's latency."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.tools import predict
    from multimodal_emotion_detection_tpu_torch.tools._restore import restore_for_eval
    from multimodal_emotion_detection_tpu_torch.training.steps import forward

    tag = "serve_synthetic"
    config_path = str(ROOT / "configs" / "base.yaml")
    out_dir = WORK / "predictions_synthetic"
    metrics, predict_s, launches = run_counted(
        counters, {"lstm2_infer": 3 * 2}, tag, lambda: predict.main([
            "--checkpoint", str(ckpt), "--config", config_path, "--split", "test",
            "--out", str(out_dir), *overrides]))
    logits = np.load(out_dir / "logits.npy")
    if logits.shape != (64, 5) or not np.isfinite(logits).all():
        raise RuntimeError(f"bad logits: shape {logits.shape}")
    cfg = load_config(config_path, overrides)
    model, _, loader = restore_for_eval(cfg, ckpt, "test", torch.device("cpu"))
    ref = torch.cat([forward(model, f, m) for f, _, m in loader]).numpy()
    err = float(np.abs(logits - ref).max())
    agree = int((logits.argmax(-1) == ref.argmax(-1)).sum())
    print(f"[{tag}] predict over 64 synthetic rows at batch 32: {predict_s:.3f} s wall; "
          f"launches { {k: v for k, v in launches.items() if v} }; logits vs the "
          f"plain-version forward on the CPU: max abs err {err:.3e} (bound 1e-3), argmax "
          f"agreement {agree}/64; accuracy {metrics['accuracy']:.4f}")
    if err > 1e-3 or agree != 64:
        raise RuntimeError("served logits disagree with the plain forward")
    dev = torch.device("cuda")
    model = model.to(dev)
    b32 = {k: v.to(dev) for k, v in next(iter(loader))[0].items()}
    p50, p90 = host_ms(lambda: forward(model, b32))
    print(f"[{tag}] forward latency b32 (host clock around synchronize, 110 requests): "
          f"p50 {p50:.4f} ms, p90 {p90:.4f} ms")
    return launches


def phase_debug(counters):
    """``[debug]``: the debug CLI on the synthetic model (full width, on
    the card).  The overfit probe must PASS and the gradient statistics be
    finite.  Launches, exactly: the probe's frozen-encoder steps run each
    sensor's training-mode forward (row 11; dropout 0, as the JAX probe's
    deterministic=False forward) and no reverse chain: the encoders'
    parameters take no gradient, as optax's set_to_zero discards theirs
    and XLA drops the chain that would form them.  So row 11 3 x the
    probe's steps; then the activation statistics' eval forward (row 2 x
    3) and the gradient statistics' one backward (rows 11 and 12 x 3)."""
    import contextlib
    import io
    import re

    from multimodal_emotion_detection_tpu_torch.tools import debug

    for c in counters.values():
        c.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ok = debug.main(["--config", str(ROOT / "configs" / "base.yaml"), *SYNTHETIC])
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="")
    launches = {name: c.launches for name, c in counters.items()}
    steps = re.search(r"\[overfit\] PASS at step (\d+)", out)
    if not ok or steps is None:
        raise RuntimeError("[debug] the overfit probe did not pass")
    k = int(steps.group(1))
    expected = {"lstm2_train_fwd": 3 * k + 3, "lstm2_bwd_chain": 3, "lstm2_infer": 3}
    for name, count in launches.items():
        if count != expected.get(name, 0):
            raise RuntimeError(f"{name} launched {count} times on the debug path, "
                               f"expected {expected.get(name, 0)}")
    norms = {m: float(v) for m, v in re.findall(r"\[grads\] (\S+): global_norm=(\S+)", out)}
    print(f"[debug] tools.debug on the card: {wall:.3f} s wall; PASS at step {k}; launches "
          f"{ {n: c for n, c in launches.items() if c} } (row 11: 3 x {k} frozen-encoder "
          f"steps + 3, rows 12 and 2: 3); gradient norms {norms}")
    # the three encoders, head_in and head_out
    if len(norms) != 5 or not all(np.isfinite(v) and v > 0 for v in norms.values()):
        raise RuntimeError(f"[debug] bad gradient statistics: {norms}")
    return launches


STREAM_WINDOWS = 58  # a 60 s stream in 3 s windows at a 1 s hop


def phase_stream(counters, ckpt: Path):
    """``[stream]``: ``tools.stream`` on the flagship's seeded checkpoint
    (``[serve]``'s) over a 60 s stream (960,000 samples, 480 frames):
    58 windows of 48,000 samples / 24 frames at hops 16,000 / 8, in 2
    microbatches of 32 (the last padded with the last window), log-mel and
    row 2 once each a microbatch; the same windows through the card's
    ``forward`` in b32 batches bit for bit; against the stream on the CPU
    (plain versions): logits within 1e-3, every label, ``timeline.csv``
    apart from its probability columns and ``summary.json`` equal; then
    ``--microbatch 1`` (row 2's B=1 plan): the same labels, probabilities
    within 1e-5."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.tools import stream
    from multimodal_emotion_detection_tpu_torch.tools._restore import restore_model
    from multimodal_emotion_detection_tpu_torch.training.steps import (
        forward,
        make_batched_forward_fn,
    )

    tag = "stream"
    rng = np.random.RandomState(23)
    src = WORK / "stream_in"
    src.mkdir(parents=True, exist_ok=True)
    streams = {"audio": rng.randn(960000, 1).astype(np.float32),
               "video": rng.rand(480, 4096).astype(np.float32)}
    for m, a in streams.items():
        np.save(src / f"{m}.npy", a)
    config_path = str(ROOT / "configs" / "base.yaml")
    overrides = ["model.frontend.audio=logmel"]
    args = ["--checkpoint", str(ckpt), "--config", config_path,
            "--input", f"audio={src / 'audio.npy'}", "--input", f"video={src / 'video.npy'}"]

    def run(name, expected, *extra):
        out = WORK / f"stream_{name}"
        summary, wall, launches = run_counted(counters, expected, f"{tag} {name}", lambda: (
            stream.main([*args, "--out", str(out), *extra, *overrides])))
        print(f"[{tag}] {name}: tools.stream over {summary['windows']} windows "
              f"{' '.join(extra)}: {wall:.3f} s wall (the whole call: load, restore, "
              f"windows, forwards, files); launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        return out, summary, launches

    card, summary, launches = run("card", {"logmel": 2, "lstm2_infer": 2}, "--microbatch", "32")
    if summary["windows"] != STREAM_WINDOWS:
        raise RuntimeError(f"[{tag}] {summary['windows']} windows")
    cpu, _, _ = run("cpu", {}, "--microbatch", "32", "runtime.platform=cpu")
    one, _, _ = run("b1", {"logmel": STREAM_WINDOWS, "lstm2_infer": STREAM_WINDOWS},
                    "--microbatch", "1")

    # the windows as the CLI cuts and pads them
    cut = {"audio": stream.sliding_windows(streams["audio"], 48000, 16000),
           "video": stream.sliding_windows(streams["video"], 24, 8)}
    stacked = {m: np.concatenate([c, np.repeat(c[-1:], 64 - len(c), axis=0)]).reshape(
        (2, 32) + c.shape[1:]) for m, c in cut.items()}
    cfg = load_config(config_path, overrides)
    cfg.model.frontend.cache = False
    dev = torch.device("cuda")
    model, _ = restore_model(cfg, ckpt, dev)
    on_card = {m: torch.from_numpy(a).to(dev) for m, a in stacked.items()}
    many = make_batched_forward_fn(model)(on_card)
    per_batch = torch.stack([forward(model, {m: a[i] for m, a in on_card.items()})
                             for i in range(2)])
    logits = many.reshape(64, -1)[:STREAM_WINDOWS].cpu().numpy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    same = torch.equal(many, per_batch) and np.array_equal(probs, np.load(card / "probs.npy"))
    cpu_model, _ = restore_model(cfg, ckpt, torch.device("cpu"))
    cpu_logits = make_batched_forward_fn(cpu_model)(
        {m: torch.from_numpy(a) for m, a in stacked.items()}).reshape(64, -1)[:STREAM_WINDOWS]
    err = float(np.abs(logits - cpu_logits.numpy()).max())
    labels = {n: np.load(d / "predictions.npy") for n, d in (("card", card), ("cpu", cpu),
                                                              ("b1", one))}
    lines = {n: (d / "timeline.csv").read_text().splitlines() for n, d in
             (("card", card), ("cpu", cpu))}
    spans = {n: [r.split(",")[:6] for r in ls] for n, ls in lines.items()}
    b1_err = float(np.abs(np.load(one / "probs.npy") - np.load(card / "probs.npy")).max())
    same_summary = (json.loads((card / "summary.json").read_text())
                    == json.loads((cpu / "summary.json").read_text()))
    print(f"[{tag}] the card's stream logits vs the card's forward on the same windows in "
          f"b32 batches: {'bit for bit equal' if same else 'DIFFERENT'}; vs the stream on "
          f"the CPU (plain versions): logits max abs err {err:.3e} (bound 1e-3), labels "
          f"{int((labels['card'] == labels['cpu']).sum())}/{STREAM_WINDOWS} equal, "
          f"timeline.csv windows / spans / labels "
          f"{'equal' if spans['card'] == spans['cpu'] else 'DIFFERENT'}, summary.json "
          f"{'equal' if same_summary else 'DIFFERENT'}; --microbatch 1 (row 2 at B=1): "
          f"labels {int((labels['b1'] == labels['card']).sum())}/{STREAM_WINDOWS} equal, "
          f"probabilities max abs diff {b1_err:.3e} (bound 1e-5); {summary['label_changes']} "
          "label changes")
    if not (same and err <= 1e-3 and np.array_equal(labels["card"], labels["cpu"])
            and spans["card"] == spans["cpu"] and same_summary
            and np.array_equal(labels["b1"], labels["card"]) and b1_err <= 1e-5):
        raise RuntimeError(f"[{tag}] the stream disagrees")
    return launches


def phase_quantize(counters, ckpt: Path, overrides, audio: np.ndarray,
                   video: np.ndarray):
    """``[quantize]``: ``tools.quantize`` on ``ckpt`` ([train]'s flagship
    ``best.ckpt``), then the predict CLI over the test split in float32, in
    each ``--quantize-weights`` mode and on the artifact, each with log-mel
    and row 2 once per batch.  The artifact's logits must equal the
    in-memory int8 round trip's bit for bit, and each mode's first batch
    the CPU's plain forward on the same rounded weights (1e-3, [serve]'s
    bound).  Returns the artifact run's launches."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.tools import predict, quantize
    from multimodal_emotion_detection_tpu_torch.tools._restore import restore_model
    from multimodal_emotion_detection_tpu_torch.training.steps import forward
    from multimodal_emotion_detection_tpu_torch.utils import quantize as q

    config = str(ROOT / "configs" / "base.yaml")
    out = WORK / "quantize"
    out.mkdir(parents=True, exist_ok=True)
    artifact = out / "model_int8.pt"
    t0 = time.perf_counter()
    stats = quantize.main(["--checkpoint", str(ckpt), "--config", config,
                           "--out", str(artifact), *overrides])
    print(f"[quantize] tools.quantize on {ckpt.relative_to(WORK)} "
          f"({time.perf_counter() - t0:.3f} s wall): {json.dumps(stats)}; the artifact "
          f"{artifact.stat().st_size} bytes on disk against the checkpoint's "
          f"{ckpt.stat().st_size} (the checkpoint holds the weights alone, no optimizer "
          "state)")
    n = audio.shape[0]
    batches = n // 32
    expected = {"logmel": batches, "lstm2_infer": batches}
    modes = {"float32": [], "int8": ["--quantize-weights", "int8"],
             "int8-bf16": ["--quantize-weights", "int8-bf16"],
             "bfloat16": ["--quantize-weights", "bfloat16"],
             "int8-artifact": ["--quantized-artifact", str(artifact)]}
    logits, metrics = {}, {}
    for mode, flags in modes.items():
        metrics[mode], wall, launches = run_counted(
            counters, expected, f"quantize {mode}", lambda: predict.main([
                "--checkpoint", str(ckpt), "--config", config, "--split", "test",
                *flags, "--out", str(out / mode), *overrides]))
        logits[mode] = np.load(out / mode / "logits.npy")
        if logits[mode].shape != (n, 8) or not np.isfinite(logits[mode]).all():
            raise RuntimeError(f"[quantize] {mode}: bad logits {logits[mode].shape}")
        print(f"[quantize] predict {mode} over {n} clips: {wall:.3f} s wall; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
    if not np.array_equal(logits["int8-artifact"], logits["int8"]):
        raise RuntimeError("[quantize] the artifact's logits differ from the in-memory "
                           "int8 round trip's")
    cfg = load_config(config, overrides)
    cfg.model.frontend.cache = False
    clips = {"audio": torch.from_numpy(audio[:32]), "video": torch.from_numpy(video[:32])}
    for mode in ("int8", "int8-bf16", "bfloat16"):
        model, _ = restore_model(cfg, ckpt, torch.device("cpu"))
        q.load_params(model, q.quantize_params_for_eval(q.model_params(model), mode))
        ref = forward(model, clips).numpy()
        err = float(np.abs(logits[mode][:32] - ref).max())
        agree = int((logits[mode][:32].argmax(-1) == ref.argmax(-1)).sum())
        print(f"[quantize] {mode}: logits vs the plain-version forward on the CPU on the "
              f"same rounded weights, first 32 clips: max abs err {err:.3e} (bound 1e-3), "
              f"argmax agreement {agree}/32; off the float32 logits by "
              f"{float(np.abs(logits[mode] - logits['float32']).max()):.3e} at most")
        if err > 1e-3 or agree != 32:
            raise RuntimeError(f"[quantize] {mode}: the card disagrees with the CPU")
    for mode, m in metrics.items():
        print(f"[quantize] {mode}: accuracy {m['accuracy']:.4f}, ECE {m['ece']:.6f}, NLL "
              f"{m['nll']:.6f} (float32: accuracy {metrics['float32']['accuracy']:.4f}, "
              f"ECE {metrics['float32']['ece']:.6f}; random labels, seeded weights)")
    return launches


EXPORT_FRESH = """
import sys
import torch
import multimodal_emotion_detection_tpu_torch.ops  # noqa: F401
program = torch.export.load(sys.argv[1]).module()
clips = {m: t.cuda() for m, t in torch.load(sys.argv[2]).items()}
with torch.inference_mode():
    logits = program(clips)
torch.save(logits.cpu(), sys.argv[3])
print(sorted(m for m in sys.modules if m.startswith("multimodal_emotion")))
"""


def phase_export(counters, tag: str, ckpt: Path, overrides, expected, fresh: bool = False):
    """``[export*]``: ``tools.export`` on ``ckpt`` at b32 (the CLI's round
    trip runs the eager forward and the loaded program once each: twice
    ``expected``), the file's bytes, then the loaded program on the test
    split's first 32 clips bit for bit the eager ``forward``'s with its
    launches exactly ``expected``, and both b32 forwards' p50 in turns;
    with ``fresh`` the file served in a fresh interpreter that imports
    only the port's ops.  Returns the exported call's launches."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.tools import export
    from multimodal_emotion_detection_tpu_torch.tools._restore import restore_model
    from multimodal_emotion_detection_tpu_torch.training.steps import forward

    config = str(ROOT / "configs" / "base.yaml")
    out = WORK / "export" / f"{tag}.pt2"
    out.parent.mkdir(parents=True, exist_ok=True)
    _, export_s, _ = run_counted(
        counters, {k: 2 * n for k, n in expected.items()}, tag, lambda: export.main([
            "--checkpoint", str(ckpt), "--config", config, "--out", str(out),
            "--batch", "32", *overrides]))
    print(f"[{tag}] tools.export at b32: {export_s:.3f} s wall (restore, trace, save, "
          f"load and the round trip); {out.stat().st_size} bytes of .pt2")
    dev = torch.device("cuda")
    cfg = load_config(config, overrides)
    cfg.model.frontend.cache = False
    model, _ = restore_model(cfg, ckpt, dev)
    test = WORK / "train_data" / "test"
    clips = {m: torch.from_numpy(np.load(test / f"{m}.npy")[:32]).to(dev)
             for m in cfg.dataset.modalities}
    program = export.load_exported(out).module()

    def served():
        with torch.inference_mode():
            return program(clips)

    eager = forward(model, clips)
    got, _, launches = run_counted(counters, expected, tag, served)
    same = got.dtype == eager.dtype and torch.equal(got, eager)
    print(f"[{tag}] the loaded program vs the eager forward on 32 clips: bit for bit "
          f"{same} (max abs diff {float((got.float() - eager.float()).abs().max()):.3e}); "
          f"launches of one exported call { {k: v for k, v in launches.items() if v} }")
    if not same:
        raise RuntimeError(f"[{tag}] the exported program's logits differ from the eager "
                           "forward's")
    p50s = {"eager": [], "exported": []}
    for _ in range(2):
        for label, fn in (("eager", lambda: forward(model, clips)), ("exported", served)):
            p50s[label].append(host_ms(fn, reps=40)[0])
    print(f"[{tag}] b32 forward p50 (host clock around synchronize, 40 requests, in "
          f"turns): exported {' / '.join(f'{v:.4f}' for v in p50s['exported'])} ms, "
          f"eager {' / '.join(f'{v:.4f}' for v in p50s['eager'])} ms")
    if fresh:
        torch.save({m: t.cpu() for m, t in clips.items()}, out.with_suffix(".clips.pt"))
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-c", EXPORT_FRESH, str(out), str(out.with_suffix(".clips.pt")),
             str(out.with_suffix(".logits.pt"))], capture_output=True, text=True,
            cwd=WORK, env={**os.environ, "PYTHONPATH": str(ROOT)}, timeout=300)
        if done.returncode != 0:
            raise RuntimeError(f"[{tag}] the fresh process failed:\n{done.stderr[-3000:]}")
        loaded = done.stdout.strip().splitlines()[-1]
        fresh_logits = torch.load(out.with_suffix(".logits.pt"))
        same = torch.equal(fresh_logits, eager.cpu())
        print(f"[{tag}] served in a fresh interpreter ({time.perf_counter() - t0:.3f} s "
              f"wall, its start included) that imported only {loaded}: bit for bit {same}")
        if not same or "models" in loaded or "tools" in loaded:
            raise RuntimeError(f"[{tag}] the fresh process's logits differ, or it imported "
                               "more than the ops")
    return launches


def quantized_serve(counters, tag: str, ckpt: Path, overrides, expected,
                    audio: np.ndarray, video: np.ndarray) -> dict:
    """``predict --quantize-weights int8`` on ``ckpt`` over the test split,
    launches exactly ``expected``; the first batch against the CPU's plain
    forward on the same rounded weights (1e-3, argmax 32 / 32).  Returns
    the launches."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.tools import predict
    from multimodal_emotion_detection_tpu_torch.tools._restore import restore_model
    from multimodal_emotion_detection_tpu_torch.training.steps import forward
    from multimodal_emotion_detection_tpu_torch.utils import quantize as q

    config = str(ROOT / "configs" / "base.yaml")
    out = WORK / "quantize" / tag
    _, wall, launches = run_counted(counters, expected, tag, lambda: predict.main([
        "--checkpoint", str(ckpt), "--config", config, "--split", "test",
        "--quantize-weights", "int8", "--out", str(out), *overrides]))
    logits = np.load(out / "logits.npy")
    if logits.shape != (audio.shape[0], 8) or not np.isfinite(logits).all():
        raise RuntimeError(f"[{tag}] bad logits {logits.shape}")
    cfg = load_config(config, overrides)
    cfg.model.frontend.cache = False
    model, _ = restore_model(cfg, ckpt, torch.device("cpu"))
    q.load_params(model, q.quantize_params_for_eval(q.model_params(model), "int8"))
    ref = forward(model, {"audio": torch.from_numpy(audio[:32]),
                          "video": torch.from_numpy(video[:32])}).numpy()
    err = float(np.abs(logits[:32] - ref).max())
    agree = int((logits[:32].argmax(-1) == ref.argmax(-1)).sum())
    print(f"[{tag}] predict --quantize-weights int8 over {audio.shape[0]} clips: "
          f"{wall:.3f} s wall; launches { {k: v for k, v in launches.items() if v} }; "
          f"first 32 clips vs the plain-version forward on the CPU on the same rounded "
          f"weights: max abs err {err:.3e} (bound 1e-3), argmax agreement {agree}/32")
    if err > 1e-3 or agree != 32:
        raise RuntimeError(f"[{tag}] the card disagrees with the CPU")
    return launches


SWEEP_GRID_LRS = "1e-3,5e-4,2e-3"  # the reference's lr axis, 1e-3 first


def phase_sweep(counters, train_p50: float):
    """``[sweep]``: ``tools.sweep --vmap-grid`` on the flagship for 1 epoch
    over [train]'s splits: the reference's 3x2x2 grid as 2 programs of 6
    members, each member stepping through rows 1, 11 and 12 and validating
    through rows 1 and 2; its lr axis listed with 1e-3 first, so the
    (1e-3, drop 0, mDrop 0) member is member 0 of its program, whose init a
    standalone ``--vmap-lrs 1e-3`` run repeats: its results must equal that
    member's exactly.  Then ``run_sweep`` over a 1x2x1 grid (two train.run
    calls) and its harvested artifacts, and the step time per member."""
    import contextlib

    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.data.loader import create_dataloaders
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
    )
    from multimodal_emotion_detection_tpu_torch.parallel import vmap_sweep as vs
    from multimodal_emotion_detection_tpu_torch.tools import sweep

    config = str(ROOT / "configs" / "base.yaml")
    data = WORK / "train_data"
    out = WORK / "sweep"
    base = ["model.frontend.audio=logmel", "training.max_epochs=1",
            f"dataset.data_dir={data}", f"experiment.save_dir={out}",
            "experiment.name=sweep"]
    steps, evals = TRAIN_SPLITS["train"] // 32, TRAIN_SPLITS["val"] // 32
    print(f"[sweep] cut to size: 1 epoch of [train]'s {TRAIN_SPLITS['train']}-clip train "
          f"split ({steps} steps of 32 a member) and {TRAIN_SPLITS['val']}-clip val split "
          f"({evals} batches); the flagship at full width, random labels")

    def counts(members, steps, evals):
        return {"logmel": members * (steps + evals), "lstm2_train_fwd": members * steps,
                "lstm2_bwd_chain": members * steps, "lstm2_infer": members * evals}

    grid, grid_s, launches = run_counted(
        counters, counts(12, steps, evals), "sweep", lambda: sweep.main([
            "--config", config, "--vmap-grid", "--vmap-lrs", SWEEP_GRID_LRS,
            "--out", str(out / "grid"), *base]))
    tags = [r["tag"] for r in grid]
    if len(set(tags)) != 12 or not all(np.isfinite(r["best_val_loss"]) for r in grid):
        raise RuntimeError(f"[sweep] bad grid results: {grid}")
    print(f"[sweep] --vmap-grid: 12 members in 2 programs, {grid_s:.3f} s wall (data "
          f"load and set-up included); launches {launches}")
    for r in grid:
        print(f"[sweep]   {r['tag']}: best_val_loss {r['best_val_loss']:.6f}, "
              f"final_val_acc {r['final_val_acc']:.4f}")
    solo, solo_s, _ = run_counted(
        counters, counts(1, steps, evals), "sweep solo", lambda: sweep.main([
            "--config", config, "--vmap-lrs", "1e-3", "--out", str(out / "solo"), *base,
            "model.dropout=0.0", "training.augmentation.modality_dropout=0.0"]))
    member = next(r for r in grid if r["tag"] == sweep.format_tag(1e-3, 0.0, 0.0))
    same = all(member[k] == solo[0][k] for k in ("best_val_loss", "best_epoch",
                                                   "final_val_acc"))
    print(f"[sweep] --vmap-lrs 1e-3 alone ({solo_s:.3f} s wall): {solo[0]}; the grid's "
          f"{member['tag']}: equal to the last bit: {same}")
    if not same:
        raise RuntimeError("[sweep] the grid member differs from the standalone run")

    per_run = {"logmel": steps + evals + 2, "lstm2_train_fwd": steps,
               "lstm2_bwd_chain": steps, "lstm2_infer": evals + 2}
    cfg = load_config(config, base)
    with contextlib.chdir(WORK):
        results, seq_s, seq_launches = run_counted(
            counters, {k: 2 * v for k, v in per_run.items()}, "sweep sequential",
            lambda: sweep.run_sweep(cfg, learning_rates=[1e-3], dropouts=[0.0, 0.1],
                                    modality_dropouts=[0.0], out_root=str(out / "seq"),
                                    overrides=base))
    try:
        import matplotlib  # noqa: F401
        png = True
    except ImportError:
        png = False
    harvested = ["results.json", "confusion_matrix.npy", "best.ckpt", "metrics.csv",
                 "hyperparams.txt"] + (["confusion_matrix.png"] if png else [])
    for r in results:
        missing = [a for a in harvested if not (out / "seq" / r["tag"] / a).exists()]
        if missing or not np.isfinite(r["best_val_loss"]):
            raise RuntimeError(f"[sweep] run_sweep {r['tag']}: missing {missing}")
    summary = json.loads((out / "seq" / "sweep_summary.json").read_text())
    if [r["tag"] for r in summary] != [r["tag"] for r in results]:
        raise RuntimeError("[sweep] sweep_summary.json does not list the runs")
    print(f"[sweep] run_sweep 1x2x1 ({seq_s:.3f} s wall, two train.run calls): "
          f"{[r['tag'] for r in results]}, each harvested {harvested} "
          f"(confusion_matrix.png needs matplotlib: {png}); launches "
          f"{ {k: v for k, v in seq_launches.items() if v} }")

    # the step time a member: one program's 6 members on [train]'s split
    dev = torch.device("cuda")
    train_loader = create_dataloaders(cfg.dataset.name, cfg.dataset.data_dir,
                                      cfg.dataset.modalities, batch_size=32,
                                      seed=cfg.seed, device=dev)[0]
    feats, labels = train_loader.device_arrays()
    idx = torch.from_numpy(train_loader.epoch_batch_indices(0).astype(np.int64)).to(dev)
    valid = torch.from_numpy(train_loader.epoch_batch_valid()).to(dev)
    lrs, mdrops = [1e-3] * 6, [0.0, 0.05] * 3
    state = vs.init_sweep_state(classifier_from_config(cfg), lrs, cfg.seed,
                                mdrops=mdrops, device=dev)
    step = vs.make_vmapped_train_step(2, 0.0, 1.0, 1e-4)
    k = {"s": 0}

    def one_step():
        s = k["s"] % idx.shape[0]
        step(state, feats, labels, idx[s], valid[s], cfg.seed)
        k["s"] += 1

    p50, p90 = host_ms(one_step, reps=10, warmup=2)
    print(f"[sweep] a 6-member grid step (host clock around synchronize, 10 steps): p50 "
          f"{p50:.4f} ms, p90 {p90:.4f} ms = {p50 / 6:.4f} ms a member step; [train]'s "
          f"b32 train step in the same call: p50 {train_p50:.4f} ms")
    return launches


def phase_visualize(counters, ckpt: Path, overrides, audio: np.ndarray,
                    video: np.ndarray):
    """``[visualize]``: ``tools.visualize`` on ``ckpt`` ([train_hybrid]'s
    ``best.ckpt``) over the first test batch (log-mel and row 2 once); the
    (M, M) cross-attention matrix from the card against the CPU's plain
    forward on the same weights and clips (1e-5)."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.tools import visualize
    from multimodal_emotion_detection_tpu_torch.tools._restore import restore_model

    config = str(ROOT / "configs" / "av_hybrid.yaml")
    png = WORK / "attention.png"
    result, wall, launches = run_counted(
        counters, {"logmel": 1, "lstm2_infer": 1}, "visualize", lambda: visualize.main([
            "--checkpoint", str(ckpt), "--config", config, "--out", str(png), *overrides]))
    if result != str(png):
        raise RuntimeError(f"[visualize] no heatmap: {result}")
    cfg = load_config(config, overrides)
    cfg.model.frontend.cache = False
    clips = {"audio": torch.from_numpy(audio[:32]), "video": torch.from_numpy(video[:32])}
    mats = {}
    for name, dev in (("card", torch.device("cuda")), ("cpu", torch.device("cpu"))):
        model, _ = restore_model(cfg, ckpt, dev)
        mats[name] = visualize.attention_matrix(
            model, {k: v.to(dev) for k, v in clips.items()},
            torch.ones((32, 2), device=dev), list(cfg.dataset.modalities))
    err = float(np.abs(mats["card"] - mats["cpu"]).max())
    print(f"[visualize] tools.visualize: {wall:.3f} s wall; launches "
          f"{ {k: v for k, v in launches.items() if v} }; PNG written: {png.exists()} "
          "(matplotlib is needed to draw it)")
    print(f"[visualize] query x key modality attention {cfg.dataset.modalities}: "
          f"{np.round(mats['card'], 6).tolist()}; against the CPU's: max abs err "
          f"{err:.3e} (bound 1e-5)")
    if mats["card"].shape != (2, 2) or err > 1e-5:
        raise RuntimeError("[visualize] the card's matrix disagrees with the CPU's")
    return launches


# ---------------------------------------------------------------------------
# the reference checkpoint import, the ETL, the on-device video resize and
# the flop counts
# ---------------------------------------------------------------------------


class _RefFlagship(torch.nn.Module):
    """The reference's model at ``configs/base.yaml``'s widths, wired as
    the reference is and independent of the port, its modules under the
    reference LightningModule's names (``encoders.<m>``, ``fusion_head``):
    cuDNN's 2-layer LSTM 256 over the raw waveform (B, 48000, 1) and a
    Linear to 128; the frame encoder (Linear 4096 -> 256 + ReLU, attention
    pool, LayerNorm, Linear to 128); the concat head (256 -> 256 -> 8)."""

    def __init__(self):
        super().__init__()
        nn = torch.nn
        audio, video = nn.Module(), nn.Module()
        audio.rnn = nn.LSTM(1, 256, num_layers=2, batch_first=True)
        audio.projection = nn.Linear(256, 128)
        video.frame_mlp = nn.Sequential(nn.Linear(4096, 256), nn.ReLU())
        video.attention = nn.Linear(256, 1)
        video.projection = nn.Sequential(nn.LayerNorm(256), nn.Linear(256, 128))
        self.encoders = nn.ModuleDict({"audio": audio, "video": video})
        self.fusion_head = nn.Sequential(nn.Linear(256, 256), nn.ReLU(), nn.Linear(256, 8))

    def forward(self, audio, video):
        a, v = self.encoders["audio"], self.encoders["video"]
        _, (h_n, _) = a.rnn(audio)
        x = v.frame_mlp(video)
        w = torch.softmax(v.attention(x).squeeze(-1), dim=1)
        ev = v.projection(torch.einsum("bt,bth->bh", w, x))
        return self.fusion_head(torch.cat([a.projection(h_n[-1]), ev], dim=-1))


def phase_import_ref(counters):
    """``[import_ref]``: the reference's own model (``_RefFlagship``, seeded
    torch init) saved as a Lightning-style ``.ckpt``, imported by
    ``utils/torch_import.py::import_reference_checkpoint`` onto
    ``configs/base.yaml`` as written, saved as a port checkpoint and served
    over ``[serve]``'s 64 test clips at b32 by the predict CLI (row 2 once
    a batch, no other kernel); the logits against the reference module's
    own forward on the card (cuDNN, TF32 off): 1e-3 abs, argmax 64/64."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
    )
    from multimodal_emotion_detection_tpu_torch.tools import predict
    from multimodal_emotion_detection_tpu_torch.training.checkpoints import (
        save_checkpoint,
    )
    from multimodal_emotion_detection_tpu_torch.utils.torch_import import (
        import_reference_checkpoint,
    )

    data = WORK / "data"  # [serve]'s test split: 64 clips
    audio = np.load(data / "test" / "audio.npy")
    video = np.load(data / "test" / "video.npy")
    torch.manual_seed(7)
    ref = _RefFlagship().eval()
    ref_ckpt = WORK / "reference_flagship.ckpt"
    torch.save({"state_dict": ref.state_dict(), "epoch": 0}, ref_ckpt)
    overrides = [f"dataset.data_dir={data}"]
    config_path = str(ROOT / "configs" / "base.yaml")
    t0 = time.perf_counter()
    model = classifier_from_config(load_config(config_path, overrides))
    model.load_state_dict(import_reference_checkpoint(str(ref_ckpt), model), strict=True)
    ckpt = WORK / "reference_imported.pt"
    save_checkpoint(ckpt, model.state_dict(), {"seed": 7})
    print(f"[import_ref] {ref_ckpt.name} ({ref_ckpt.stat().st_size} bytes, "
          f"{len(ref.state_dict())} reference tensors) imported onto configs/base.yaml "
          f"({len(model.state_dict())} tensors, strict) and saved: "
          f"{time.perf_counter() - t0:.3f} s")
    out_dir = WORK / "predictions_import_ref"
    batches = audio.shape[0] // 32
    _, predict_s, launches = run_counted(
        counters, {"lstm2_infer": batches}, "import_ref", lambda: predict.main([
            "--checkpoint", str(ckpt), "--config", config_path, "--split", "test",
            "--out", str(out_dir), *overrides]))
    logits = np.load(out_dir / "logits.npy")
    print(f"[import_ref] predict over {audio.shape[0]} clips at batch 32 (raw waveform, "
          f"T 48,000): {predict_s:.3f} s wall; launches {launches}")

    dev = torch.device("cuda")
    ref = ref.to(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = torch.cat([ref(torch.from_numpy(audio[i:i + 32]).to(dev),
                              torch.from_numpy(video[i:i + 32]).to(dev))
                          for i in range(0, audio.shape[0], 32)]).cpu().numpy()
    ref_s = time.perf_counter() - t0
    err = float(np.abs(logits - want).max())
    agree = int((logits.argmax(-1) == want.argmax(-1)).sum())
    print(f"[import_ref] logits vs the reference module's forward on the card (cuDNN "
          f"nn.LSTM, TF32 off; {ref_s:.3f} s for the 2 batches): max abs err {err:.3e} "
          f"(bound 1e-3; largest logit {float(np.abs(want).max()):.4f}), argmax "
          f"agreement {agree}/{audio.shape[0]}")
    if logits.shape != want.shape or err > 1e-3 or agree != audio.shape[0]:
        raise RuntimeError("import_ref: the imported model disagrees with the reference")
    return launches


ETL_EMOTIONS, ETL_REPS, ETL_ACTORS = 8, 2, 6  # 96 clips
ETL_SR, ETL_SECONDS = 48000, 3.5


def _write_ravdess_media(root: Path) -> Path:
    """96 RAVDESS-named 48 kHz 16-bit mono WAVs of 3.5 s (a tone per
    emotion in noise, a level per clip), a (24, 4096) float32 frame ``.npy``
    per clip and a manifest of both (``label,audio,video``)."""
    import wave

    rng = np.random.RandomState(11)
    (root / "wavs").mkdir(parents=True, exist_ok=True)
    (root / "frames").mkdir(exist_ok=True)
    t = np.arange(int(ETL_SR * ETL_SECONDS)) / ETL_SR
    rows = ["label,audio,video"]
    for emotion in range(1, ETL_EMOTIONS + 1):
        for rep in range(1, ETL_REPS + 1):
            for actor in range(1, ETL_ACTORS + 1):
                stem = f"03-01-{emotion:02d}-01-01-{rep:02d}-{actor:02d}"
                y = rng.uniform(0.2, 0.6) * (np.sin(2 * np.pi * 110 * emotion * t)
                                             + 0.3 * rng.randn(t.size))
                with wave.open(str(root / "wavs" / f"{stem}.wav"), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(ETL_SR)
                    w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())
                np.save(root / "frames" / f"{stem}.npy",
                        rng.rand(24, 4096).astype(np.float32))
                rows.append(f"{emotion - 1},wavs/{stem}.wav,frames/{stem}.npy")
    (root / "manifest.csv").write_text("\n".join(rows) + "\n")
    return root / "manifest.csv"


def _split_sizes(root: Path):
    return [len(np.load(root / s / "labels.npy")) for s in ("train", "val", "test")]


def phase_etl(counters):
    """``[etl]``: the port's two ETL CLIs on 96 written clips, counted (host
    code: no kernel launches): ``data.ravdess --no_video`` and
    ``data.manifest --feature_len 24``.  Checks the arrays' shapes and
    dtypes, every clip's peak at 1, the split sizes (the numpy split where
    sklearn is not installed, sklearn's where it is), the frames carried
    over, and the native resampler against its scipy plain version on
    every clip (float64, 1e-12).  Returns ``(launches, the manifest
    ETL's output directory)``."""
    import importlib.util

    from multimodal_emotion_detection_tpu_torch.data import manifest, ravdess
    from multimodal_emotion_detection_tpu_torch.utils import native, wav

    root = WORK / "etl_media"
    t0 = time.perf_counter()
    manifest_csv = _write_ravdess_media(root)
    print(f"[etl] wrote {ETL_EMOTIONS * ETL_REPS * ETL_ACTORS} RAVDESS-named WAVs "
          f"({ETL_SR} Hz, 16-bit, {ETL_SECONDS} s) and frame .npy files: "
          f"{time.perf_counter() - t0:.3f} s")
    rav_out, man_out = WORK / "etl_ravdess", WORK / "etl_manifest"

    def run():
        t = time.perf_counter()
        ravdess.main(["--audio_root", str(root / "wavs"), "--out_root", str(rav_out),
                      "--no_video"])
        mid = time.perf_counter()
        manifest.main(["--manifest", str(manifest_csv), "--out_root", str(man_out),
                       "--feature_len", "24"])
        return mid - t, time.perf_counter() - mid

    (rav_s, man_s), _, launches = run_counted(counters, {}, "etl", run)
    print(f"[etl] data.ravdess --no_video {rav_s:.3f} s, data.manifest --feature_len 24 "
          f"{man_s:.3f} s (host, the native resampler built with g++ at first use: "
          f"{native.library_path().name}); launches {launches}")

    n = ETL_EMOTIONS * ETL_REPS * ETL_ACTORS
    sklearn = importlib.util.find_spec("sklearn") is not None
    # 12 clips a class, val 0.15, test 0.15: sklearn's two stages give
    # 67 / 14 / 15; the numpy split rounds per class, 8 / 2 / 2
    want = [67, 14, 15] if sklearn else [64, 16, 16]
    for out in (rav_out, man_out):
        sizes = _split_sizes(out)
        if sizes != want:
            raise RuntimeError(f"etl: {out.name} splits {sizes}, expected {want}")
        for split in ("train", "val", "test"):
            a = np.load(out / split / "audio.npy")
            lab = np.load(out / split / "labels.npy")
            if a.dtype != np.float32 or a.shape[1:] != (48000, 1) or len(lab) != len(a):
                raise RuntimeError(f"etl: {out.name}/{split} audio {a.dtype} {a.shape}")
            if not (np.abs(a).max(axis=(1, 2)) == 1.0).all():
                raise RuntimeError(f"etl: {out.name}/{split}: a clip's peak is not 1")
            if lab.min() < 0 or lab.max() > 7:
                raise RuntimeError(f"etl: {out.name}/{split} labels out of range")
    frames = np.concatenate([np.load(man_out / s / "video.npy") for s in ("train", "val", "test")])
    if frames.shape != (n, 24, 4096) or frames.dtype != np.float32:
        raise RuntimeError(f"etl: manifest video {frames.dtype} {frames.shape}")
    src = np.stack([np.load(p) for p in sorted((root / "frames").glob("*.npy"))])
    if not np.array_equal(np.sort(frames.sum(axis=(1, 2))), np.sort(src.sum(axis=(1, 2)))):
        raise RuntimeError("etl: the manifest's frames are not the clips' frames")
    print(f"[etl] both outputs: splits {want} ({'sklearn' if sklearn else 'numpy'} split), "
          "audio (N, 48000, 1) float32 each clip's peak 1, labels 0..7; the manifest's "
          "video (N, 24, 4096) float32, the clips' frames")

    t_native = t_plain = 0.0
    err = 0.0
    for path in sorted((root / "wavs").glob("*.wav")):
        y, sr = wav.read_wav(path)
        t = time.perf_counter()
        ours = native.resample_poly_native(y, 1, 3, wav._KAISER_BEST_BETA,
                                           wav._KAISER_BEST_HALF_CYCLES,
                                           wav._KAISER_BEST_ROLLOFF)
        t_native += time.perf_counter() - t
        t = time.perf_counter()
        plain = native.resample_poly_plain(y, 1, 3, wav._KAISER_BEST_BETA,
                                           wav._KAISER_BEST_HALF_CYCLES,
                                           wav._KAISER_BEST_ROLLOFF)
        t_plain += time.perf_counter() - t
        if ours.shape != plain.shape:
            raise RuntimeError(f"etl: resample shapes {ours.shape} vs {plain.shape}")
        err = max(err, float(np.abs(ours - plain).max()))
    print(f"[etl] native resampler vs its scipy plain version on all {n} clips "
          f"(48 kHz -> 16 kHz, kaiser_best, float64): max abs err {err:.3e} (bound 1e-12); "
          f"host time {t_native:.3f} s native, {t_plain:.3f} s scipy")
    if err > 1e-12:
        raise RuntimeError("etl: the native resampler disagrees with scipy")
    return launches, man_out


def phase_train_etl(counters, data: Path):
    """``[train_etl]``: the train CLI on the manifest ETL's output,
    ``configs/base.yaml model.frontend.audio=logmel``, 2 epochs at b32:
    rows 1, 11, 12 and 2 counted exactly."""
    import contextlib

    from multimodal_emotion_detection_tpu_torch import train

    n_train, n_val, n_test = _split_sizes(data)
    steps = 2 * -(-n_train // 32)
    evals = 2 * -(-n_val // 32) + -(-n_test // 32)
    overrides = ["model.frontend.audio=logmel", "training.max_epochs=2",
                 f"dataset.data_dir={data}", f"experiment.save_dir={WORK}",
                 "experiment.name=train_etl_run"]
    config_path = str(ROOT / "configs" / "base.yaml")
    with contextlib.chdir(WORK):
        results, train_s, launches = run_counted(
            counters, {"logmel": steps + evals, "lstm2_train_fwd": steps,
                       "lstm2_bwd_chain": steps, "lstm2_infer": evals}, "train_etl",
            lambda: train.main(["--config", config_path, *overrides]))
    if not (WORK / "train_etl_run" / "best.ckpt").exists():
        raise RuntimeError("train_etl: no best.ckpt")
    if not all(np.isfinite(v) for v in results.values()):
        raise RuntimeError(f"train_etl: non-finite results {results}")
    print(f"[train_etl] train.main on the manifest ETL's {n_train} / {n_val} / {n_test} "
          f"clips, 2 epochs at b32 ({steps} steps, {evals} eval batches): {train_s:.3f} s "
          f"wall; launches {launches}; results {json.dumps(results)}")
    return launches


RESIZE_SHAPE = (32, 24, 720, 1280, 3)  # RAVDESS's 1280x720 BGR frames, b32
BGR_LUMA = np.array([0.114, 0.587, 0.299], dtype=np.float32)


def phase_serve_resize(counters):
    """``[serve_resize]``: the flagship (``configs/base.yaml`` + log-mel)
    with ``model.frontend.video=resize``, seeded weights, served at b32 on
    raw uint8 BGR frames at 1280x720 (2.1 GB a batch, made on the card):
    row 1 and row 2 once; the logits within 1e-4 of the same model's on
    the ETL-flattened frames (``area_resize_np`` of the gray frames / 255,
    on the CPU), argmax 32/32; the card's resized frames of 2 clips
    against that numpy resize (1e-5); the b32 forward's latency beside the
    flattened frames', and the frontend's device time beside its bound."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.models.classifier import (
        classifier_from_config,
        init_weights,
    )
    from multimodal_emotion_detection_tpu_torch.ops.resize import area_resize_np
    from multimodal_emotion_detection_tpu_torch.training.steps import forward

    dev = torch.device("cuda")
    cfg = load_config(str(ROOT / "configs" / "base.yaml"),
                      ["model.frontend.audio=logmel", "model.frontend.video=resize"])
    model = init_weights(classifier_from_config(cfg), torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(5)
    frames = torch.randint(0, 256, RESIZE_SHAPE, dtype=torch.uint8, device=dev, generator=gen)
    audio = torch.randn(32, 48000, 1, device=dev, generator=gen)
    logits, fwd_s, launches = run_counted(
        counters, {"logmel": 1, "lstm2_infer": 1}, "serve_resize",
        lambda: forward(model, {"audio": audio, "video": frames}).float().cpu().numpy())
    print(f"[serve_resize] forward b32 on raw uint8 frames {tuple(frames.shape)} "
          f"({frames.numel() / 1e9:.3f} GB): {fwd_s:.3f} s (first call); launches {launches}")

    t0 = time.perf_counter()
    host = frames.cpu().numpy()
    flat = np.stack([(area_resize_np(clip.astype(np.float32) @ BGR_LUMA, 64, 64) / 255.0)
                     .reshape(24, 4096).astype(np.float32) for clip in host])
    del host
    print(f"[serve_resize] the ETL-flattened frames on the CPU (numpy, the ETL's "
          f"transform): {time.perf_counter() - t0:.3f} s")
    flat_dev = torch.from_numpy(flat).to(dev)
    want = forward(model, {"audio": audio, "video": flat_dev}).float().cpu().numpy()
    err = float(np.abs(logits - want).max())
    agree = int((logits.argmax(-1) == want.argmax(-1)).sum())
    with torch.inference_mode():
        small = model._apply_frontend("video", frames[:2]).cpu().numpy()
    err_frames = float(np.abs(small - flat[:2]).max())
    print(f"[serve_resize] logits vs the ETL-flattened route: max abs err {err:.3e} "
          f"(bound 1e-4), argmax {agree}/32; resized frames of 2 clips vs the numpy "
          f"resize: max abs err {err_frames:.3e} (bound 1e-5)")
    if err > 1e-4 or agree != 32 or err_frames > 1e-5 or not np.isfinite(logits).all():
        raise RuntimeError("serve_resize: the on-card resize disagrees with the ETL's")

    raw_batch = {"audio": audio, "video": frames}
    flat_batch = {"audio": audio, "video": flat_dev}
    for label, batch in (("raw frames", raw_batch), ("flattened frames", flat_batch)):
        p50, p90 = host_ms(lambda: forward(model, batch), reps=20)
        print(f"[serve_resize] forward b32 on {label} (host clock around synchronize, "
              f"20 requests, inputs on the card): p50 {p50:.4f} ms, p90 {p90:.4f} ms")
    flush = L2Flush()
    with torch.inference_mode():
        ms = device_ms(lambda: model._apply_frontend("video", frames), flush, reps=10)
    # the least work: each uint8 byte read once, the (32, 24, 4096) float32
    # frames written once
    nbytes = frames.numel() + flat.size * 4
    bound_ms = 1e3 * nbytes / HBM_BYTES
    print(f"[serve_resize] the video frontend alone (BGR -> gray, area resize, /255; "
          f"CUDA events, L2 flushed, median of 10): {ms:.4f} ms against its bound "
          f"{bound_ms:.4f} ms (bytes: {nbytes / 1e9:.3f} GB at {HBM_BYTES / 1e12:.2f} TB/s)")
    profile_forward("serve_resize b32", lambda: forward(model, raw_batch), reps=5)
    del frames, flat_dev, raw_batch, flat_batch, flush
    torch.cuda.empty_cache()
    return launches


def _path_dtype(cfg) -> str:
    """The compute dtype of a path's matrix products: bf16 where the model
    or an encoder computes in bf16, else float32 (TF32 off)."""
    if cfg.runtime.compute_dtype == "bfloat16" or any(
            dict(e).get("dtype") == "bfloat16" for e in cfg.model.encoders.values()):
        return "bfloat16"
    return "float32"


def phase_flops(card_name: str):
    """``[flops]``: ``utils/flops.py``'s analytic FLOPs per clip (train and
    forward) of every configuration ``phase_train`` trained, the share of
    the card's datasheet peak for the path's compute dtype at each train
    step's b32 p50 (``[train]``'s first) and at ``[serve]``'s b32 forward
    p50, and a device-to-device copy's bandwidth beside the datasheet HBM
    figure."""
    from multimodal_emotion_detection_tpu_torch.config import load_config
    from multimodal_emotion_detection_tpu_torch.utils import flops

    smi = nvidia_smi()
    for tag, (config_path, overrides) in TRAINED.items():
        cfg = load_config(config_path, overrides)
        # the count walks every configured encoder; the classifier builds
        # those of dataset.modalities only, and no log-mel without audio
        mods = cfg.dataset.modalities
        cfg.model.encoders = {m: e for m, e in dict(cfg.model.encoders).items() if m in mods}
        if "audio" not in mods:
            cfg.model.frontend.audio = "raw"
        r = flops.classifier_flops_per_clip(cfg)
        dtype = _path_dtype(cfg)
        peak = flops.device_peak_flops(dtype)
        note = (" (the fusion library is not modelled: the head counted as the concat "
                "head)" if cfg.model.train_fusion == "library" else "")
        line = (f"[flops] {tag} ({Path(config_path).name}): train {r['train'] / 1e9:.4f} "
                f"GFLOP a clip, forward {r['forward'] / 1e9:.4f}{note}")
        if tag in STEPS:
            p50 = STEPS[tag][0]
            m = flops.mfu(32e3 / p50, r["train"], peak)
            line += (f"; train step b32 p50 {p50:.4f} ms: {m['achieved_tflops']:.4f} "
                     f"TFLOP/s = {100 * m['mfu']:.3f}% of the {dtype} peak "
                     f"{m['peak_tflops']:.1f} TFLOP/s")
        print(line)
    cfg = load_config(str(ROOT / "configs" / "base.yaml"), ["model.frontend.audio=logmel"])
    fwd = flops.classifier_flops_per_clip(cfg)["forward"]
    p50 = SERVES["serve"]["b32"]
    m = flops.mfu(32e3 / p50, fwd, flops.device_peak_flops("float32"))
    print(f"[flops] serve (the flagship): forward {fwd / 1e9:.4f} GFLOP a clip; b32 p50 "
          f"{p50:.4f} ms: {m['achieved_tflops']:.4f} TFLOP/s = {100 * m['mfu']:.3f}% of "
          f"the float32 peak {m['peak_tflops']:.1f} TFLOP/s")

    src = torch.empty(512 * 1024 * 1024, dtype=torch.float32, device="cuda")  # 2 GiB
    src.uniform_()
    dst = torch.empty_like(src)
    for _ in range(3):
        dst.copy_(src)
    reps = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    moved = 2 * src.numel() * 4  # each byte read once and written once
    print(f"[flops] device-to-device copy of {src.numel() * 4 / 2**30:.0f} GiB (CUDA events, "
          f"{reps} copies): {ms:.4f} ms a copy = {moved / ms / 1e9:.4f} TB/s read + write, "
          f"beside the datasheet HBM3 {flops.device_hbm_bw() / 1e12:.2f} TB/s "
          f"({card_name}; nvidia-smi: {smi})")
    del src, dst
    torch.cuda.empty_cache()


TRAIN_SPLITS = {"train": 96, "val": 64, "test": 64}
# the reference's big sweep config (bench.py's big=True legs), log-mel
# cached per split as the bench's big-config leg runs it
BIG = ["model.frontend.audio=logmel", "model.frontend.cache=true",
       "model.output_dim=256", "model.hidden_dim=512",
       "model.encoders.audio.hidden_dim=512", "model.encoders.audio.num_layers=3",
       "model.encoders.video.hidden_dim=512"]
# the JAX package's GRU bench leg (bench.py's encoder="gru" at b32, log-mel
# cached per split): log-mel 64 -> GRU 2x256 -> Dense 128
GRU = ["model.frontend.audio=logmel", "model.frontend.cache=true",
       "model.encoders.audio.encoder_type=gru"]
# the big sweep config with the GRU encoder that configs/base.yaml:46
# offers: log-mel 64 -> GRU 3x512 -> Dense 256, the one-layer GRU kernels
BIG_GRU = BIG + ["model.encoders.audio.encoder_type=gru"]
# the JAX package's transformer bench leg (bench.py's encoder="transformer"
# at b32, log-mel cached per split; float32 here): log-mel 64 -> Dense 256
# + positions -> 2 post-LN blocks (4 heads of 64, FFN 1024) -> mean -> 128
TRANSFORMER = ["model.frontend.audio=logmel", "model.frontend.cache=true",
               "model.encoders.audio.encoder_type=transformer"]
# the transformer leg with both encoders in bf16 (the JAX factory's
# per-encoder dtype override): bf16 attention through the flash kernels'
# bf16 forms and a bf16 frame MLP, the head float32
TRANSFORMER_BF16 = TRANSFORMER + ["model.encoders.audio.dtype=bfloat16",
                                  "model.encoders.video.dtype=bfloat16"]
# runtime.compute_dtype=bfloat16: the model's compute dtype, as the JAX
# bench legs run it (bench.py's flagship at b256, the transformer leg at
# b32, the big config at b256); every encoder, the fusion and the head in
# bf16 over float32 parameters, the recurrent kernels on bf16-rounded
# operands
HALF_COMPUTE = ["runtime.compute_dtype=bfloat16"]
# the path whose run gives each kernel's "launches": the training path of
# the slice that ported it
MAIN_PATH = {"logmel": "train", "lstm2_infer": "train", "lstm2_train_fwd": "train",
             "lstm2_bwd_chain": "train", "lstm2_train_fwd_nogates": "train_remat",
             "lstm2_bwd_chain_remat": "train_remat", "lstm1_train_fwd": "train_big",
             "lstm1_infer": "train_big", "lstm_bwd_chain": "train_big",
             "gru2_infer": "train_gru", "gru2_train_fwd": "train_gru",
             "gru2_bwd_chain": "train_gru", "gru1_train_fwd": "train_big_gru",
             "gru1_infer": "train_big_gru", "gru_bwd_chain": "train_big_gru",
             "flash_fwd": "train_tf",
             "flash_bwd_fused": "train_tf", "flash_bwd_dkv": "flash_long",
             "flash_bwd_dq": "flash_long",
             "lstm2_train_fwd_legacy": "train_legacy",
             "lstm2_bwd_chain_legacy": "train_legacy",
             "gru2_train_fwd_legacy": "train_gru_legacy",
             "gru2_bwd_chain_legacy": "train_gru_legacy",
             "lstm2_train_fwd_bf16": "train_fast", "lstm2_bwd_chain_bf16": "train_fast",
             "gru2_train_fwd_bf16": "train_gru_fast", "gru2_bwd_chain_bf16": "train_gru_fast",
             "lstm1_train_fwd_bf16": "train_big_fast",
             "lstm_bwd_chain_bf16": "train_big_fast",
             "lstm2_train_fwd_nogates_bf16": "train_fast_remat",
             "lstm2_bwd_chain_remat_bf16": "train_fast_remat",
             "flash_fwd_bf16": "train_tf_bf16", "flash_bwd_fused_bf16": "train_tf_bf16",
             "flash_bwd_dkv_bf16": "flash_long_bf16", "flash_bwd_dq_bf16": "flash_long_bf16"}


# wall seconds of each phase
PHASE_S = {}


def timed(fn, *args, name=None, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds printed and kept in
    ``PHASE_S`` under ``name`` (by default the first string argument: the
    path's tag)."""
    if name is None:
        name = next(a for a in args if isinstance(a, str))
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_S[name] = time.perf_counter() - t0
        print(f"[time] {name}: {PHASE_S[name]:.1f} s")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA card")
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from multimodal_emotion_detection_tpu_torch.ops import _build, logmel, lstm_kernel
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {card_name}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")

    t0 = time.perf_counter()
    reports = _build.build(["logmel", "lstm2_infer", "lstm2_train_fwd",
                            "lstm2_train_fwd_legacy", "lstm2_bwd_chain",
                            "lstm2_bwd_chain_legacy", "lstm2_bwd_chain_remat",
                            "lstm1_fwd", "lstm_bwd_chain",
                            "gru2_infer", "gru2_train_fwd", "gru2_train_fwd_legacy",
                            "gru2_bwd_chain", "gru2_bwd_chain_legacy",
                            "gru1_fwd", "gru_bwd_chain", "flash_fwd", "flash_bwd_dq",
                            "flash_bwd_fused", "flash_fwd_bf16", "flash_bwd_bf16"])
    print(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'nothing (cached)'}")
    for src, log in reports.items():
        for line in log.splitlines():
            # ptxas's spill counts come on lines of their own, without its name
            if "ptxas" in line or "spill" in line:
                print(f"[build:{src}] {line.strip()}")

    counters = {"logmel": logmel.LOGMEL, "lstm2_infer": lstm_kernel.LSTM2_INFER,
                "lstm2_train_fwd": lstm_kernel.LSTM2_TRAIN_FWD,
                "lstm2_bwd_chain": lstm_kernel.LSTM2_BWD_CHAIN,
                "lstm2_train_fwd_nogates": lstm_kernel.LSTM2_TRAIN_FWD_NOGATES,
                "lstm2_bwd_chain_remat": lstm_kernel.LSTM2_BWD_CHAIN_REMAT,
                "lstm1_train_fwd": lstm_kernel.LSTM1_TRAIN_FWD,
                "lstm1_infer": lstm_kernel.LSTM1_INFER,
                "lstm_bwd_chain": lstm_kernel.LSTM_BWD_CHAIN,
                "gru2_infer": lstm_kernel.GRU2_INFER,
                "gru2_train_fwd": lstm_kernel.GRU2_TRAIN_FWD,
                "gru2_bwd_chain": lstm_kernel.GRU2_BWD_CHAIN,
                "gru1_train_fwd": lstm_kernel.GRU1_TRAIN_FWD,
                "gru1_infer": lstm_kernel.GRU1_INFER,
                "gru_bwd_chain": lstm_kernel.GRU_BWD_CHAIN,
                "flash_fwd": fa.FLASH_FWD, "flash_bwd_fused": fa.FLASH_BWD_FUSED,
                "flash_bwd_dkv": fa.FLASH_BWD_DKV, "flash_bwd_dq": fa.FLASH_BWD_DQ,
                "lstm2_train_fwd_legacy": lstm_kernel.LSTM2_TRAIN_FWD_LEGACY,
                "lstm2_bwd_chain_legacy": lstm_kernel.LSTM2_BWD_CHAIN_LEGACY,
                "gru2_train_fwd_legacy": lstm_kernel.GRU2_TRAIN_FWD_LEGACY,
                "gru2_bwd_chain_legacy": lstm_kernel.GRU2_BWD_CHAIN_LEGACY,
                "lstm2_train_fwd_bf16": lstm_kernel.LSTM2_TRAIN_FWD_BF16,
                "lstm2_bwd_chain_bf16": lstm_kernel.LSTM2_BWD_CHAIN_BF16,
                "gru2_train_fwd_bf16": lstm_kernel.GRU2_TRAIN_FWD_BF16,
                "gru2_bwd_chain_bf16": lstm_kernel.GRU2_BWD_CHAIN_BF16,
                "lstm1_train_fwd_bf16": lstm_kernel.LSTM1_TRAIN_FWD_BF16,
                "lstm_bwd_chain_bf16": lstm_kernel.LSTM_BWD_CHAIN_BF16,
                "lstm2_train_fwd_nogates_bf16": lstm_kernel.LSTM2_TRAIN_FWD_NOGATES_BF16,
                "lstm2_bwd_chain_remat_bf16": lstm_kernel.LSTM2_BWD_CHAIN_REMAT_BF16,
                "flash_fwd_bf16": fa.FLASH_FWD_BF16,
                "flash_bwd_fused_bf16": fa.FLASH_BWD_FUSED_BF16,
                "flash_bwd_dkv_bf16": fa.FLASH_BWD_DKV_BF16,
                "flash_bwd_dq_bf16": fa.FLASH_BWD_DQ_BF16}
    # the raw phases' plain versions run on the CPU beside the card, one
    # worker process a job (RAW_JOBS); every worker is stopped on the way out
    pool = multiprocessing.get_context("spawn").Pool(len(RAW_JOBS))
    try:
        pending = {job: pool.apply_async(_raw_plain_job, (job,)) for job in RAW_JOBS}
        _run_phases(counters, pending, card_name, t_start)
    finally:
        pool.terminate()
        pool.join()


def _run_phases(counters, pending, card_name: str, t_start: float) -> None:
    from multimodal_emotion_detection_tpu_torch.ops import logmel, lstm_kernel, lstm_vjp
    from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa
    from multimodal_emotion_detection_tpu_torch.training.loop import FRONTEND_CHUNK

    flush = L2Flush()
    kernels = {"logmel": timed(phase_logmel, logmel, flush, name="logmel"),
               "lstm2_infer": timed(phase_lstm, lstm_kernel, flush, name="lstm2_infer")}
    by_path = {"serve": timed(phase_serve, counters, name="serve")}
    # a reference checkpoint imported and served (base.yaml as written, row
    # 2 on [serve]'s clips), and the flagship on raw 1280x720 frames
    by_path["import_ref"] = timed(phase_import_ref, counters, name="import_ref")
    by_path["serve_resize"] = timed(phase_serve_resize, counters, name="serve_resize")
    kernels["lstm2_train_fwd"], train_inputs = timed(phase_lstm2_train_fwd, lstm_kernel, flush,
                                                             name="lstm2_train_fwd")
    kernels["lstm2_bwd_chain"] = timed(phase_lstm2_bwd_chain, lstm_kernel, lstm_vjp, flush,
                                      train_inputs, name="lstm2_bwd_chain")
    del train_inputs
    timed(phase_lstm2_train_fwd_b320, lstm_kernel, flush, kernels["lstm2_train_fwd"],
          name="lstm2_train_fwd b320")
    kernels["lstm2_train_fwd_nogates"], kernels["lstm2_bwd_chain_remat"] = (
        timed(phase_lstm2_remat, lstm_kernel, lstm_vjp, flush, name="lstm2_remat"))
    kernels["lstm2_train_fwd_legacy"], kernels["lstm2_bwd_chain_legacy"] = (
        timed(phase_lstm2_legacy, lstm_kernel, lstm_vjp, flush, name="lstm2_legacy"))
    (kernels["lstm1_train_fwd"], kernels["lstm1_infer"],
     layer_inputs) = timed(phase_lstm1_train_fwd, lstm_kernel, flush,
                            name="lstm1_train_fwd")
    kernels["lstm_bwd_chain"] = timed(phase_lstm_bwd_chain, lstm_kernel, lstm_vjp, flush,
                                     layer_inputs, name="lstm_bwd_chain")
    del layer_inputs
    kernels["gru2_infer"] = timed(phase_gru2_infer, lstm_kernel, flush, name="gru2_infer")
    kernels["gru2_train_fwd"], gru_inputs = timed(phase_gru2_train_fwd, lstm_kernel, flush,
                                                         name="gru2_train_fwd")
    kernels["gru2_bwd_chain"] = timed(phase_gru2_bwd_chain, lstm_kernel, lstm_vjp, flush,
                                     gru_inputs, name="gru2_bwd_chain")
    del gru_inputs
    kernels["gru2_train_fwd_legacy"], kernels["gru2_bwd_chain_legacy"] = (
        timed(phase_gru2_legacy, lstm_kernel, lstm_vjp, flush, name="gru2_legacy"))
    (kernels["gru1_train_fwd"], kernels["gru1_infer"],
     gru_layer_inputs) = timed(phase_gru1_train_fwd, lstm_kernel, flush,
                                name="gru1_train_fwd")
    kernels["gru_bwd_chain"] = timed(phase_gru_bwd_chain, lstm_kernel, lstm_vjp, flush,
                                   gru_layer_inputs, name="gru_bwd_chain")
    del gru_layer_inputs
    kernels["flash_fwd"], kernels["flash_bwd_fused"] = timed(phase_flash, fa, flush, name="flash")
    by_path["flash_long"], (kernels["flash_bwd_dkv"], kernels["flash_bwd_dq"]) = (
        timed(phase_flash_long, fa, counters, flush, name="flash_long"))
    kernels["flash_fwd_bf16"], kernels["flash_bwd_fused_bf16"] = timed(
        phase_flash_bf16, fa, flush, name="flash_bf16")
    by_path["flash_long_bf16"], (kernels["flash_bwd_dkv_bf16"],
                                 kernels["flash_bwd_dq_bf16"]) = timed(
        phase_flash_long_bf16, fa, counters, flush, name="flash_long_bf16")
    # configs/base.yaml as written: the raw waveform's 48,000 steps through
    # the pairs and the one-layer cores
    timed(phase_pair_raw, lstm_kernel, flush, kernels, "lstm", pending, name="lstm_raw")
    timed(phase_pair_raw, lstm_kernel, flush, kernels, "gru", pending, name="gru_raw")
    timed(phase_lstm1_raw, lstm_kernel, lstm_vjp, flush, kernels, pending, name="lstm1_raw")
    # the bf16 residual streams' forms of rows 11 / 12, 14 / 15 and 6 / 4
    t_half = time.perf_counter()
    for phase in (phase_lstm2_res_bf16, phase_gru2_res_bf16, phase_lstm1_res_bf16):
        kernels.update({k["name"]: k for k in timed(
            phase, lstm_kernel, flush, name=phase.__name__[len("phase_"):])})
    kernels.update({k["name"]: k for k in timed(
        phase_lstm2_remat_bf16, lstm_kernel, lstm_vjp, flush, name="lstm2_remat_bf16")})
    print(f"[time] lstm2_res_bf16, gru2_res_bf16, lstm1_res_bf16, lstm2_remat_bf16: "
          f"{time.perf_counter() - t_half:.1f} s")
    del flush

    def flagship_counts(steps, evals):
        return {"logmel": steps + evals, "lstm2_infer": evals,
                "lstm2_train_fwd": steps, "lstm2_bwd_chain": steps}

    by_path["train"], train_run, train_overrides = timed(phase_train,
        counters, "train", ["model.frontend.audio=logmel"], flagship_counts)
    # the ETL CLIs on written RAVDESS media (host code, no launch), then the
    # flagship trained on the manifest ETL's output
    by_path["etl"], etl_data = timed(phase_etl, counters, name="etl")
    by_path["train_etl"] = timed(phase_train_etl, counters, etl_data, name="train_etl")
    # the streaming monitor on the flagship's seeded checkpoint ([serve]'s)
    by_path["stream"] = timed(phase_stream, counters, WORK / "flagship_seed0.pt",
                              name="stream")
    # synthetic data at the flagship's recurrent width: trained resident,
    # then host-streamed with the epoch trace, served and debugged
    by_path["train_synthetic"], syn_run, syn_overrides, syn_results = timed(
        phase_train_synthetic, counters, "train_synthetic")
    by_path["train_synthetic_stream"] = timed(
        phase_train_synthetic_stream, counters, syn_results, syn_run,
        name="train_synthetic_stream")
    by_path["serve_synthetic"] = timed(phase_serve_synthetic, counters,
                                       syn_run / "best.ckpt", syn_overrides,
                                       name="serve_synthetic")
    by_path["debug"] = timed(phase_debug, counters, name="debug")
    # the flagship with its gates rematerialised: the no-gates forward and
    # the remat chain per step, the stored-gates pair never
    by_path["train_remat"] = timed(phase_train,
        counters, "train_remat", ["model.frontend.audio=logmel",
                                  "runtime.lstm_remat_gates=true"],
        lambda steps, evals: {"logmel": steps + evals, "lstm2_infer": evals,
                              "lstm2_train_fwd_nogates": steps,
                              "lstm2_bwd_chain_remat": steps})[0]
    # the flagship on the legacy-layout pair (the JAX package's
    # set_res2_mode("off"), a module global with no config key): its two
    # kernels per step, the residual-native and remat pairs never
    prev = lstm_vjp.set_res2_mode("off")
    try:
        by_path["train_legacy"] = timed(phase_train,
            counters, "train_legacy", ["model.frontend.audio=logmel"],
            lambda steps, evals: {"logmel": steps + evals, "lstm2_infer": evals,
                                  "lstm2_train_fwd_legacy": steps,
                                  "lstm2_bwd_chain_legacy": steps})[0]
    finally:
        lstm_vjp.set_res2_mode(prev)
    # the fusion library's configs as written, both on the flagship's audio
    # path (log-mel inside every step, LSTM 2x256): the pair per step, the
    # eval form per eval or served batch; the CPU side of each step check
    # takes 4 clips
    t_fusion = time.perf_counter()
    test = WORK / "train_data" / "test"
    test_audio, test_video = np.load(test / "audio.npy"), np.load(test / "video.npy")
    batches = TRAIN_SPLITS["test"] // 32
    served = {"logmel": batches, "lstm2_infer": batches}
    fusion = dict(check_clips=4, reps=30, profile_reps=5)
    by_path["train_hybrid"], hyb_run, hyb_overrides = timed(phase_train,
        counters, "train_hybrid", [], flagship_counts, config="av_hybrid.yaml", **fusion)
    by_path["serve_hybrid"] = timed(serve_path,
        "serve_hybrid", counters, served, hyb_run / "best.ckpt", hyb_overrides,
        test_audio, test_video, WORK / "predictions_hybrid", config="av_hybrid.yaml")
    # uncertainty fusion: the calibration report in place of best.ckpt and
    # results.json, so the trainer's best checkpoint is served
    experiments = WORK / "unc_experiments"
    by_path["train_unc"], unc_run, unc_overrides = timed(phase_train,
        counters, "train_unc", [f"outputs.experiments_dir={experiments}"],
        flagship_counts, config="uncertainty.yaml",
        artifacts=TRAIN_ARTIFACTS[2:], **fusion)
    report = experiments / "uncertainty.json"
    if (not report.exists() or (unc_run / "best.ckpt").exists()
            or (unc_run / "results.json").exists()):
        raise RuntimeError("train_unc: no uncertainty.json, or best.ckpt / results.json")
    print(f"[train_unc] {report.relative_to(WORK)}: "
          f"{json.dumps(json.loads(report.read_text()))}")
    (unc_best,) = (unc_run / "checkpoints").glob("epoch=*-val_loss=*.ckpt")
    by_path["serve_unc"] = timed(serve_path,
        "serve_unc", counters, served, unc_best, unc_overrides, test_audio,
        test_video, WORK / "predictions_unc", config="uncertainty.yaml")
    by_path["mc_dropout"] = timed(phase_mc_dropout,
        counters, "mc_dropout", unc_best, unc_overrides, 10, test_audio, test_video,
        WORK / "predictions_mc", "uncertainty.yaml")
    print(f"[time] train_hybrid, serve_hybrid, train_unc, serve_unc, mc_dropout: "
          f"{time.perf_counter() - t_fusion:.1f} s")
    # the unimodal configs as written (BASELINE.json configs 1 and 2):
    # audio_only.yaml, log-mel inside every step -> the CNN with BatchNorm
    # (cuDNN convolutions, no recurrent kernel), also with the MLP encoder;
    # video_only.yaml, the frame encoder alone, which runs no kernel of the
    # port; the card step is held to the CPU's on the whole batch, the
    # audio configs' to the exact step (kinked_step_check)
    t_uni = time.perf_counter()

    def logmel_counts(steps, evals):
        return {"logmel": steps + evals}

    by_path["train_audio_only"], ao_run, ao_overrides = timed(phase_train,
        counters, "train_audio_only", [], logmel_counts, config="audio_only.yaml",
        kinked=True)
    by_path["serve_audio_only"] = timed(serve_path,
        "serve_audio_only", counters, {"logmel": batches}, ao_run / "best.ckpt",
        ao_overrides, test_audio, test_video, WORK / "predictions_audio_only",
        config="audio_only.yaml")
    by_path["train_video_only"], vo_run, vo_overrides = timed(phase_train,
        counters, "train_video_only", [], lambda steps, evals: {},
        config="video_only.yaml")
    by_path["serve_video_only"] = timed(serve_path,
        "serve_video_only", counters, {}, vo_run / "best.ckpt", vo_overrides,
        test_audio, test_video, WORK / "predictions_video_only", config="video_only.yaml")
    by_path["train_mlp"] = timed(phase_train,
        counters, "train_mlp", ["model.encoders.audio.type=mlp"], logmel_counts,
        config="audio_only.yaml", kinked=True)[0]
    by_path["mc_dropout_cnn"] = timed(phase_mc_dropout,
        counters, "mc_dropout_cnn", ao_run / "best.ckpt", ao_overrides, 10, test_audio,
        test_video, WORK / "predictions_mc_cnn", "audio_only.yaml",
        expected_per_batch={"logmel": 1})
    print(f"[time] train_audio_only, serve_audio_only, train_video_only, "
          f"serve_video_only, train_mlp, mc_dropout_cnn: "
          f"{time.perf_counter() - t_uni:.1f} s")
    # the big config caches log-mel once per split, in chunks
    cached = sum(-(-n // FRONTEND_CHUNK) for n in TRAIN_SPLITS.values())
    # configs/fast.yaml as written (av_hybrid.yaml with log-mel cached per
    # split and bf16 residual streams; it validates at the last of the 2
    # epochs only): the pair's bf16 forms per step, its eval form per eval
    # or served batch; then the GRU config and the big config with bf16
    # streams.  Each card step is held to the CPU's to 1e-3 of the largest
    # gradient (bf16 rounds float32 values that differ by ~1e-7 on the two
    # sides to different ulps) and told apart from the float32-stream step
    t_fast = time.perf_counter()
    half = ["runtime.lstm_residual_dtype=bfloat16"]
    by_path["train_fast"], fast_run, fast_overrides = timed(phase_train,
        counters, "train_fast", [],
        lambda steps, evals: {"logmel": cached, "lstm2_infer": evals,
                              "lstm2_train_fwd_bf16": steps, "lstm2_bwd_chain_bf16": steps},
        config="fast.yaml", grad_bound=1e-3, contrast_f32=True, **fusion)
    by_path["serve_fast"] = timed(serve_path,
        "serve_fast", counters, served, fast_run / "best.ckpt", fast_overrides,
        test_audio, test_video, WORK / "predictions_fast", config="fast.yaml")
    (p50, busy, peak), (p50_h, busy_h, peak_h) = STEPS["train_fast"], STEPS["train_hybrid"]
    print(f"[train_fast] train step p50 {p50:.4f} ms, device busy "
          f"{100 * busy if busy else float('nan'):.1f}%, peak allocated {peak:.4f} GB; "
          f"[train_hybrid] (float32 streams, log-mel in the step) in the same call: p50 "
          f"{p50_h:.4f} ms, busy {100 * busy_h if busy_h else float('nan'):.1f}%, peak "
          f"{peak_h:.4f} GB")
    # the same with the gates rematerialised: the remat pair's bf16 forms
    # per step and never a float32 or stored-gates pair; the card step also
    # beside [train_fast]'s on the same batch and masks
    by_path["train_fast_remat"], fast_remat_run, fast_remat_overrides = timed(phase_train,
        counters, "train_fast_remat", ["runtime.lstm_remat_gates=true"],
        lambda steps, evals: {"logmel": cached, "lstm2_infer": evals,
                              "lstm2_train_fwd_nogates_bf16": steps,
                              "lstm2_bwd_chain_remat_bf16": steps},
        config="fast.yaml", grad_bound=1e-3, contrast_f32=True, contrast_stored=True,
        **fusion)
    by_path["serve_fast_remat"] = timed(serve_path,
        "serve_fast_remat", counters, served, fast_remat_run / "best.ckpt",
        fast_remat_overrides, test_audio, test_video, WORK / "predictions_fast_remat",
        config="fast.yaml")
    (p50_r, busy_r, peak_r) = STEPS["train_fast_remat"]
    print(f"[train_fast_remat] train step p50 {p50_r:.4f} ms, device busy "
          f"{100 * busy_r if busy_r else float('nan'):.1f}%, peak allocated {peak_r:.4f} GB "
          f"([train_fast] {p50:.4f} ms, {peak:.4f} GB in the same call)")
    # the whole batch on both sides: at 4 clips the GRU's card-vs-CPU gap
    # (bf16 rounding the two sides' ~1e-7 apart float32 values to other
    # ulps, averaged over 4 clips) reaches 1e-4 of the largest gradient,
    # as far as the float32-stream step is from the bf16 one
    half_paths = dict(grad_bound=1e-3, contrast_f32=True, reps=20, profile_reps=3)
    by_path["train_gru_fast"] = timed(phase_train,
        counters, "train_gru_fast", GRU + half,
        lambda steps, evals: {"logmel": cached, "gru2_infer": evals,
                              "gru2_train_fwd_bf16": steps, "gru2_bwd_chain_bf16": steps},
        **half_paths)[0]
    by_path["train_big_fast"] = timed(phase_train,
        counters, "train_big_fast", BIG + half,
        lambda steps, evals: {"logmel": cached, "lstm1_train_fwd_bf16": 3 * steps,
                              "lstm_bwd_chain_bf16": 3 * steps, "lstm1_infer": 3 * evals},
        **half_paths)[0]
    print(f"[time] train_fast, serve_fast, train_fast_remat, serve_fast_remat, "
          f"train_gru_fast, train_big_fast: "
          f"{time.perf_counter() - t_fast:.1f} s")
    by_path["train_big"], big_run, big_overrides = timed(phase_train,
        counters, "train_big", BIG,
        lambda steps, evals: {"logmel": cached, "lstm1_train_fwd": 3 * steps,
                              "lstm_bwd_chain": 3 * steps, "lstm1_infer": 3 * evals})
    by_path["serve_big"] = timed(serve_path,
        "serve_big", counters, {"logmel": batches, "lstm1_infer": 3 * batches},
        big_run / "best.ckpt", big_overrides, test_audio,
        test_video, WORK / "predictions_big")
    by_path["train_gru"], gru_run, gru_overrides = timed(phase_train,
        counters, "train_gru", GRU,
        lambda steps, evals: {"logmel": cached, "gru2_train_fwd": steps,
                              "gru2_bwd_chain": steps, "gru2_infer": evals})
    by_path["serve_gru"] = timed(serve_path,
        "serve_gru", counters, {"logmel": batches, "gru2_infer": batches},
        gru_run / "best.ckpt", gru_overrides, test_audio,
        test_video, WORK / "predictions_gru")
    # the GRU config on the legacy-layout pair with the fused legacy chain
    # (the JAX package's GRU_BWD2_ENABLED, which its TPU default leaves off)
    prev = lstm_vjp.set_res2_mode("off")
    prev_bwd2, lstm_vjp.GRU_BWD2_ENABLED = lstm_vjp.GRU_BWD2_ENABLED, True
    try:
        by_path["train_gru_legacy"] = timed(phase_train,
            counters, "train_gru_legacy", GRU,
            lambda steps, evals: {"logmel": cached, "gru2_infer": evals,
                                  "gru2_train_fwd_legacy": steps,
                                  "gru2_bwd_chain_legacy": steps})[0]
    finally:
        lstm_vjp.set_res2_mode(prev)
        lstm_vjp.GRU_BWD2_ENABLED = prev_bwd2
    print("[train_legacy] [train_gru_legacy] not served again: the eval forward "
          "ignores the route, as the JAX package's does ([serve], [serve_gru])")
    # the big config's depth with the GRU: 3 one-layer GRU launches per
    # step, per eval batch and per served batch; the pair never
    by_path["train_big_gru"], big_gru_run, big_gru_overrides = timed(phase_train,
        counters, "train_big_gru", BIG_GRU,
        lambda steps, evals: {"logmel": cached, "gru1_train_fwd": 3 * steps,
                              "gru_bwd_chain": 3 * steps, "gru1_infer": 3 * evals})
    by_path["serve_big_gru"] = timed(serve_path,
        "serve_big_gru", counters, {"logmel": batches, "gru1_infer": 3 * batches},
        big_gru_run / "best.ckpt", big_gru_overrides, test_audio,
        test_video, WORK / "predictions_big_gru")
    # two blocks: one flash forward each per forward, one fused backward
    # each per train step
    by_path["train_tf"], tf_run, tf_overrides = timed(phase_train,
        counters, "train_tf", TRANSFORMER,
        lambda steps, evals: {"logmel": cached, "flash_fwd": 2 * (steps + evals),
                              "flash_bwd_fused": 2 * steps})
    by_path["serve_tf"] = timed(serve_path,
        "serve_tf", counters, {"logmel": batches, "flash_fwd": 2 * batches},
        tf_run / "best.ckpt", tf_overrides, test_audio,
        test_video, WORK / "predictions_tf")
    # the same with both encoders in bf16: the flash kernels' bf16 forms
    # (and no float32 form), the card step held by the bf16 step rule, the
    # served logits to 4 bf16 ulps of the largest
    by_path["train_tf_bf16"], tfh_run, tfh_overrides = timed(phase_train,
        counters, "train_tf_bf16", TRANSFORMER_BF16,
        lambda steps, evals: {"logmel": cached, "flash_fwd_bf16": 2 * (steps + evals),
                              "flash_bwd_fused_bf16": 2 * steps},
        half_encoders=True, reps=30, profile_reps=5)
    by_path["serve_tf_bf16"] = timed(serve_path,
        "serve_tf_bf16", counters, {"logmel": batches, "flash_fwd_bf16": 2 * batches},
        tfh_run / "best.ckpt", tfh_overrides, test_audio, test_video,
        WORK / "predictions_tf_bf16", reps=50, profile_reps=5, logit_ulps=4)
    (p50, busy, peak), (p50_f, busy_f, peak_f) = STEPS["train_tf_bf16"], STEPS["train_tf"]
    print(f"[train_tf_bf16] train step p50 {p50:.4f} ms, device busy "
          f"{100 * busy if busy else float('nan'):.1f}%, peak allocated {peak:.4f} GB; "
          f"[train_tf] (float32) in the same call: p50 {p50_f:.4f} ms, busy "
          f"{100 * busy_f if busy_f else float('nan'):.1f}%, peak {peak_f:.4f} GB")
    # the bf16 compute dtype (runtime.compute_dtype=bfloat16) on the
    # flagship, the GRU, the transformer and audio_only.yaml's CNN (its
    # per-encoder dtype: bfloat16) at b32, and the two b256 bench legs: the
    # same kernels per step as each float32 path (fed bf16-rounded operands,
    # or the flash kernels' bf16 forms), each card step held by the bf16
    # step rule, the served logits to 4 bf16 ulps of the largest
    t_compute = time.perf_counter()
    by_path["train_bf16"], bf_run, bf_overrides = timed(phase_train,
        counters, "train_bf16", ["model.frontend.audio=logmel", *HALF_COMPUTE],
        flagship_counts, half_encoders=True, reps=30, profile_reps=5)
    by_path["serve_bf16"] = timed(serve_path,
        "serve_bf16", counters, served, bf_run / "best.ckpt", bf_overrides, test_audio,
        test_video, WORK / "predictions_bf16", reps=50, profile_reps=5, logit_ulps=4)
    by_path["train_gru_bf16"] = timed(phase_train,
        counters, "train_gru_bf16", GRU + HALF_COMPUTE,
        lambda steps, evals: {"logmel": cached, "gru2_train_fwd": steps,
                              "gru2_bwd_chain": steps, "gru2_infer": evals},
        half_encoders=True, reps=30, profile_reps=5)[0]
    by_path["train_tf_compute_bf16"], tfc_run, tfc_overrides = timed(phase_train,
        counters, "train_tf_compute_bf16", TRANSFORMER + HALF_COMPUTE,
        lambda steps, evals: {"logmel": cached, "flash_fwd_bf16": 2 * (steps + evals),
                              "flash_bwd_fused_bf16": 2 * steps},
        half_encoders=True, reps=30, profile_reps=5)
    by_path["serve_tf_compute_bf16"] = timed(serve_path,
        "serve_tf_compute_bf16", counters, {"logmel": batches, "flash_fwd_bf16": 2 * batches},
        tfc_run / "best.ckpt", tfc_overrides, test_audio, test_video,
        WORK / "predictions_tf_compute_bf16", reps=50, profile_reps=5, logit_ulps=4)
    by_path["train_audio_only_bf16"] = timed(phase_train,
        counters, "train_audio_only_bf16", ["model.encoders.audio.dtype=bfloat16"],
        logmel_counts, config="audio_only.yaml", half_encoders=True, reps=30,
        profile_reps=5)[0]
    by_path["train_bf16_b256"] = timed(phase_steps_b256,
        counters, "train_bf16_b256", ["model.frontend.audio=logmel", *HALF_COMPUTE],
        lambda steps: {"logmel": steps, "lstm2_train_fwd": steps, "lstm2_bwd_chain": steps})
    by_path["train_big_bf16_b256"] = timed(phase_steps_b256,
        counters, "train_big_bf16_b256", BIG + HALF_COMPUTE,
        lambda steps: {"lstm1_train_fwd": 3 * steps, "lstm_bwd_chain": 3 * steps})
    for tag, f32_tag in (("train_bf16", "train"), ("train_gru_bf16", "train_gru"),
                         ("train_tf_compute_bf16", "train_tf"),
                         ("train_audio_only_bf16", "train_audio_only")):
        (p50, busy, peak), (p50_f, busy_f, peak_f) = STEPS[tag], STEPS[f32_tag]
        print(f"[{tag}] train step p50 {p50:.4f} ms, device busy "
              f"{100 * busy if busy else float('nan'):.1f}%, peak allocated {peak:.4f} GB; "
              f"[{f32_tag}] (float32) in the same call: p50 {p50_f:.4f} ms, busy "
              f"{100 * busy_f if busy_f else float('nan'):.1f}%, peak {peak_f:.4f} GB")
    for tag, f32_tag in (("serve_bf16", "serve"), ("serve_tf_compute_bf16", "serve_tf")):
        print(f"[{tag}] forward p50 b32 {SERVES[tag]['b32']:.4f} ms, b1 "
              f"{SERVES[tag]['b1']:.4f} ms; [{f32_tag}] (float32) in the same call: b32 "
              f"{SERVES[f32_tag]['b32']:.4f} ms, b1 {SERVES[f32_tag]['b1']:.4f} ms")
    print(f"[time] train_bf16, serve_bf16, train_gru_bf16, train_tf_compute_bf16, "
          f"serve_tf_compute_bf16, train_audio_only_bf16, train_bf16_b256, "
          f"train_big_bf16_b256: {time.perf_counter() - t_compute:.1f} s")
    # tools.export on six trained checkpoints at b32: the loaded program
    # launches the eager forward's kernels (log-mel once, then rows 2, 3,
    # 3 x 6e, 3 x 7e, 2 x 16 or 2 x 16b) and gives its logits bit for bit
    t_export = time.perf_counter()
    for tag, run, run_overrides, expected in (
            ("export", train_run, train_overrides, {"logmel": 1, "lstm2_infer": 1}),
            ("export_gru", gru_run, gru_overrides, {"logmel": 1, "gru2_infer": 1}),
            ("export_big", big_run, big_overrides, {"logmel": 1, "lstm1_infer": 3}),
            ("export_big_gru", big_gru_run, big_gru_overrides, {"logmel": 1, "gru1_infer": 3}),
            ("export_tf", tf_run, tf_overrides, {"logmel": 1, "flash_fwd": 2}),
            ("export_tf_compute_bf16", tfc_run, tfc_overrides,
             {"logmel": 1, "flash_fwd_bf16": 2})):
        by_path[tag] = timed(phase_export, counters, tag, run / "best.ckpt", run_overrides,
                             expected, fresh=tag == "export")
    print(f"[time] export, export_gru, export_big, export_big_gru, export_tf, "
          f"export_tf_compute_bf16: {time.perf_counter() - t_export:.1f} s")
    # configs/base.yaml as written (raw waveform, LSTM 2x256) and with the
    # GRU: the pair once per step, its eval form once per eval or served
    # batch, no log-mel; a step takes ~0.6 s, so fewer timed reps, and the
    # CPU side of each check takes 4 clips
    raw = dict(check_clips=4, reps=10, profile_reps=3)
    for cell, suffix, overrides in (("lstm", "", []),
                                    ("gru", "_gru", ["model.encoders.audio.encoder_type=gru"])):
        by_path[f"train_raw{suffix}"], raw_run, raw_overrides = timed(phase_train,
            counters, f"train_raw{suffix}", overrides,
            lambda steps, evals, c=cell: {f"{c}2_train_fwd": steps,
                                          f"{c}2_bwd_chain": steps, f"{c}2_infer": evals},
            **raw)
        by_path[f"serve_raw{suffix}"] = timed(serve_path,
            f"serve_raw{suffix}", counters, {f"{cell}2_infer": batches},
            raw_run / "best.ckpt", raw_overrides, test_audio,
            test_video, WORK / f"predictions_raw{suffix}", **raw)

    # the serving and sweep tools: int8 serving artifacts and quantized
    # predict on [train]'s flagship checkpoint, the step-major sweep of the
    # flagship, the attention heatmap of [train_hybrid]'s checkpoint
    t_tools = time.perf_counter()
    by_path["quantize"] = timed(phase_quantize, counters, train_run / "best.ckpt",
                                train_overrides, test_audio, test_video, name="quantize")
    by_path["quantize_gru"] = timed(quantized_serve, counters, "quantize_gru",
        gru_run / "best.ckpt", gru_overrides, {"logmel": batches, "gru2_infer": batches},
        test_audio, test_video)
    by_path["quantize_tf"] = timed(quantized_serve, counters, "quantize_tf",
        tf_run / "best.ckpt", tf_overrides, {"logmel": batches, "flash_fwd": 2 * batches},
        test_audio, test_video)
    by_path["sweep"] = timed(phase_sweep, counters, STEPS["train"][0], name="sweep")
    by_path["visualize"] = timed(phase_visualize, counters, hyb_run / "best.ckpt",
                                 hyb_overrides, test_audio, test_video, name="visualize")
    print(f"[time] quantize, sweep, visualize: {time.perf_counter() - t_tools:.1f} s")
    # the analytic FLOPs of every trained configuration against the card's
    # datasheet peaks, and the copy bandwidth beside the datasheet HBM's
    timed(phase_flops, card_name, name="flops")

    # launches: the run of the path that MAIN_PATH names; launches_by_path:
    # every path's own run, the counts zeroed just before it
    for name, kern in kernels.items():
        kern["launches_by_path"] = {path: counts[name] for path, counts in by_path.items()}
        kern["launches"] = kern["launches_by_path"][MAIN_PATH[name]]
        if kern["launches"] < 1:
            raise RuntimeError(f"{name} never launched on the {MAIN_PATH[name]} path")
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "launches_by_path"]
    # the header of a shared core beside its source; the tensor-core
    # kernels give both bounds beside bound_ms; log-mel its B=1 times and
    # the products' bound; the recurrent kernels of base.yaml's raw path
    # their error, times and bound at T=48,000; the bf16 flash forward and
    # fused backward their time and SDPA's at dropout rate 0 (ms and
    # library_ms are at 0.1)
    extra = ["core", "bound_fp32_ms", "bound_3xtf32_ms", "b1_ms", "b1_plain_ms",
             "bound_products_ms", "raw_max_abs_err", "raw_ms", "raw_plain_ms",
             "raw_plain_rows", "raw_bound_ms", "raw_bound_by", "raw_library_ms", "b320_max_err_of_largest",
             "b320_ms", "b320_bound_ms", "b320_library_ms", "f32_ms", "rate0_ms",
             "rate0_library_ms"]
    print(f"[time] every phase, longest first: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(PHASE_S.items(), key=lambda kv: -kv[1])))
    print(f"[time] chip_smoke.py: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {**{k: kern[k] for k in order}, **{k: kern[k] for k in extra if k in kern}}
        for kern in kernels.values()]}))
    print(nvidia_smi())  # the card's name and power limit, as nvidia-smi says
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
