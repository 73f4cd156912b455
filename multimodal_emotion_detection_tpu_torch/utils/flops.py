"""Analytic FLOPs per clip for the classifier, and the H100's peaks.

Counts *matmul* FLOPs (2 x MAC) for every component on the training path:
audio frontend (STFT-as-matmul + mel), sequence encoders (LSTM / GRU gate
matmuls, CNN convs, transformer blocks), frame / MLP encoders, and the
concat head.  Elementwise work (gate nonlinearities, softmax, norm) is
excluded: it is bandwidth-bound and belongs to the bandwidth roofline,
not the compute one.

Training FLOPs use the standard 3x-forward convention (1x forward + 2x
backward for matmul-dominated graphs).  The optimizer update is O(params)
elementwise and excluded.

The counts are the JAX package's ``utils/flops.py`` (framework-independent
arithmetic on the config), equal to it on every config.  Its device
figures are replaced: ``device_peak_flops`` and ``device_hbm_bw`` read the
card's name (``torch.cuda.get_device_name``) and give the NVIDIA H100
SXM5 datasheet figures for the compute dtype; any other card raises.  The
parts of the JAX file that model its TPU or XLA (the compiled programs'
bytes accessed, the occupancy-adjusted ceilings, the training bytes per
clip) are not here (ROADMAP.md item 19).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# NVIDIA H100 SXM5 (80 GB HBM3) datasheet figures: dense tensor-core peaks
# (without sparsity) for bf16 and TF32, the float32 peak outside the
# tensor cores, and the HBM3 bandwidth.  Datasheet figures, not
# measurements of this port.
H100_SXM_PEAK_FLOPS = {
    "bfloat16": 989.4e12,
    "tfloat32": 494.7e12,
    "float32": 66.9e12,
}
H100_SXM_HBM_BYTES_PER_S = 3.35e12


def _is_h100_sxm(name: str) -> bool:
    """The H100 SXM5 names itself "NVIDIA H100 80GB HBM3" (or "... SXM5
    ..."); the PCIe and NVL cards have other peaks."""
    return "H100" in name and ("HBM3" in name or "SXM" in name)


def _card_name(name: Optional[str]) -> str:
    if name is not None:
        return name
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA card: pass the card's name")
    return torch.cuda.get_device_name(0)


def device_peak_flops(compute_dtype: str = "float32",
                      name: Optional[str] = None) -> float:
    """Dense peak FLOP/s of the card (``name``, by default CUDA device 0's)
    for ``compute_dtype``: ``'float32'`` (FP32 outside the tensor cores:
    the port's float32 runs with TF32 off), ``'tfloat32'`` or
    ``'bfloat16'``.  Raises for a card or dtype it does not know."""
    name = _card_name(name)
    if not _is_h100_sxm(name):
        raise ValueError(f"no peak FLOP/s is known for the card {name!r} "
                         "(only the H100 SXM's datasheet figures)")
    if compute_dtype not in H100_SXM_PEAK_FLOPS:
        raise ValueError(f"compute_dtype={compute_dtype!r}: one of "
                         f"{sorted(H100_SXM_PEAK_FLOPS)}")
    return H100_SXM_PEAK_FLOPS[compute_dtype]


def device_hbm_bw(name: Optional[str] = None) -> float:
    """Datasheet HBM bandwidth of the card (``name``, by default CUDA
    device 0's), bytes/s.  Raises for a card it does not know."""
    name = _card_name(name)
    if not _is_h100_sxm(name):
        raise ValueError(f"no HBM bandwidth is known for the card {name!r} "
                         "(only the H100 SXM's datasheet figure)")
    return H100_SXM_HBM_BYTES_PER_S


def logmel_frames(num_samples: int, n_fft: int, hop_length: int) -> int:
    """Frame count of the center-less STFT used by ops/logmel.py."""
    return 1 + (num_samples - n_fft) // hop_length


def _frontend_flops(fe, num_samples: int) -> float:
    """Fused STFT+mel as matmuls: per frame, windowed n_fft samples hit a
    (n_fft, 2*n_bins) DFT basis, then (n_bins, n_mels) mel projection."""
    if fe.audio not in ("logmel", "mfcc"):
        return 0.0
    frames = logmel_frames(num_samples, fe.n_fft, fe.hop_length)
    n_bins = fe.n_fft // 2 + 1
    dft = 2 * fe.n_fft * (2 * n_bins)  # real+imag basis matmul
    mel = 2 * n_bins * fe.n_mels
    per_frame = dft + mel
    if fe.audio == "mfcc":
        per_frame += 2 * fe.n_mels * fe.n_mfcc  # DCT matmul
    return float(frames) * per_frame


def _rnn_flops(T: int, input_dim: int, hidden: int, num_layers: int,
               cell: str) -> float:
    """Gate matmuls: LSTM 4 gates, GRU 3 gates; input + recurrent projections."""
    gates = 4 if cell == "lstm" else 3
    total = 0.0
    d_in = input_dim
    for _ in range(num_layers):
        total += T * 2 * gates * hidden * (d_in + hidden)
        d_in = hidden
    return total


def _transformer_flops(T: int, input_dim: int, hidden: int,
                       num_layers: int) -> float:
    """in-proj + per-block (qkv/out proj, scores, att*V, FFN 4x)."""
    d = hidden
    total = 2 * T * input_dim * d  # input projection
    per_block = (
        2 * T * d * (3 * d)      # qkv projections
        + 2 * T * T * d          # scores QK^T
        + 2 * T * T * d          # attention @ V
        + 2 * T * d * d          # output projection
        + 2 * T * d * (4 * d) * 2  # FFN in+out (dim_feedforward = 4d)
    )
    return total + num_layers * per_block


def _cnn_flops(T: int, input_dim: int, hidden: int) -> float:
    """Conv1d k5 (input->hidden) + Conv1d k3 (hidden->hidden), 'same' pad."""
    return (
        T * 2 * 5 * input_dim * hidden
        + T * 2 * 3 * hidden * hidden
    )


def encoder_forward_flops(enc_cfg: Dict[str, Any], output_dim: int,
                          T: int, input_dim: int) -> float:
    """Per-clip forward matmul FLOPs of one configured encoder."""
    cfg = dict(enc_cfg)
    etype = cfg.get("type", "sequence")
    hidden = cfg.get("hidden_dim") or output_dim * 2
    if etype == "sequence":
        cell = cfg.get("encoder_type", "lstm")
        layers = cfg.get("num_layers", 2)
        if cell in ("lstm", "gru"):
            body = _rnn_flops(T, input_dim, hidden, layers, cell)
        elif cell == "transformer":
            body = _transformer_flops(T, input_dim, hidden, layers)
        elif cell == "cnn":
            body = _cnn_flops(T, input_dim, hidden)
        else:
            raise ValueError(f"Unknown encoder_type {cell!r}")
        return body + 2 * hidden * output_dim  # projection
    if etype == "frame":
        mlp = T * 2 * input_dim * hidden
        att = T * 2 * hidden * 1  # AttentionPool scalar scores
        proj = 2 * hidden * output_dim
        return mlp + att + proj
    if etype == "mlp":
        layers = cfg.get("num_layers", 2)
        total, d_in = 0.0, input_dim
        for _ in range(layers):
            total += 2 * d_in * hidden
            d_in = hidden
        total += 2 * hidden * output_dim
        return T * total if T > 1 else total
    if etype == "pretrained_cnn":
        raise ValueError("pretrained_cnn FLOPs not modeled (the conv "
                         "backbones are not counted, as in the JAX package)")
    raise ValueError(f"Unknown encoder type {etype!r}")


def classifier_flops_per_clip(cfg, audio_samples: int = 48000,
                              video_frames: int = 24) -> Dict[str, float]:
    """Forward/train matmul FLOPs per clip for a Config's flagship model.

    Returns a breakdown dict plus 'forward' and 'train' (= 3x forward for
    everything with parameters; the frontend is parameter-free so its
    backward contributes nothing — and with frontend.cache it amortizes to
    ~0 across an epoch and is excluded entirely).
    """
    fe = cfg.model.frontend
    out_dim = cfg.model.output_dim
    breakdown: Dict[str, float] = {}

    cached = bool(getattr(fe, "cache", False))
    frontend = 0.0 if cached else _frontend_flops(fe, audio_samples)
    if frontend:
        breakdown["frontend"] = frontend

    encoder_total = 0.0
    for name, enc_cfg in dict(cfg.model.encoders).items():
        enc_cfg = dict(enc_cfg)
        if name == "audio":
            if fe.audio == "logmel":
                T = logmel_frames(audio_samples, fe.n_fft, fe.hop_length)
                in_dim = fe.n_mels
            elif fe.audio == "mfcc":
                T = logmel_frames(audio_samples, fe.n_fft, fe.hop_length)
                in_dim = fe.n_mfcc
            else:
                T, in_dim = audio_samples, enc_cfg.get("input_dim", 1)
        elif name == "video":
            T, in_dim = video_frames, enc_cfg.get("input_dim", 4096)
        else:
            T = enc_cfg.get("sequence_length", 1)
            in_dim = enc_cfg.get("input_dim", 64)
        f = encoder_forward_flops(enc_cfg, out_dim, T, in_dim)
        breakdown[f"encoder_{name}"] = f
        encoder_total += f

    n_mod = len(dict(cfg.model.encoders))
    head = (2 * n_mod * out_dim * cfg.model.hidden_dim
            + 2 * cfg.model.hidden_dim * cfg.dataset.num_classes)
    breakdown["head"] = head

    forward = frontend + encoder_total + head
    # frontend has no parameters: backward never revisits it
    train = frontend + 3 * (encoder_total + head)
    return {"forward": forward, "train": train, "breakdown": breakdown}


# SequenceEncoder's learned positional table (models/encoders.py:488)
POS_EMB_MAX_LEN = 4096


def _enc_dims(cfg, name: str, enc_cfg: Dict[str, Any], audio_samples: int,
              video_frames: int) -> tuple:
    """(T, input_dim) an encoder sees under the configured frontend."""
    fe = cfg.model.frontend
    if name == "audio":
        if fe.audio in ("logmel", "mfcc"):
            T = logmel_frames(audio_samples, fe.n_fft, fe.hop_length)
            return T, (fe.n_mels if fe.audio == "logmel" else fe.n_mfcc)
        return audio_samples, enc_cfg.get("input_dim", 1)
    if name == "video":
        return video_frames, enc_cfg.get("input_dim", 4096)
    return enc_cfg.get("sequence_length", 1), enc_cfg.get("input_dim", 64)


def classifier_param_count(cfg) -> int:
    """Exact trainable-parameter count of a Config's flagship classifier
    (concat-head train path), held to the port's own model in
    tests/test_torch_port_flops.py for every bench geometry."""
    out_dim = cfg.model.output_dim
    total = 0
    for name, enc_cfg in dict(cfg.model.encoders).items():
        enc_cfg = dict(enc_cfg)
        etype = enc_cfg.get("type", "sequence")
        hidden = enc_cfg.get("hidden_dim") or out_dim * 2
        _, in_dim = _enc_dims(cfg, name, enc_cfg, 48000, 24)
        if etype == "sequence":
            cell = enc_cfg.get("encoder_type", "lstm")
            layers = enc_cfg.get("num_layers", 2)
            d = in_dim
            if cell in ("lstm", "gru"):
                g = 4 if cell == "lstm" else 3
                nb = 1 if cell == "lstm" else 2  # lstm: b; gru: b_ih+b_hh
                for _ in range(layers):
                    total += g * hidden * (d + hidden) + nb * g * hidden
                    d = hidden
            elif cell == "transformer":
                total += in_dim * hidden + hidden  # input_proj
                total += POS_EMB_MAX_LEN * hidden  # pos_embedding
                per_block = (
                    4 * (hidden * hidden + hidden)   # qkv + out proj
                    + hidden * 4 * hidden + 4 * hidden  # ffn in
                    + 4 * hidden * hidden + hidden      # ffn out
                    + 2 * 2 * hidden                    # 2x LayerNorm
                )
                total += layers * per_block
            elif cell == "cnn":
                total += 5 * in_dim * hidden + hidden   # conv1 k5
                total += 3 * hidden * hidden + hidden   # conv2 k3
                total += 2 * 2 * hidden                 # 2x BatchNorm
            else:
                raise ValueError(f"Unknown encoder_type {cell!r}")
            total += hidden * out_dim + out_dim  # projection
        elif etype == "frame":
            total += in_dim * hidden + hidden    # frame_mlp
            total += hidden + 1                  # AttentionPool scores
            total += 2 * hidden                  # proj_ln
            total += hidden * out_dim + out_dim  # projection
        elif etype == "mlp":
            layers = enc_cfg.get("num_layers", 2)
            d = in_dim
            for _ in range(layers):
                total += d * hidden + hidden + 2 * hidden  # dense + BN
                d = hidden
            total += hidden * out_dim + out_dim
        else:
            raise ValueError(f"Param count not modeled for {etype!r}")
    n_mod = len(dict(cfg.model.encoders))
    total += n_mod * out_dim * cfg.model.hidden_dim + cfg.model.hidden_dim
    total += cfg.model.hidden_dim * cfg.dataset.num_classes
    total += cfg.dataset.num_classes
    return total


def mfu(clips_per_sec: float, train_flops_per_clip: float,
        peak_flops: float | None = None) -> Dict[str, float]:
    peak = peak_flops if peak_flops is not None else device_peak_flops()
    achieved = clips_per_sec * train_flops_per_clip
    return {
        "achieved_tflops": achieved / 1e12,
        "mfu": achieved / peak,
        "peak_tflops": peak / 1e12,
    }
