"""Log-mel spectrogram frontend: CUDA kernel + plain PyTorch version.

    frames = overlapped n_fft-sample windows at the hop
    re, im = frames @ (win * cos), frames @ (win * -sin)
    mel    = (re^2 + im^2) @ mel_filterbank
    out    = log(mel + eps)

``logmel_cuda`` calls the custom op ``med_torch::logmel``, which launches
the fused kernel (``csrc/logmel.cu``: one FFT a frame, the filterbank as
its non-zero runs) on a CUDA tensor, where the frame matrix and the
spectrum never reach device memory, and runs ``logmel_frames`` on a CPU
tensor.  The basis and filterbank are built
exactly as the JAX package builds them, so both packages use
bit-identical float32 constants; the kernel's twiddle and window tables
are rounded to float32 from float64 the same way.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from multimodal_emotion_detection_tpu_torch.ops._build import (
    CudaKernel,
    check_cuda_f32,
    kernel_op,
    stream_of,
)


@dataclasses.dataclass(frozen=True)
class LogMelParams:
    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 128
    win_length: int = 400  # 25 ms
    n_mels: int = 64
    fmin: float = 0.0
    fmax: Optional[float] = None
    log_epsilon: float = 1e-6

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        if num_samples < self.n_fft:
            return 0
        return 1 + (num_samples - self.n_fft) // self.hop_length


# ---------------------------------------------------------------------------
# Filterbank / basis construction (host-side numpy, cached)
# ---------------------------------------------------------------------------


def _hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m: np.ndarray | float) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def _mel_filterbank_np(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]
) -> np.ndarray:
    """HTK-style triangular mel filterbank, (n_bins, n_mels)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    mel_points = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_points = _mel_to_hz(mel_points)
    bin_freqs = np.arange(n_bins) * sample_rate / n_fft
    fb = np.zeros((n_bins, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, center, hi = hz_points[m], hz_points[m + 1], hz_points[m + 2]
        up = (bin_freqs - lo) / max(center - lo, 1e-10)
        down = (hi - bin_freqs) / max(hi - center, 1e-10)
        fb[:, m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb.astype(np.float32)


def mel_filterbank(params: LogMelParams) -> np.ndarray:
    return _mel_filterbank_np(
        params.sample_rate, params.n_fft, params.n_mels, params.fmin, params.fmax
    )


def _window_np(n_fft: int, win_length: int) -> np.ndarray:
    """Periodic Hann of win_length centre-padded to n_fft (librosa
    convention), float64."""
    n = np.arange(win_length)
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    pad_left = (n_fft - win_length) // 2
    window = np.zeros(n_fft)
    window[pad_left:pad_left + win_length] = win
    return window


@functools.lru_cache(maxsize=8)
def _dft_basis_np(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT basis: (n_fft, n_bins) cos and -sin matrices."""
    n_bins = n_fft // 2 + 1
    window = _window_np(n_fft, win_length)
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = 2.0 * np.pi * t * k / n_fft
    cos_b = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


@functools.lru_cache(maxsize=8)
def _constants(params: LogMelParams, device: torch.device):
    """(cos, sin, mel) on ``device``, copied there once per device."""
    cos_b, sin_b = _dft_basis_np(params.n_fft, params.win_length)
    return tuple(
        torch.from_numpy(a).to(device)
        for a in (cos_b, sin_b, mel_filterbank(params))
    )


def _as_2d(wave: torch.Tensor) -> torch.Tensor:
    return wave[..., 0] if wave.ndim == 3 else wave


def _check_frames(params: LogMelParams, num_samples: int) -> int:
    f = params.num_frames(num_samples)
    if f < 1:
        raise ValueError(
            f"log-mel frontend: waveform of {num_samples} samples is shorter "
            f"than one STFT window (n_fft={params.n_fft}) — 0 frames. Check "
            "that the audio input is a raw waveform (e.g. "
            "dataset.sequence_length too small for "
            "model.frontend.audio='logmel')."
        )
    return f


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def logmel_frames(wave: torch.Tensor, params: LogMelParams) -> torch.Tensor:
    """Plain log-mel: wave (B, T) or (B, T, 1) -> (B, F, n_mels) float32."""
    wave = _as_2d(wave).to(torch.float32)
    _check_frames(params, wave.shape[1])
    cos_b, sin_b, melw = _constants(params, wave.device)
    frames = wave.unfold(1, params.n_fft, params.hop_length)  # (B, F, n_fft)
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    power = re * re + im * im
    return torch.log(torch.matmul(power, melw) + params.log_epsilon)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/logmel.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
LOGMEL = CudaKernel(
    "logmel", "logmel_launch",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)
_MAX_MELS = 64  # the kernel's thread layout covers 64 bands
FFT_SIZES = tuple(2 ** e for e in range(6, 13))  # the kernel's n_fft: 64 .. 4096


@functools.lru_cache(maxsize=8)
def nonzero_taps(n_fft: int, win_length: int) -> Tuple[int, int]:
    """[lo, hi): the taps where the window is not zero.  The window is
    centre-padded into n_fft, so the taps outside it (and the Hann
    window's zero first tap) contribute nothing to any bin."""
    taps = np.flatnonzero(_window_np(n_fft, win_length).astype(np.float32))
    return (int(taps[0]), int(taps[-1]) + 1) if taps.size else (0, 0)


def _kernel_taps(params: LogMelParams) -> Tuple[int, int]:
    """The non-zero taps widened to whole pairs (2n, 2n + 1): the kernel
    packs the frame as complex points x[2n] + i x[2n + 1] and reads the
    points [lo / 2, hi / 2)."""
    lo, hi = nonzero_taps(params.n_fft, params.win_length)
    return lo // 2 * 2, max(-(-hi // 2) * 2, lo // 2 * 2 + 2)


@functools.lru_cache(maxsize=8)
def fft_tables_np(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's FFT tables, float32 rounded from float64: twiddles
    (n_fft, 2) W_N^k = (cos 2 pi k / N, -sin 2 pi k / N) and the window
    (n_fft,)."""
    angle = 2.0 * np.pi * np.arange(n_fft) / n_fft
    tw = np.stack([np.cos(angle), -np.sin(angle)], axis=-1).astype(np.float32)
    return tw, _window_np(n_fft, win_length).astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_runs_np(params: LogMelParams) -> Tuple[np.ndarray, np.ndarray]:
    """The filterbank as non-zero runs: (n_mels, 4) int32 rows (first bin,
    count, offset into the weights, 0) and the runs' weights packed
    (float32).  A band's run spans its first to its last non-zero bin (a
    triangle's are contiguous; an empty band has count 0), so summing it
    in bin order adds the dense product's terms without its zeros."""
    fb = mel_filterbank(params)
    runs = np.zeros((params.n_mels, 4), np.int32)
    weights = []
    off = 0
    for m in range(params.n_mels):
        nz = np.flatnonzero(fb[:, m])
        if nz.size:
            first, count = int(nz[0]), int(nz[-1]) + 1 - int(nz[0])
            runs[m, :3] = first, count, off
            weights.append(fb[first:first + count, m])
            off += count
        else:
            runs[m, 2] = off
    packed = np.concatenate(weights) if weights else np.zeros(1, np.float32)
    return runs, packed.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _kernel_constants(params: LogMelParams, device: torch.device):
    """(twiddles, window, runs, weights) for the kernel, on ``device``
    once per device."""
    tw, win = fft_tables_np(params.n_fft, params.win_length)
    runs, weights = mel_runs_np(params)
    return tuple(torch.from_numpy(a).to(device) for a in (tw, win, runs, weights))


def _launch(wave: torch.Tensor, params: LogMelParams) -> torch.Tensor:
    """The CUDA kernel of ``med_torch::logmel``: checks, tables, one launch."""
    wave = _as_2d(wave).to(torch.float32).contiguous()
    b, t = wave.shape
    f = _check_frames(params, t)
    if params.n_mels > _MAX_MELS or params.n_fft not in FFT_SIZES:
        raise ValueError(
            f"logmel_cuda: needs n_mels <= {_MAX_MELS} and n_fft a power of two "
            f"in {FFT_SIZES[0]} .. {FFT_SIZES[-1]} (other sizes: ROADMAP.md "
            f"Queue 1, 'log-mel at any n_fft'); got n_mels={params.n_mels}, "
            f"n_fft={params.n_fft}"
        )
    tw, win, runs, weights = _kernel_constants(params, wave.device)
    lo, hi = _kernel_taps(params)
    out = torch.empty((b, f, params.n_mels), dtype=torch.float32,
                      device=wave.device)
    check_cuda_f32("logmel_cuda", wave=wave, twiddles=tw, window=win,
                   weights=weights, out=out)
    LOGMEL(
        wave.data_ptr(), tw.data_ptr(), win.data_ptr(), runs.data_ptr(),
        weights.data_ptr(), out.data_ptr(), b, t, f, params.n_fft, lo // 2,
        hi // 2, params.hop_length, params.n_mels, params.log_epsilon,
        stream_of(wave),
    )
    return out


def _fake(wave: torch.Tensor, params: LogMelParams) -> torch.Tensor:
    wave = _as_2d(wave)
    f = _check_frames(params, wave.shape[1])
    return wave.new_empty((wave.shape[0], f, params.n_mels), dtype=torch.float32)


def _with_params(fn):
    """``fn(wave, params)`` as an op kernel over ``LogMelParams``' fields."""
    def kernel(wave, sample_rate, n_fft, hop_length, win_length, n_mels, fmin,
               fmax, log_epsilon):
        return fn(wave, LogMelParams(sample_rate, n_fft, hop_length, win_length,
                                     n_mels, fmin, fmax, log_epsilon))
    return kernel


LOGMEL_OP = kernel_op(
    "logmel",
    "(Tensor wave, int sample_rate, int n_fft, int hop_length, int win_length, "
    "int n_mels, float fmin, float? fmax, float log_epsilon) -> Tensor",
    cpu=_with_params(logmel_frames), cuda=_with_params(_launch),
    fake=_with_params(_fake))


def logmel_cuda(wave: torch.Tensor, params: LogMelParams) -> torch.Tensor:
    """Fused log-mel: wave (B, T) or (B, T, 1) -> (B, F, n_mels) float32.

    Calls ``med_torch::logmel``: on a CUDA tensor it launches
    ``csrc/logmel.cu`` (an FFT a frame; any hop, n_fft a power of two in
    64 .. 4096, n_mels <= 64) and counts the launch in
    ``LOGMEL.launches``; on a CPU tensor it runs ``logmel_frames``.  Any
    other device raises.
    """
    return LOGMEL_OP(wave, params.sample_rate, params.n_fft, params.hop_length,
                     params.win_length, params.n_mels, float(params.fmin),
                     None if params.fmax is None else float(params.fmax),
                     float(params.log_epsilon))


# the frontend's name in the JAX package; the device picks the route
log_mel_spectrogram = logmel_cuda


# ---------------------------------------------------------------------------
# MFCC (DCT-II over log-mel)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _dct_matrix_np(n_mels: int, n_mfcc: int) -> np.ndarray:
    """Orthonormal DCT-II basis, (n_mels, n_mfcc) — scipy norm='ortho'."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    basis = np.cos(np.pi * (2 * n + 1) * k / (2 * n_mels))
    basis *= np.sqrt(2.0 / n_mels)
    basis[:, 0] *= 1.0 / np.sqrt(2.0)
    return basis.astype(np.float32)


def mfcc(wave: torch.Tensor, params: LogMelParams, n_mfcc: int = 40) -> torch.Tensor:
    """MFCC frontend: log-mel -> orthonormal DCT-II matmul.

    (B, T[,1]) -> (B, F, n_mfcc).
    """
    logm = log_mel_spectrogram(wave, params)
    dct = torch.from_numpy(_dct_matrix_np(params.n_mels, n_mfcc)).to(logm.device)
    return torch.matmul(logm, dct)
