"""Log-mel spectrogram frontend: CUDA kernel + plain PyTorch version.

    frames = overlapped n_fft-sample windows at the hop
    re, im = frames @ (win * cos), frames @ (win * -sin)
    mel    = (re^2 + im^2) @ mel_filterbank
    out    = log(mel + eps)

``logmel_cuda`` launches the fused kernel (``csrc/logmel.cu``) on a CUDA
tensor, where the frame matrix and the spectrum never reach device memory,
and runs ``logmel_frames`` on a CPU tensor.  The basis and filterbank are
built exactly as the JAX package builds them, so both packages use
bit-identical float32 constants.
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


@functools.lru_cache(maxsize=8)
def _dft_basis_np(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT basis: (n_fft, n_bins) cos and -sin matrices."""
    n_bins = n_fft // 2 + 1
    # Periodic Hann of win_length, centre-padded to n_fft (librosa convention)
    n = np.arange(win_length)
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    pad_left = (n_fft - win_length) // 2
    window = np.zeros(n_fft)
    window[pad_left:pad_left + win_length] = win
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
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _P],
)
_MAX_MELS = 64  # the kernel's thread layout covers 64 bands
_TAP_CHUNK = 16  # the kernel stages n_fft taps in chunks of 16


@functools.lru_cache(maxsize=8)
def nonzero_taps(n_fft: int, win_length: int) -> Tuple[int, int]:
    """[lo, hi): the rows of the DFT basis that are not all zero.  The
    window is centre-padded into n_fft, so the taps outside it (and the
    Hann window's zero first tap) contribute nothing to any bin."""
    cos_b, sin_b = _dft_basis_np(n_fft, win_length)
    rows = np.flatnonzero(np.any(cos_b != 0, axis=1) | np.any(sin_b != 0, axis=1))
    return (int(rows[0]), int(rows[-1]) + 1) if rows.size else (0, 0)


def _kernel_taps(params: LogMelParams) -> Tuple[int, int]:
    """The non-zero taps widened to whole chunks of the kernel's stage."""
    lo, hi = nonzero_taps(params.n_fft, params.win_length)
    lo = lo // _TAP_CHUNK * _TAP_CHUNK
    return lo, max(-(-hi // _TAP_CHUNK) * _TAP_CHUNK, lo + _TAP_CHUNK)


@functools.lru_cache(maxsize=8)
def _kernel_constants(params: LogMelParams, device: torch.device):
    """(cos, sin, mel) for the kernel: the bases' rows zero-padded to a
    multiple of 4 columns, so the kernel loads them as aligned float4."""
    cos_b, sin_b, melw = _constants(params, device)
    ldb = -(-params.n_bins // 4) * 4
    pad = (0, ldb - params.n_bins)
    return (torch.nn.functional.pad(cos_b, pad).contiguous(),
            torch.nn.functional.pad(sin_b, pad).contiguous(), melw)


def logmel_cuda(wave: torch.Tensor, params: LogMelParams) -> torch.Tensor:
    """Fused log-mel: wave (B, T) or (B, T, 1) -> (B, F, n_mels) float32.

    On a CUDA tensor this launches ``csrc/logmel.cu`` (any hop) and counts
    the launch in ``LOGMEL.launches``; on a CPU tensor it runs
    ``logmel_frames``.  Any other device raises.
    """
    wave = _as_2d(wave)
    if wave.device.type == "cpu":
        return logmel_frames(wave, params)
    wave = wave.to(torch.float32).contiguous()
    b, t = wave.shape
    f = _check_frames(params, t)
    if params.n_mels > _MAX_MELS or params.n_fft % _TAP_CHUNK:
        raise ValueError(
            f"logmel_cuda: needs n_mels <= {_MAX_MELS} and n_fft % "
            f"{_TAP_CHUNK} == 0; got n_mels={params.n_mels}, "
            f"n_fft={params.n_fft}"
        )
    cos_b, sin_b, melw = _kernel_constants(params, wave.device)
    t_lo, t_hi = _kernel_taps(params)
    out = torch.empty((b, f, params.n_mels), dtype=torch.float32,
                      device=wave.device)
    check_cuda_f32("logmel_cuda", wave=wave, cos=cos_b, sin=sin_b, mel=melw,
                   out=out)
    LOGMEL(
        wave.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), melw.data_ptr(),
        out.data_ptr(), b, t, f, params.n_fft, t_lo, t_hi, params.hop_length,
        params.n_bins, cos_b.shape[1], params.n_mels, params.log_epsilon,
        stream_of(wave),
    )
    return out


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
