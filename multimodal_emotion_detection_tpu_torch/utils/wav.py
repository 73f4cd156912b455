"""Dependency-free WAV reading + polyphase resampling.

The reference audio frontend is ``librosa.load(path, sr=16000)`` (the
reference's dataprocessing.py:196): librosa decodes through
soundfile / audioread and resamples with soxr.  Neither is needed here:

* PCM WAV decoding with the stdlib ``wave`` module + numpy (8/16/24/32-bit
  int, mixed down to mono like librosa's default ``mono=True``);
* polyphase resampling with a librosa-'kaiser_best'-grade Kaiser design,
  through the native upfirdn core (``utils/native.py``), whose plain
  version (``scipy.signal.resample_poly`` with the same design) runs only
  when the caller asks for it (``plain=True``).

The JAX package's ``utils/wav.py``, whose results these are bit for bit.
"""

from __future__ import annotations

import wave
from math import gcd
from pathlib import Path
from typing import Tuple

import numpy as np

from multimodal_emotion_detection_tpu_torch.utils.native import (
    resample_poly_native,
    resample_poly_plain,
)


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Read a WAV file to float32 in [-1, 1], mixed down to mono.

    Returns:
        (samples (T,), sample_rate)
    """
    try:
        with wave.open(str(path), "rb") as wf:
            n_channels = wf.getnchannels()
            sample_width = wf.getsampwidth()
            sample_rate = wf.getframerate()
            n_frames = wf.getnframes()
            raw = wf.readframes(n_frames)
    except (wave.Error, EOFError) as exc:
        # the stdlib module only decodes plain PCM RIFF; give a crisp
        # error instead of its opaque 'unknown format: 65534'
        raise ValueError(
            f"{path}: not a plain-PCM WAV the stdlib reader can decode "
            f"({exc}). Compressed or WAVE_FORMAT_EXTENSIBLE files must be "
            "converted first (e.g. ffmpeg -i in.wav -c:a pcm_s16le out.wav)."
        ) from exc

    if sample_width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sample_width == 4:
        # WAVE_FORMAT int32 (the stdlib wave module only exposes PCM)
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sample_width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        signed = (
            a[:, 0].astype(np.int32)
            | (a[:, 1].astype(np.int32) << 8)
            | (a[:, 2].astype(np.int32) << 16)
        )
        signed = np.where(signed >= 1 << 23, signed - (1 << 24), signed)
        data = signed.astype(np.float32) / float(1 << 23)
    elif sample_width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {sample_width}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, sample_rate


# resampy 'kaiser_best' design constants (librosa's historical quality
# tier; the reference's librosa.load(sr=16000) contract).  64 sinc
# half-cycles per side with rolloff 0.9475 give a transition band sharp
# enough that content at 0.8x the target Nyquist is preserved to ~1e-6;
# scipy's default 10-half-cycle design leaks ~4e-2 there.
_KAISER_BEST_BETA = 14.769656459379492
_KAISER_BEST_HALF_CYCLES = 64
_KAISER_BEST_ROLLOFF = 0.9475


def resample(y: np.ndarray, orig_sr: int, target_sr: int,
             plain: bool = False) -> np.ndarray:
    """Polyphase resample with a librosa-'kaiser_best'-grade filter, to
    float32: the native upfirdn core, or with ``plain`` its scipy plain
    version."""
    if orig_sr == target_sr:
        return y.astype(np.float32)
    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    route = resample_poly_plain if plain else resample_poly_native
    out = route(y, up, down, beta=_KAISER_BEST_BETA,
                half_cycles=_KAISER_BEST_HALF_CYCLES, rolloff=_KAISER_BEST_ROLLOFF)
    return out.astype(np.float32)


def load_audio(
    path: str | Path, sr: int = 16000, mono: bool = True
) -> Tuple[np.ndarray, int]:
    """librosa.load-compatible entry: decode + resample to ``sr``."""
    y, native_sr = read_wav(path)
    if sr is not None and sr != native_sr:
        y = resample(y, native_sr, sr)
        native_sr = sr
    return y.astype(np.float32), native_sr
