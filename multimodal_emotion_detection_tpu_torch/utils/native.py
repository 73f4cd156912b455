"""ctypes bindings for the native ETL kernels (``csrc/etl_kernels.cc``).

The source is built with ``g++ -O3 -shared`` on first use into
``build/etl_native/`` at the root of the checkout (a directory git
ignores), named by a hash of the source and the flags, as ``ops/_build.py``
builds the CUDA sources with nvcc.  A missing compiler or a failed build
raises: no entry falls back to another implementation.

``resample_poly_native`` reproduces ``scipy.signal.resample_poly`` with an
array window, its filter design and its upfirdn pre / post padding
included; ``resample_poly_plain`` is that scipy call, the plain version
the tests and ``chip_smoke.py`` hold the native one against, and runs only
when a caller asks for it.  The two agree to ~1e-12 (float64).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from math import gcd
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "etl_kernels.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "etl_native"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def library_path() -> Path:
    """The library of ``csrc/etl_kernels.cc``, named by a hash of the
    source and the flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libetl_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native ETL kernels "
                           "cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    i64 = ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.upfirdn_f64.argtypes = [f64p, i64, f64p, i64, i64, i64, f64p, i64]
    lib.upfirdn_f32.argtypes = [f32p, i64, f64p, i64, i64, i64, f32p, i64]
    lib.peak_normalize_f32.argtypes = [f32p, i64]
    lib.pcm16_to_f32_mono.argtypes = [
        ctypes.POINTER(ctypes.c_int16), i64, ctypes.c_int, f32p,
    ]
    return lib


def _output_len(taps: int, n_in: int, up: int, down: int) -> int:
    """scipy.signal._upfirdn._output_len."""
    return (((n_in - 1) * up + taps) - 1) // down + 1


def _design_filter(
    up: int,
    down: int,
    beta: float,
    half_cycles: int = 10,
    rolloff: float = 1.0,
) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for polyphase resampling, scaled by up.

    ``half_cycles=10, rolloff=1.0`` reproduces scipy.resample_poly's
    internal design exactly.  The audio frontend uses
    ``half_cycles=64, beta=14.7697, rolloff=0.9475``: the parameters of
    resampy's 'kaiser_best', the filter librosa historically shipped as
    its quality tier, which shrinks the transition band enough that
    content at 0.8x the target Nyquist survives to ~1e-6 (the short scipy
    default leaks ~4e-2 there).
    """
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = half_cycles * max_rate
    f_c = rolloff / max_rate
    h = firwin(2 * half_len + 1, f_c, window=("kaiser", beta))
    return h * up


def _reduce(up: int, down: int):
    g = gcd(int(up), int(down))
    return int(up) // g, int(down) // g


def resample_poly_native(
    x: np.ndarray,
    up: int,
    down: int,
    beta: float = 12.9846,
    half_cycles: int = 10,
    rolloff: float = 1.0,
) -> np.ndarray:
    """scipy.signal.resample_poly's result through the native upfirdn core
    (float64 out, as scipy for float64 input)."""
    lib = load_library()
    up, down = _reduce(up, down)
    if up == down == 1:
        return np.asarray(x, dtype=np.float64)

    x = np.ascontiguousarray(x, dtype=np.float64)
    n_in = len(x)
    n_out = n_in * up
    n_out = n_out // down + bool(n_out % down)

    h = _design_filter(up, down, beta, half_cycles, rolloff)
    half_len = (len(h) - 1) // 2
    # scipy's padding so the group delay lands on integer output samples
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while _output_len(len(h) + n_pre_pad + n_post_pad, n_in, up, down) < (
        n_out + n_pre_remove
    ):
        n_post_pad += 1
    h_padded = np.concatenate(
        [np.zeros(n_pre_pad), h, np.zeros(n_post_pad)]
    ).astype(np.float64)

    total_out = _output_len(len(h_padded), n_in, up, down)
    y = np.empty(total_out, dtype=np.float64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.upfirdn_f64(
        x.ctypes.data_as(f64p), n_in,
        h_padded.ctypes.data_as(f64p), len(h_padded),
        up, down,
        y.ctypes.data_as(f64p), total_out,
    )
    return y[n_pre_remove:n_pre_remove + n_out]


def resample_poly_plain(
    x: np.ndarray,
    up: int,
    down: int,
    beta: float = 12.9846,
    half_cycles: int = 10,
    rolloff: float = 1.0,
) -> np.ndarray:
    """The plain version: ``scipy.signal.resample_poly`` with the same
    Kaiser design as ``resample_poly_native`` (float64 out)."""
    from scipy.signal import resample_poly

    up, down = _reduce(up, down)
    if up == down == 1:
        return np.asarray(x, dtype=np.float64)
    # scipy scales an array window by `up` itself: hand it the unscaled design
    h = _design_filter(up, down, beta, half_cycles, rolloff) / up
    return resample_poly(np.asarray(x, dtype=np.float64), up, down, window=h)


def peak_normalize_native(x: np.ndarray) -> np.ndarray:
    """Peak normalization (x times 1 / max |x| where the peak is positive),
    in place on a contiguous float32 ``x``, else on a float32 copy; returns
    the normalised array."""
    lib = load_library()
    x = np.ascontiguousarray(x, dtype=np.float32)
    lib.peak_normalize_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x)
    )
    return x
