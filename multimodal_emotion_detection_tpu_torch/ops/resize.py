"""Batched image transforms as matrix products: area resize + grayscale.

The reference ETL resizes frames with ``cv2.resize(..., INTER_AREA)`` and
converts BGR to gray (the reference's dataprocessing.py:259-265), one frame
at a time on the host.  Area resampling is separable, so here it is two
small matrix products

    out = R_h @ img @ R_w^T

where ``R_h (H_out, H_in)`` / ``R_w (W_out, W_in)`` hold the exact pixel
coverage fractions of each output cell (cv2.INTER_AREA's result to ~1e-6
on float inputs; cv2's uint8 path rounds besides).

``area_resize``, ``bgr_to_gray`` and ``rgb_to_gray`` run on the input's
device in full float32.  The resize is two ``torch.matmul``s with TF32
switched off for them whatever the process's setting (the JAX package
computes them at ``Precision.HIGHEST`` for cv2 parity).  The luma is a
weighted sum of the three channels, taken from the frames as they come:
uint8 frames are read as bytes and promoted to float32 in the sum, never
copied whole to float32 (a float32 matmul by the (3,) luma vector is a
cuBLAS gemv, 3x slower on RAVDESS's 1280x720 frames, scripts/resize_ab.py);
its sums run in the matmul's order, b + g then + r.  Any input dtype
gives float32.  ``area_resize_np`` is the numpy twin for the host-side ETL.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

# ITU-R BT.601 luma weights, the cv2.COLOR_BGR2GRAY definition
_BGR_WEIGHTS = np.array([0.114, 0.587, 0.299], dtype=np.float32)
_RGB_WEIGHTS = _BGR_WEIGHTS[::-1].copy()


@functools.lru_cache(maxsize=64)
def _area_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic area-coverage matrix."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for o in range(out_size):
        start = o * scale
        end = (o + 1) * scale
        i0 = int(np.floor(start))
        i1 = int(np.ceil(end))
        for i in range(i0, min(i1, in_size)):
            cover = min(end, i + 1) - max(start, i)
            if cover > 0:
                w[o, i] = cover
        w[o] /= w[o].sum()
    return w.astype(np.float32)


@contextlib.contextmanager
def full_float32():
    """TF32 off for CUDA matrix products inside the block, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def area_resize(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Area-average resize of (..., H, W) images to (..., out_h, out_w),
    float32."""
    in_h, in_w = images.shape[-2], images.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return images
    x = images.to(torch.float32)
    rh = torch.from_numpy(_area_weights(in_h, out_h)).to(x.device)  # (out_h, in_h)
    rw = torch.from_numpy(_area_weights(in_w, out_w)).to(x.device)  # (out_w, in_w)
    with full_float32():
        # (..., H, W) @ (W, out_w) -> (..., H, out_w); then contract H
        x = torch.matmul(x, rw.T)
        return torch.matmul(rh, x)


def _luma(images: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    if images.is_floating_point():
        images = images.to(torch.float32)
    w0, w1, w2 = (float(w) for w in weights)
    out = torch.mul(images[..., 0], w0)  # integer frames promote to float
    out.add_(images[..., 1], alpha=w1)
    out.add_(images[..., 2], alpha=w2)
    return out.to(torch.float32)


def bgr_to_gray(images: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR -> (...,) luma, cv2.COLOR_BGR2GRAY weights."""
    return _luma(images, _BGR_WEIGHTS)


def rgb_to_gray(images: torch.Tensor) -> torch.Tensor:
    return _luma(images, _RGB_WEIGHTS)


def area_resize_np(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Numpy twin for the host-side ETL (no device round trip)."""
    in_h, in_w = images.shape[-2], images.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return images.astype(np.float32)
    rh = _area_weights(in_h, out_h)
    rw = _area_weights(in_w, out_w)
    x = images.astype(np.float32)
    x = np.einsum("...hw,ow->...ho", x, rw)
    x = np.einsum("...ho,ph->...po", x, rh)
    return x
