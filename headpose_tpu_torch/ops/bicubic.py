"""TF-exact bicubic interpolation matrices (numpy only).

The detector resizes camera frames the way ``tf.image.resize(method=
'bicubic')`` does.  The target size is static, so the resample is two dense
per-axis interpolation matrices that `ops/image.py` applies as two fp32
matmuls.

Kernel: Keys bicubic, A = -0.5, half-pixel centers; boundary taps that fall
outside the image are dropped and the remaining weights renormalized.  TF's
ResizeBicubic indexes a 1024-bin coefficient table with lrintf(delta * 1024),
so the fractional phase is quantized to the same 1/1024 grid.

`resize_bicubic_np` is the numpy twin of `ops.image.resize_bicubic`: the
same two matrices as two float32 products (BLAS), for the edge pipeline
(runtime.edge), which runs with no torch in its preprocess.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["bicubic_matrix", "resize_bicubic_np"]


def _keys_cubic(t: np.ndarray, a: float = -0.5) -> np.ndarray:
    t = np.abs(t)
    return np.where(
        t <= 1.0, (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
        np.where(t < 2.0, a * (t**3 - 5.0 * t**2 + 8.0 * t - 4.0), 0.0))


@functools.lru_cache(maxsize=64)
def bicubic_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) interpolation matrix for one axis (float32)."""
    scale = src / dst
    x = (np.arange(dst) + 0.5) * scale - 0.5
    i0 = np.floor(x).astype(np.int64)
    xq = i0 + np.rint((x - i0) * 1024.0) / 1024.0   # TF's table phase
    m = np.zeros((dst, src), np.float64)
    rows = np.arange(dst)
    for k in range(-1, 3):
        idx = i0 + k
        w = _keys_cubic(xq - idx) * ((idx >= 0) & (idx < src))
        np.add.at(m, (rows, np.clip(idx, 0, src - 1)), w)
    m /= m.sum(axis=1, keepdims=True)
    m = m.astype(np.float32)
    m.flags.writeable = False      # shared by every caller through the cache
    return m


def resize_bicubic_np(images: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """numpy twin of ops.image.resize_bicubic: (B, H, W, C) or (H, W, C)
    float32 → TF-bicubic-exact resize, two f32 GEMMs (BLAS).  Same-size
    inputs short-circuit to an f32 cast, as the torch path does."""
    squeeze = images.ndim == 3
    if squeeze:
        images = images[None]
    B, H, W, C = images.shape
    oh, ow = out_hw
    if (H, W) == (oh, ow):
        out = images.astype(np.float32)
        return out[0] if squeeze else out
    rh = bicubic_matrix(H, oh)
    rw = bicubic_matrix(W, ow)
    x = images.astype(np.float32)
    y = np.matmul(rh, x.reshape(B, H, W * C)).reshape(B * oh, W, C)
    y = np.einsum("pw,nwc->npc", rw, y).reshape(B, oh, ow, C)
    return y[0] if squeeze else y
