"""TF-exact bicubic resize and the detector's preprocess, plain PyTorch.

`tf.image.resize(method="bicubic")` without antialiasing: Keys' cubic with
A = -0.5, half-pixel centres, taps outside the image dropped and the rest
renormalised, the fractional phase quantised to TF's 1/1024 table.  A
resize is two float32 matrix products, rows then columns.
"""
from __future__ import annotations

import numpy as np
import torch


def _keys_cubic(t: np.ndarray, a: float = -0.5) -> np.ndarray:
    t = np.abs(t)
    return np.where(
        t <= 1.0, (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
        np.where(t < 2.0, a * (t**3 - 5.0 * t**2 + 8.0 * t - 4.0), 0.0))


def bicubic_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 interpolation matrix of one axis."""
    x = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(x).astype(np.int64)
    xq = i0 + np.rint((x - i0) * 1024.0) / 1024.0
    m = np.zeros((dst, src), np.float64)
    rows = np.arange(dst)
    for k in range(-1, 3):
        idx = i0 + k
        w = _keys_cubic(xq - idx) * ((idx >= 0) & (idx < src))
        np.add.at(m, (rows, np.clip(idx, 0, src - 1)), w)
    m /= m.sum(axis=1, keepdims=True)
    return m.astype(np.float32)


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) float32 → (B, size, size, C); a frame of that size
    already is returned as it is (the matrices are the identity there)."""
    B, H, W, C = x.shape
    if (H, W) == (size, size):
        return x
    rh = torch.from_numpy(bicubic_matrix(H, size)).to(x.device)
    rw = torch.from_numpy(bicubic_matrix(W, size)).to(x.device)
    y = torch.matmul(rh, x.reshape(B, H, W * C)).reshape(B * size, W, C)
    return torch.einsum("pw,nwc->npc", rw, y).reshape(B, size, size, C)


def preprocess(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) BGR uint8 → (B, size, size, 3) RGB float32 in [-1, 1]."""
    x = frames.to(torch.float32).flip(-1) / 255.0
    return (resize(x, size) - 0.5) / 0.5


def resize_flops(h: int, w: int, size: int, channels: int = 3) -> int:
    """Multiply-adds × 2 of `resize` for one (h, w) frame; 0 where no
    resize runs."""
    if (h, w) == (size, size):
        return 0
    return 2 * size * h * w * channels + 2 * size * size * w * channels
