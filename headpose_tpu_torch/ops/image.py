"""Image preprocessing: TF-exact bicubic resize as two fp32 matmuls.

Port of headpose_tpu/ops/image.py.  Layout stays NHWC.  The matmuls run in
full fp32: the detector turns TF32 off on a CUDA device.  With
`single_pass` (the detector's precision "default": JAX resizes inside its
`jax.default_matmul_precision` block) each matmul takes bf16-rounded
operands, exact products and fp32 sums (core/single_pass.py).
"""
from __future__ import annotations

import torch

from ..core.single_pass import bf16_round, fp32_exact
from ..utils.constants import device_constant
from .bicubic import bicubic_matrix

__all__ = ["bicubic_matrix", "resize_bicubic", "preprocess"]


@device_constant(maxsize=64)
def _matrix_on(src: int, dst: int, device: torch.device) -> torch.Tensor:
    # cached per device: a host→device copy per call would synchronise
    return torch.tensor(bicubic_matrix(src, dst), device=device)


def resize_bicubic(images: torch.Tensor, out_hw: tuple[int, int],
                   single_pass: bool = False) -> torch.Tensor:
    """Resize (B, H, W, C) [or (H, W, C)] to (B, h, w, C), TF-bicubic-exact,
    or with `single_pass` each of the two matmuls of bf16-rounded operands.

    Same-size inputs short-circuit to an fp32 cast (the interpolation matrix
    is exactly the identity at scale 1 with half-pixel centers)."""
    squeeze = images.ndim == 3
    if squeeze:
        images = images[None]
    B, H, W, C = images.shape
    oh, ow = out_hw
    if (H, W) == (oh, ow):
        out = images.to(torch.float32)
        return out[0] if squeeze else out
    images = images.to(torch.float32)
    rh = _matrix_on(H, oh, images.device)
    rw = _matrix_on(W, ow, images.device)
    if single_pass:
        with fp32_exact():
            y = torch.matmul(bf16_round(rh), bf16_round(
                images.reshape(B, H, W * C))).reshape(B * oh, W, C)
            y = torch.einsum("pw,nwc->npc", bf16_round(rw), bf16_round(y))
        y = y.reshape(B, oh, ow, C)
        return y[0] if squeeze else y
    # rows: (oh, H) @ (B, H, W*C) -> (B, oh, W*C)
    y = torch.matmul(rh, images.reshape(B, H, W * C)).reshape(B * oh, W, C)
    # cols: contract W with (ow, W): (B*oh, W, C) -> (B*oh, ow, C)
    y = torch.einsum("pw,nwc->npc", rw, y).reshape(B, oh, ow, C)
    return y[0] if squeeze else y


def preprocess(images: torch.Tensor, input_size: int = 128,
               channel_order: str = "bgr",
               single_pass: bool = False) -> torch.Tensor:
    """Detector preprocessing: BGR→RGB, scale to [0, 1], bicubic resize to
    input_size² (`single_pass`: of bf16-rounded operands), then map to
    [-1, 1].

    images: (B, H, W, 3) or (H, W, 3), uint8 or float in [0, 255].
    Returns (B, input_size, input_size, 3) float32 in [-1, 1]."""
    if channel_order not in ("bgr", "rgb"):
        # a typo'd order would otherwise silently mean "no swap"
        raise ValueError(f"channel_order must be 'bgr' or 'rgb', "
                         f"got {channel_order!r}")
    squeeze = images.ndim == 3
    if squeeze:
        images = images[None]
    x = images.to(torch.float32)
    if channel_order == "bgr":
        x = x.flip(-1)
    x = x / 255.0
    x = resize_bicubic(x, (input_size, input_size), single_pass)
    x = (x - 0.5) / 0.5
    return x[0] if squeeze else x
