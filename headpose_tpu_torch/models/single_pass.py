"""Single-pass bf16 products: the arithmetic of the TPU's Precision.DEFAULT.

On the TPU, `jax.default_matmul_precision("default")` makes every conv and
matrix product one MXU pass: both operands rounded to bf16 (to nearest,
ties to even), the products exact, the sums in fp32.  The JAX package's
model of it is `BlazeFace.apply(simulate_fast=True)`, verified bit-exact to
the chip.  The port's modules take `single_pass=True` for that arithmetic:
each product rounds its two operands once here and runs in fp32 with TF32
off (`fp32_exact`); a bias is added unrounded, and nothing that is not a
product (a skip add, a softmax, a layer norm, a mean) is rounded.

The rounding is a cast to bf16 and back, so autograd rounds the cotangent
of each rounded operand to bf16, as the transpose of JAX's `astype` does;
the backward products run in fp32 (JAX's `simulate_fast` convention, the
detector trainers' at precision "default").
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MATMUL_PRECISIONS", "single_pass_of", "bf16_round",
           "fp32_exact", "linear", "einsum"]

# the strings the JAX package's modules pass to jax.default_matmul_precision
MATMUL_PRECISIONS = ("highest", "high", "default")


def single_pass_of(precision: str) -> bool:
    """Whether a module at `precision` (one of MATMUL_PRECISIONS) computes
    single-pass products: "default" does; "highest" and "high" compute
    fp32 (the TPU's "high" is three bf16 passes, an emulation of fp32).
    Any other string raises NotImplementedError."""
    if precision not in MATMUL_PRECISIONS:
        raise NotImplementedError(
            f"precision={precision!r} is not served by the port; the served "
            f"strings are {MATMUL_PRECISIONS}")
    return precision == "default"


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest, ties to even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuDNN convs and matrix products inside the block, the
    previous settings restored after it (no-ops on the CPU).  When both are
    off already, as a CUDA `FaceDetector` leaves them, it sets nothing: a
    setter call costs host time on the serving path."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if saved == (False, False):
        yield
        return
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def linear(layer: nn.Linear, x: torch.Tensor,
           single_pass: bool = False) -> torch.Tensor:
    """`layer(x)`; with `single_pass`, the product of bf16(x) and
    bf16(weight) in fp32, the bias unrounded."""
    if not single_pass:
        return layer(x)
    with fp32_exact():
        return F.linear(bf16_round(x), bf16_round(layer.weight), layer.bias)


def einsum(equation: str, a: torch.Tensor, b: torch.Tensor,
           single_pass: bool = False) -> torch.Tensor:
    """`torch.einsum(equation, a, b)`; with `single_pass`, of bf16(a) and
    bf16(b) in fp32."""
    if not single_pass:
        return torch.einsum(equation, a, b)
    with fp32_exact():
        return torch.einsum(equation, bf16_round(a), bf16_round(b))
