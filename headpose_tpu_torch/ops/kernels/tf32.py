"""The 3-pass TF32 product of the tensor-core kernels, emulated on the CPU.

csrc/se_attention.cu multiplies on the tensor cores in 3-pass TF32; the
CPU tests emulate it with `matmul_3xtf32` to show which heads that
precision serves within their kernel's tolerance, and which it does not
(csrc/head_mlp.cu stays fp32 for that reason).
"""
from __future__ import annotations

import torch

__all__ = ["split_tf32", "matmul_3xtf32"]


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of a float32 tensor as the kernel splits an operand: hi =
    tf32(t), lo = tf32(t - hi), both rounded to nearest with ties away from
    zero (PTX cvt.rna.tf32.f32: 10 stored mantissa bits), returned as
    float32 tensors.  t - hi is exact in float32, and hi + lo holds t to
    about 2^-22 relative."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(t)
    return hi, rna(t - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's 3-pass TF32 product: lo.hi + hi.lo + hi.hi of
    the split operands (the lo.lo term dropped), each product exact in
    float32, summed in float32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
