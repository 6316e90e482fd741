"""One island block at single-pass bf16 on the card: wrapper of
csrc/dense_bf16.cu.

`dense_block(net, i, x)` runs block i of `net` (a `BlazeFaceNet`) over x
(B, H, H, Cin) float32 NHWC as an island of a dense composition: one 3x3
conv of bf16(x) and the composed kernel K = dw * pw rounded to bf16 once
(`BlazeBlock.composed`), the products exact and the sums in fp32, plus the
fp32 bias dw_bias @ pw + pw_bias, then the block's skip (x unrounded,
max-pooled 2x2/2 at stride 2, zero-padded on the channel axis) and the
ReLU; fp32 out, (B, H/s, H/s, Cout).  It is the function the JAX package
computes for a block in `fast_blocks` of `BlazeFace.apply(dense=True)` at
Precision.DEFAULT, with no Pallas kernel of its own: XLA runs it as a conv.
The detector's precision="turbo" and "max" run their islands through it
(`backbone2.apply_fused(..., island=...)`).

A tensor on the CPU goes through `dense_block_plain`, the module's own
island step (`BlazeBlock.forward(x, dense=True, fast=True)`: an fp32 conv
of the rounded operands with TF32 off); a tensor on a CUDA device goes
through the hand-written kernel, or the call raises.  Nothing else selects between the two.  The kernel
takes Cin <= Cout <= 128 (`MAX_CHANNELS`), stride 1 or 2, and an even map at
stride 2 (as every BlazeFace spec the backbone kernels take).
"""
from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from ...models.blazeface import BlazeFaceNet
from ...utils.build import NVCC_FLAGS, CudaLibrary
from . import backbone as kbb
from .packing import Packed, packed, stamp

__all__ = ["dense_block", "dense_block_plain", "dense_block_cuda",
           "dense_pack", "DensePack", "MAX_CHANNELS", "LIBRARY"]

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "dense_bf16.cu")
MAX_CHANNELS = 128


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.headpose_dense_bf16_block
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("dense_bf16", [SOURCE], _configure, NVCC_FLAGS)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# ------------------------------------------------------------------ weights
def _kernel_leaves(net: BlazeFaceNet):
    """Per block: the composed kernel as (9, Np, Kp), [tap][out][in] with tap
    = 3 a + b, zero-padded to the mma tile (Np = Cout rounded up to 8, Kp =
    Cin rounded up to 16), in fp32: `packed` rounds it to bf16 once."""
    for blk in net.blocks:
        K, _ = blk.composed()                          # (Cout, Cin, 3, 3)
        cout, cin = K.shape[:2]
        pad = K.new_zeros((9, _round_up(cout, 8), _round_up(cin, 16)))
        pad[:, :cout, :cin] = K.permute(2, 3, 0, 1).reshape(9, cout, cin)
        yield pad


def _bias_leaves(net: BlazeFaceNet):
    """Per block: the composed bias, fp32, zero-padded to Np."""
    for blk in net.blocks:
        _, bias = blk.composed()
        pad = bias.new_zeros(_round_up(bias.shape[0], 8))
        pad[:bias.shape[0]] = bias
        yield pad


@dataclasses.dataclass(frozen=True)
class DensePack:
    """Every block's composed kernel in bf16 (`kernels`, (9, Np, Kp) each,
    16-byte aligned) and its bias in fp32 (`biases`, (Np,) each)."""
    kernels: Packed
    biases: Packed
    shapes: tuple[tuple[int, int], ...]    # (Np, Kp) per block

    def kernel(self, block: int) -> torch.Tensor:
        """Block `block`'s composed kernel, (9, Np, Kp) bfloat16."""
        n, k = self.shapes[block]
        off = self.kernels.offsets[block]
        return self.kernels.weights[off:off + 9 * n * k].view(9, n, k)

    def bias(self, block: int) -> torch.Tensor:
        """Block `block`'s composed bias, (Np,) float32."""
        off = self.biases.offsets[block]
        return self.biases.weights[off:off + self.shapes[block][0]]


def dense_pack(net: BlazeFaceNet, current: tuple | None = None) -> DensePack:
    """`net`'s composed island weights, built once per module (re-packed
    when a parameter changes; `packing.packed`).  `current` is
    `packing.stamp(net)` when the caller has just taken it."""
    current = stamp(net) if current is None else current
    shapes = tuple((_round_up(b.pw.weight.shape[0], 8),
                    _round_up(b.dw.weight.shape[0], 16)) for b in net.blocks)
    return DensePack(packed(net, _kernel_leaves, torch.bfloat16, current),
                     packed(net, _bias_leaves, torch.float32, current),
                     shapes)


# ------------------------------------------------------------ plain version
def _check_input(net: BlazeFaceNet, i: int, x: torch.Tensor) -> None:
    if not 0 <= i < len(net.blocks):
        raise ValueError(f"block {i} is not a block of this spec "
                         f"(0..{len(net.blocks) - 1})")
    blk = net.blocks[i]
    cin = blk.dw.weight.shape[0]
    if x.ndim != 4 or x.shape[1] != x.shape[2] or x.shape[3] != cin:
        raise ValueError(f"block {i} takes (B, H, H, {cin}), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")


@torch.no_grad()
def dense_block_plain(net: BlazeFaceNet, i: int,
                      x: torch.Tensor) -> torch.Tensor:
    """Block i of `net` as an island, in plain torch ops over NHWC x: the
    module's island step (`BlazeBlock.forward` with dense and fast), NHWC
    in and out."""
    _check_input(net, i, x)
    y = net.blocks[i](x.permute(0, 3, 1, 2), dense=True, fast=True)
    return y.permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------------------------ kernel
@torch.no_grad()
def dense_block_cuda(net: BlazeFaceNet, i: int, x: torch.Tensor,
                     pack: DensePack | None = None) -> torch.Tensor:
    """The kernel: what `dense_block_plain` computes, on a CUDA device, one
    launch on the current stream, without synchronising.  `pack` is
    `dense_pack(net)`, when the caller holds it.  Raises on anything the
    kernel does not take, and when the launch fails."""
    _check_input(net, i, x)
    kbb._check_cuda(net, x)
    blk = net.blocks[i]
    cin, cout, s = blk.dw.weight.shape[0], blk.pw.weight.shape[0], blk.stride
    h = x.shape[1]
    if max(cin, cout) > MAX_CHANNELS:
        raise ValueError(f"block {i} is wider than {MAX_CHANNELS} channels")
    if s == 2 and h % 2:
        raise ValueError(f"block {i} (stride 2) needs an even map, got {h}")
    pack = pack if pack is not None else dense_pack(net)
    out = x.new_empty((x.shape[0], h // s, h // s, cout))
    if x.shape[0] == 0:
        return out
    w = pack.kernels.weights
    with torch.cuda.device(x.device):
        err = LIBRARY.load().headpose_dense_bf16_block(
            x.data_ptr(), w.data_ptr() + 2 * pack.kernels.offsets[i],
            pack.biases.weights.data_ptr() + 4 * pack.biases.offsets[i],
            out.data_ptr(), x.shape[0], h, cin, cout, s,
            torch.cuda.current_stream().cuda_stream)
    kbb._raise_on(err, f"island block {i} kernel")
    dense_block.launches += 1
    return out


def dense_block(net: BlazeFaceNet, i: int, x: torch.Tensor) -> torch.Tensor:
    """Block i of `net` as a single-pass bf16 island over NHWC x: the CUDA
    kernel for a tensor on a CUDA device, the plain version for a tensor on
    the CPU.  `dense_block.launches` counts the kernel's launches."""
    if x.device.type == "cpu":
        return dense_block_plain(net, i, x)
    return dense_block_cuda(net, i, x)


dense_block.launches = 0
