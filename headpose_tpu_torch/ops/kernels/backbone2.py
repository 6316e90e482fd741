"""The split-bf16 BlazeFace backbone on the card: wrapper of csrc/backbone2.cu.

`apply_fused(net, x)` is the counterpart of the TPU function
headpose_tpu/ops/pallas/backbone2.py::apply_fused: the backbone of `net` (a
`BlazeFaceNet`) over x (B, 128, 128, 3) float32 NHWC, returning NHWC
(feat88 (B, 16, 16, C88), feat96 (B, 8, 8, C96)).  The stem and block 11 run
in fp32; the other blocks run in four segments (`SEGMENTS`, `run_segment`)
whose pointwise 1x1 is a 3-pass split-bf16 product with fp32 accumulation
(x_hi.w_hi + x_lo.w_hi + x_hi.w_lo, `split_bf16`) and whose depthwise stays
in fp32.  That is the TPU's 'high' matmul precision, the precision of the
detector's precision='fast' mode.

A tensor on the CPU goes through the plain versions (`run_segment_plain`,
`apply_fused_plain`), which repeat the arithmetic in plain torch ops; a
tensor on a CUDA device goes through the hand-written kernels, or the call
raises.  Nothing else selects between the two.  On the card the stem and
block 11 are launches of csrc/backbone.cu (`backbone.stem_forward_cuda`,
`backbone.block_forward_cuda`) and each segment block one launch of
csrc/backbone2.cu.

The JAX function's lane coalescing (B % 8 == 0), its channel-major flat-gap
and parity-plane layouts, its block-diagonal I4 (x) W weight planes and its
`interpret` flag are TPU and Mosaic knobs with no counterpart here: any
B >= 1 is taken.  Its domain is kept, and a spec outside it raises
ValueError: input 128, 16 blocks, downsample blocks (2, 5, 11), tap block
10, channels that never narrow, block 11 of 89-96 channels (the reference
fixes segment D's input at 96 rows, `backbone2.py:489`), and at most 128
channels (the kernel's limit).
"""
from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from ...models.blazeface import BlazeFace, BlazeFaceNet
from ...utils.build import NVCC_FLAGS_FMA, CudaLibrary
from . import backbone as kbb
from .packing import Packed, c_ints, packed, stamp

__all__ = ["SEGMENTS", "split_bf16", "pack_backbone", "SegmentPack",
           "run_segment", "run_segment_plain", "run_segment_cuda",
           "apply_fused", "apply_fused_plain", "apply_fused_cuda", "LIBRARY"]

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "backbone2.cu")
MAX_CHANNELS = 128   # 16 n-tiles of 8 output channels in registers

# Segment: (first block, last block, input resolution), as the JAX table
# (backbone2.py:93-98).  Block 11 and the stem run outside, in fp32.
SEGMENTS = {
    "A": (0, 2, 64),
    "B": (3, 5, 32),
    "C": (6, 10, 16),
    "D": (12, 15, 8),
}
_BLOCKS = tuple(i for first, last, _ in SEGMENTS.values()
                for i in range(first, last + 1))


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.headpose_backbone2_segment
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("backbone2", [SOURCE], _configure, NVCC_FLAGS_FMA)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check_domain(spec: BlazeFace) -> None:
    """ValueError when the spec lies outside the reference's domain."""
    want = dict(input_size=128, downsample_blocks=(2, 5, 11), tap88_block=10)
    for name, value in want.items():
        if getattr(spec, name) != value:
            raise ValueError(f"apply_fused serves {name}={value} (the JAX "
                             f"function's segments), got "
                             f"{getattr(spec, name)}")
    if len(spec.block_channels) != 16:
        raise ValueError(f"apply_fused serves 16 blocks, got "
                         f"{len(spec.block_channels)}")
    chans = (spec.stem_features, *spec.block_channels)
    for i, (cin, cout) in enumerate(zip(chans, chans[1:])):
        if cout < cin:
            raise ValueError(f"block {i} narrows {cin} -> {cout}")
    if not 89 <= spec.block_channels[11] <= 96:
        raise ValueError(f"apply_fused serves block 11 of 89-96 channels "
                         f"(segment D's input is 96 rows), got "
                         f"{spec.block_channels[11]}")
    if max(chans) > MAX_CHANNELS:
        raise ValueError(f"apply_fused takes at most {MAX_CHANNELS} channels "
                         "per layer")


def split_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of a float32 tensor: hi = bf16(t), lo = bf16(t - hi), both
    round-to-nearest-even, returned as float32 tensors (bf16 values).
    t - hi is exact in float32, and hi + lo holds t to 2^-17 relative."""
    hi = t.to(torch.bfloat16).to(torch.float32)
    return hi, (t - hi).to(torch.bfloat16).to(torch.float32)


# ------------------------------------------------------------------ weights
def _bf16_leaves(net: BlazeFaceNet):
    """Per segment block: w_hi and w_lo, (Np, Kp) [out][in], zero-padded to
    the mma tile (Np = Cout rounded up to 8, Kp = Cin rounded up to 16)."""
    for i in _BLOCKS:
        w = net.blocks[i].pw.weight[:, :, 0, 0]
        cout, cin = w.shape
        pad = w.new_zeros((_round_up(cout, 8), _round_up(cin, 16)))
        for part in split_bf16(w):
            p = pad.clone()
            p[:cout, :cin] = part
            yield p


@dataclasses.dataclass(frozen=True)
class SegmentPack:
    """The backbone's weights in the kernels' layout.  `f32` is the fp32
    backbone's pack (`backbone.backbone_pack`: the stem, then per block dw
    (3, 3, Cin), dw bias, pw (Cin, Cout), pw bias): the stem, block 11 and
    the segments' depthwise taps and biases come from it.  `bf16` holds
    w_hi and w_lo per segment block, in the order of `SEGMENTS`' blocks
    (0-10, 12-15)."""
    f32: Packed
    bf16: Packed
    shapes: tuple[tuple[int, int], ...]    # (Np, Kp) per segment block

    def f32_offsets(self, block: int) -> tuple[int, int, int]:
        """Where block `block`'s dw, dw bias and pw bias start in `f32`."""
        off = self.f32.offsets[2 + 4 * block:6 + 4 * block]
        return off[0], off[1], off[3]

    def w_hi(self, block: int) -> torch.Tensor:
        """Block `block`'s w_hi, (Np, Kp) bfloat16."""
        return self._w(block, 0)

    def w_lo(self, block: int) -> torch.Tensor:
        return self._w(block, 1)

    def bf16_offsets(self, block: int) -> tuple[int, int]:
        """Where block `block`'s w_hi and w_lo start in `bf16`."""
        j = _BLOCKS.index(block)
        return self.bf16.offsets[2 * j], self.bf16.offsets[2 * j + 1]

    def _w(self, block: int, part: int) -> torch.Tensor:
        n, k = self.shapes[_BLOCKS.index(block)]
        off = self.bf16_offsets(block)[part]
        return self.bf16.weights[off:off + n * k].view(n, k)


def pack_backbone(net: BlazeFaceNet) -> SegmentPack:
    """`net`'s weights for the split-bf16 backbone, each pack built once per
    module (re-packed when a parameter changes; `packing.packed`)."""
    chans = (net.spec.stem_features, *net.spec.block_channels)
    shapes = tuple((_round_up(chans[i + 1], 8), _round_up(chans[i], 16))
                   for i in _BLOCKS)
    current = stamp(net)             # one walk of the parameters for both
    return SegmentPack(kbb.backbone_pack(net, current),
                       packed(net, _bf16_leaves, torch.bfloat16, current),
                       shapes)


# ------------------------------------------------------------ plain version
def _check_segment_input(net: BlazeFaceNet, x: torch.Tensor,
                         seg: str) -> tuple[int, int, int, int]:
    """(first, last, H, Cin) of a segment, or ValueError."""
    _check_domain(net.spec)
    if seg not in SEGMENTS:
        raise ValueError(f"seg must be one of {sorted(SEGMENTS)}, got {seg!r}")
    first, last, h = SEGMENTS[seg]
    cin = (net.spec.stem_features, *net.spec.block_channels)[first]
    if x.ndim != 4 or tuple(x.shape[1:]) != (h, h, cin):
        raise ValueError(f"segment {seg} takes (B, {h}, {h}, {cin}), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    return first, last, h, cin


def _stride(net: BlazeFaceNet, i: int) -> int:
    return 2 if i in net.spec.downsample_blocks else 1


@torch.no_grad()
def run_segment_plain(net: BlazeFaceNet, x: torch.Tensor, seg: str):
    """Segment `seg`'s blocks in plain torch ops on NHWC x: the fp32
    depthwise (shifted multiply-adds), the pointwise as (x_hi@w_hi +
    x_lo@w_hi) + x_hi@w_lo, fp32 products of the split parts (exact), then
    the bias, the skip and the ReLU."""
    first, last, _, _ = _check_segment_input(net, x, seg)
    y = x
    for i in range(first, last + 1):
        blk = net.blocks[i]
        stride = _stride(net, i)
        t = kbb._depthwise(y, blk.dw.weight[:, 0].permute(1, 2, 0),
                           blk.dw.bias, stride)
        w_hi, w_lo = split_bf16(blk.pw.weight[:, :, 0, 0].t())
        x_hi, x_lo = split_bf16(t.reshape(-1, t.shape[-1]))
        p = (x_hi @ w_hi + x_lo @ w_hi) + x_hi @ w_lo
        t = p.reshape(*t.shape[:3], -1) + blk.pw.bias
        y = kbb._finish(t, y, stride)
    return y


def _check_input(net: BlazeFaceNet, x: torch.Tensor) -> None:
    _check_domain(net.spec)
    if x.ndim != 4 or tuple(x.shape[1:]) != (128, 128, 3):
        raise ValueError(f"x must be (B, 128, 128, 3), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")


@torch.no_grad()
def apply_fused_plain(net: BlazeFaceNet, x: torch.Tensor):
    """The whole backbone as the JAX apply_fused composes it, in plain torch
    ops: the fp32 stem, segments A-C, block 11 in fp32, segment D.  It does
    not call `BlazeFaceNet.forward`."""
    _check_input(net, x)
    w = list(kbb._leaves(net))
    y = torch.relu(kbb._stem(x, w[0], w[1]))
    for seg in "ABC":
        y = run_segment_plain(net, y, seg)
    feat88 = y
    y = kbb._block(y, *w[2 + 4 * 11:6 + 4 * 11], _stride(net, 11))
    return feat88, run_segment_plain(net, y, "D")


# ------------------------------------------------------------------ kernel
@torch.no_grad()
def run_segment_cuda(net: BlazeFaceNet, x: torch.Tensor, seg: str,
                     pack: SegmentPack | None = None) -> torch.Tensor:
    """The kernel: what `run_segment_plain` computes, on a CUDA device, one
    launch per block on the current stream, without synchronising.  `pack`
    is `pack_backbone(net)`, when the caller holds it.  Raises on anything
    the kernel does not take, and when a launch fails."""
    first, last, h, cin = _check_segment_input(net, x, seg)
    kbb._check_cuda(net, x)
    pack = pack if pack is not None else pack_backbone(net)
    blocks = range(first, last + 1)
    channels = net.spec.block_channels[first:last + 1]
    strides = [_stride(net, i) for i in blocks]
    B = x.shape[0]
    sizes, hh = [], h
    for s in strides:
        hh //= s
        sizes.append(hh)
    out = x.new_empty((B, sizes[-1], sizes[-1], channels[-1]))
    if B == 0:
        return out
    scratch = B * max([1] + [s * s * c for s, c in zip(sizes[:-1],
                                                       channels[:-1])])
    buf_a, buf_b = x.new_empty(scratch), x.new_empty(scratch)
    with torch.cuda.device(x.device):
        err = LIBRARY.load().headpose_backbone2_segment(
            x.data_ptr(), pack.f32.weights.data_ptr(),
            c_ints(o for i in blocks for o in pack.f32_offsets(i)),
            pack.bf16.weights.data_ptr(),
            c_ints(o for i in blocks for o in pack.bf16_offsets(i)),
            c_ints(channels), c_ints(strides), len(channels), h, cin,
            buf_a.data_ptr(), buf_b.data_ptr(), out.data_ptr(), B,
            torch.cuda.current_stream().cuda_stream)
    kbb._raise_on(err, f"segment {seg} kernel")
    run_segment.launches += 1
    return out


@torch.no_grad()
def apply_fused_cuda(net: BlazeFaceNet, x: torch.Tensor):
    """The kernels: what `apply_fused_plain` computes, on a CUDA device: the
    fp32 stem, segments A-C, block 11 in fp32, segment D (17 grids), on the
    current stream, without synchronising."""
    _check_input(net, x)
    kbb._check_cuda(net, x)
    pack = pack_backbone(net)        # checked against the weights once
    y = kbb.stem_forward_cuda(net, x, pack.f32)
    for seg in "ABC":
        y = run_segment_cuda(net, y, seg, pack)
    feat88 = y
    y = kbb.block_forward_cuda(net, 11, y, pack.f32)
    feat96 = run_segment_cuda(net, y, "D", pack)
    apply_fused.launches += 1
    return feat88, feat96


def run_segment(net: BlazeFaceNet, x: torch.Tensor, seg: str) -> torch.Tensor:
    """Segment `seg` of the backbone over its NHWC input: the CUDA kernel
    for a tensor on a CUDA device, the plain version for a tensor on the
    CPU.  `run_segment.launches` counts the segments launched."""
    if x.device.type == "cpu":
        return run_segment_plain(net, x, seg)
    return run_segment_cuda(net, x, seg)


def apply_fused(net: BlazeFaceNet, x: torch.Tensor):
    """(feat88, feat96) NHWC of x (B, 128, 128, 3): the CUDA kernels for a
    tensor on a CUDA device, the plain version for a tensor on the CPU.

    `apply_fused.launches` counts the calls that launched the kernels (one
    per call: the stem, the four segments and block 11)."""
    if x.device.type == "cpu":
        return apply_fused_plain(net, x)
    return apply_fused_cuda(net, x)


run_segment.launches = 0
apply_fused.launches = 0
