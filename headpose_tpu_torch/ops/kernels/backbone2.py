"""The split-bf16 BlazeFace backbone on the card: wrapper of csrc/backbone2.cu.

`apply_fused(net, x)` is the counterpart of the TPU function
headpose_tpu/ops/pallas/backbone2.py::apply_fused: the backbone of `net` (a
`BlazeFaceNet`) over x (B, S, S, 3) float32 NHWC, returning NHWC (feat88,
feat96: the tap block's output and the last block's).  The stem runs in
fp32; the blocks run in segments (`segment_plan`, `run_segment`) whose
pointwise 1x1 is a 3-pass split-bf16 product with fp32 accumulation (x_hi.
w_hi + x_lo.w_hi + x_hi.w_lo, `split_bf16`) and whose depthwise stays in
fp32.  That is the TPU's 'high' matmul precision, the precision of the
detector's precision='fast' mode.

The plan follows the spec.  A spec inside the JAX function's own domain (the
front topology: input 128, 16 blocks, downsample blocks (2, 5, 11), tap
block 10, block 11 of 89-96 channels) takes its segment table, `SEGMENTS`:
A 0-2, B 3-5, C 6-10, D 12-15, with block 11 in fp32 as the JAX function
runs it.  Any other spec within the kernel's limits (a square input that
every stride-2 layer halves exactly, channels that never narrow, at most 128
channels) runs every block split-bf16, in segments that start at the first
block, at each downsample block and after the tap: the JAX detector's "fast"
composes such a spec densely with every block at 'high'
(headpose_tpu/runtime/detector.py:268-278), so no block of it has an fp32
counterpart there.  The back-camera topology (input 256) thus runs A 0-2
from a 128x128 map, B 3-5, C 6-11 and D 12-16.  A spec outside the limits
raises ValueError.

`island` (the detector's precision="turbo" and "max") lists blocks that
leave the plan: each runs as a single-pass bf16 dense block through the
island kernels (ops/kernels/dense_bf16.py, csrc/dense_bf16.cu), in block
order, and a segment that holds island blocks is cut around them (the front
model's "turbo" island 10-15 leaves A 0-2, B 3-5, C 6-9; "max", every
block, leaves no segment and only the fp32 stem of csrc/backbone.cu).  The
island's blocks launch as `dense_bf16.island_chains` groups them: a run on
the small maps in one `dense_chain` launch (the front "turbo" island 10-15
in one; "max" blocks 0-5 one `dense_block` launch each, then 6-15 in one).

A tensor on the CPU goes through the plain versions (`run_segment_plain`,
`apply_fused_plain`), which repeat the arithmetic in plain torch ops; a
tensor on a CUDA device goes through the hand-written kernels, or the call
raises.  Nothing else selects between the two.  On the card the stem and
any fp32 block are launches of csrc/backbone.cu (`backbone.stem_forward_
cuda`, `backbone.block_forward_cuda`) and each segment one call of
csrc/backbone2.cu: a persistent launch per large-map or stride-2 block, and
one launch for each run of stride-1 blocks whose map fits in shared memory
(`segment_launches`).  Every launch goes through an op of
ops/kernels/library.py (`backbone2_segment`, `backbone_stem`,
`backbone_block`, `dense_block`, `dense_chain`), so that a program exported
by tools/aot.py holds them as nodes and counts them on replay.

The JAX function's lane coalescing (B % 8 == 0), its channel-major flat-gap
and parity-plane layouts, its block-diagonal I4 (x) W weight planes and its
`interpret` flag are TPU and Mosaic knobs with no counterpart here: any
B >= 1 is taken.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import string

import torch

from ...models.blazeface import BlazeFace, BlazeFaceNet
from . import backbone as kbb
from . import dense_bf16 as kd
from . import library as lib
from .packing import Packed, c_ints, packed, stamp

__all__ = ["SEGMENTS", "SPLIT_TOL", "segment_plan", "split_bf16",
           "pack_backbone", "SegmentPack", "run_segment", "run_segment_plain",
           "run_segment_cuda", "segment_launches", "segment_inputs",
           "apply_fused",
           "apply_fused_plain", "apply_fused_cuda", "LIBRARY"]

MAX_CHANNELS = 128   # 16 n-tiles of 8 output channels in registers

# How far two implementations of the split-bf16 arithmetic may lie apart:
# wherever they differ by an ulp before a split (another sum order), the lo
# half can round the other way, a step of 2^-17 of the value.  The JAX
# function's own Pallas segments lie up to 1.57e-4 from the plain version
# on the parity corpus's largest maps (21.9, where one step is 1.7e-4;
# tests/test_torch_backbone2.py): within a bare 2e-4, but with room for one
# step only.  So the bound is 2e-4 plus four steps (2^-15) of the value.
SPLIT_TOL = dict(rtol=2.0 ** -15, atol=2e-4)

# Segment: (first block, last block, input resolution), as the JAX table
# (backbone2.py:93-98).  Block 11 and the stem run outside, in fp32.
SEGMENTS = {
    "A": (0, 2, 64),
    "B": (3, 5, 32),
    "C": (6, 10, 16),
    "D": (12, 15, 8),
}


LIBRARY = lib.LIBRARIES["backbone2"]
SOURCE = LIBRARY.sources[0]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _channels(spec: BlazeFace) -> tuple[int, ...]:
    return (spec.stem_features, *spec.block_channels)


def _check_limits(spec: BlazeFace) -> None:
    """ValueError when the spec lies outside the kernel's limits."""
    s, n = spec.input_size, len(spec.block_channels)
    if s <= 0 or s % 2 ** (1 + len(spec.downsample_blocks)):
        raise ValueError(f"apply_fused needs an input size that the stem and "
                         f"every downsample block halve exactly, got {s} for "
                         f"{len(spec.downsample_blocks)} downsample blocks")
    if not 0 <= spec.tap88_block < n:
        raise ValueError(f"tap88_block {spec.tap88_block} is not one of the "
                         f"{n} blocks")
    chans = _channels(spec)
    for i, (cin, cout) in enumerate(zip(chans, chans[1:])):
        if cout < cin:
            raise ValueError(f"block {i} narrows {cin} -> {cout}")
    if max(chans) > MAX_CHANNELS:
        raise ValueError(f"apply_fused takes at most {MAX_CHANNELS} channels "
                         "per layer")


def _reference_domain(spec: BlazeFace) -> bool:
    """Does the JAX apply_fused's own segment table serve this spec?"""
    return (spec.input_size == 128 and spec.downsample_blocks == (2, 5, 11)
            and spec.tap88_block == 10 and len(spec.block_channels) == 16
            and 89 <= spec.block_channels[11] <= 96)


def island_blocks(spec: BlazeFace, island=()) -> tuple[int, ...]:
    """`island` as sorted distinct block indices; ValueError when one is not
    a block of `spec`."""
    island = tuple(sorted({int(i) for i in island}))
    n = len(spec.block_channels)
    bad = [i for i in island if not 0 <= i < n]
    if bad:
        raise ValueError(f"island blocks {bad} are not blocks of this spec "
                         f"(0..{n - 1})")
    return island


@functools.lru_cache(maxsize=64)
def segment_plan(spec: BlazeFace,
                 island: tuple[int, ...] = ()) -> dict[str, tuple[int, int,
                                                                 int]]:
    """The segments of the split-bf16 backbone of `spec`, in order: name ->
    (first block, last block, input resolution).  Blocks in no segment run
    in fp32, or, when in `island`, through the island kernel.  `SEGMENTS`
    on the JAX function's domain; otherwise every block, split at the
    downsample blocks and after the tap.  A segment that holds island blocks
    is cut around them: its first piece keeps its name, the next ones take
    the name and a number (C, C2, ...).  ValueError outside the kernel's
    limits and for an island block the spec does not have."""
    _check_limits(spec)
    island = island_blocks(spec, island)
    sizes = [h for *_, h in kd._shapes(spec)]    # the map in front of each
    n = len(spec.block_channels)
    if _reference_domain(spec):
        base = dict(SEGMENTS)
    else:
        starts = [i for i in range(n) if i == 0 or i in spec.downsample_blocks
                  or i == spec.tap88_block + 1]
        ends = starts[1:] + [n]
        base = {name: (first, end - 1, sizes[first]) for name, first, end
                in zip(string.ascii_uppercase, starts, ends)}
    plan = {}
    for name, (first, last, _) in base.items():
        pieces, run = [], []
        for i in range(first, last + 1):
            if i in island:
                pieces += [run] if run else []
                run = []
            else:
                run.append(i)
        pieces += [run] if run else []
        for k, run in enumerate(pieces):
            plan[name if k == 0 else f"{name}{k + 1}"] = (run[0], run[-1],
                                                          sizes[run[0]])
    return plan


def _schedule(spec: BlazeFace, island=()) -> list[tuple[str, int]]:
    """The backbone after the stem, in block order: ("segment", name),
    ("fp32", block) or ("island", block) steps.  Every step ends at or
    before the tap."""
    island = island_blocks(spec, island)
    plan = segment_plan(spec, island)
    first = {f: name for name, (f, _, _) in plan.items()}
    steps, i = [], 0
    while i < len(spec.block_channels):
        if i in first:
            steps.append(("segment", first[i]))
            i = plan[first[i]][1] + 1
        else:
            steps.append(("island" if i in island else "fp32", i))
            i += 1
    return steps


def _split_blocks(spec: BlazeFace) -> tuple[int, ...]:
    """The split-bf16 blocks of the "fast" plan, in order."""
    return tuple(i for first, last, _ in segment_plan(spec).values()
                 for i in range(first, last + 1))


def split_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of a float32 tensor: hi = bf16(t), lo = bf16(t - hi), both
    round-to-nearest-even, returned as float32 tensors (bf16 values).
    t - hi is exact in float32, and hi + lo holds t to 2^-17 relative."""
    hi = t.to(torch.bfloat16).to(torch.float32)
    return hi, (t - hi).to(torch.bfloat16).to(torch.float32)


# ------------------------------------------------------------------ weights
def _bf16_leaves(net: BlazeFaceNet):
    """Per block (every block, so that one pack serves every island): w_hi
    and w_lo, (Np, Kp) [out][in], zero-padded to the mma tile (Np = Cout
    rounded up to 8, Kp = Cin rounded up to 16): each row is a whole number
    of 16-byte chunks, and each leaf starts at a multiple of 8 elements, so
    the kernel stages them with 16-byte copies."""
    for i in range(len(net.blocks)):
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
    (3, 3, Cin), dw bias, pw (Cin, Cout), pw bias): the stem, the fp32
    blocks and the segments' depthwise taps and biases come from it.
    `bf16` holds w_hi and w_lo per block, in `blocks`' order (every block,
    whatever the plan)."""
    f32: Packed
    bf16: Packed
    blocks: tuple[int, ...]                # the blocks of `bf16`
    shapes: tuple[tuple[int, int], ...]    # (Np, Kp) per split-bf16 block

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
        j = self.blocks.index(block)
        return self.bf16.offsets[2 * j], self.bf16.offsets[2 * j + 1]

    def _w(self, block: int, part: int) -> torch.Tensor:
        n, k = self.shapes[self.blocks.index(block)]
        off = self.bf16_offsets(block)[part]
        return self.bf16.weights[off:off + n * k].view(n, k)


def pack_backbone(net: BlazeFaceNet,
                  current: tuple | None = None) -> SegmentPack:
    """`net`'s weights for the split-bf16 backbone, each pack built once per
    module (re-packed when a parameter changes; `packing.packed`).
    `current` is `packing.stamp(net)` when the caller has just taken it."""
    chans = _channels(net.spec)
    blocks = tuple(range(len(net.blocks)))
    shapes = tuple((_round_up(chans[i + 1], 8), _round_up(chans[i], 16))
                   for i in blocks)
    if current is None:
        current = stamp(net)         # one walk of the parameters for both
    return SegmentPack(kbb.backbone_pack(net, current),
                       packed(net, _bf16_leaves, torch.bfloat16, current),
                       blocks, shapes)


# ------------------------------------------------------------ plain version
def _check_segment_input(net: BlazeFaceNet, x: torch.Tensor, seg: str,
                         island=()) -> tuple[int, int, int, int]:
    """(first, last, H, Cin) of a segment of the plan with `island`, or
    ValueError."""
    plan = segment_plan(net.spec, island_blocks(net.spec, island))
    if seg not in plan:
        raise ValueError(f"seg must be one of {sorted(plan)}, got {seg!r}")
    first, last, h = plan[seg]
    cin = _channels(net.spec)[first]
    if x.ndim != 4 or tuple(x.shape[1:]) != (h, h, cin):
        raise ValueError(f"segment {seg} takes (B, {h}, {h}, {cin}), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    return first, last, h, cin


def _stride(net: BlazeFaceNet, i: int) -> int:
    return 2 if i in net.spec.downsample_blocks else 1


@torch.no_grad()
def run_segment_plain(net: BlazeFaceNet, x: torch.Tensor, seg: str,
                      island=()):
    """Segment `seg`'s blocks (of the plan with `island`) in plain torch ops
    on NHWC x: the fp32 depthwise (shifted multiply-adds), the pointwise as
    (x_hi@w_hi + x_lo@w_hi) + x_hi@w_lo, fp32 products of the split parts
    (exact), then the bias, the skip and the ReLU."""
    first, last, _, _ = _check_segment_input(net, x, seg, island)
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


def _check_input(net: BlazeFaceNet, x: torch.Tensor, island=()) -> None:
    segment_plan(net.spec, island_blocks(net.spec, island))
    s = net.spec.input_size
    if x.ndim != 4 or tuple(x.shape[1:]) != (s, s, 3):
        raise ValueError(f"x must be (B, {s}, {s}, 3), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")


def _compose(net: BlazeFaceNet, y: torch.Tensor, island, segment,
             fp32_block, island_block, chain):
    """The blocks after the stem, as `_schedule` orders them with `island`,
    the island's blocks launched as `dense_bf16.island_chains` groups them:
    island_block(y, i) for a block alone, chain(y, first, last) -> (y, tap
    map or None) for a chain.  Returns (feat88, feat96)."""
    plan = segment_plan(net.spec, island)
    chains = {step[1]: step[2] for step in kd.island_chains(net.spec, island)
              if step[0] == "chain"}
    feat88, tap, skip_to = None, net.spec.tap88_block, -1
    for kind, key in _schedule(net.spec, island):
        if kind == "island" and key <= skip_to:
            continue                          # inside a chain already run
        if kind == "island" and key in chains:
            skip_to = chains[key]
            y, t = chain(y, key, skip_to)
            feat88 = t if t is not None else feat88
            continue
        y = {"segment": segment, "fp32": fp32_block,
             "island": island_block}[kind](y, key)
        if (plan[key][1] if kind == "segment" else key) == tap:
            feat88 = y
    return feat88, y


@torch.no_grad()
def apply_fused_plain(net: BlazeFaceNet, x: torch.Tensor, island=()):
    """The whole backbone as the plan composes it, in plain torch ops: the
    fp32 stem, then each segment, each block outside the segments in fp32
    (on the front topology: segments A-C, block 11, segment D, as the JAX
    apply_fused) and the island as `dense_bf16.island_chains` launches it,
    each block alone as `dense_bf16.dense_block_plain` and each chain as
    `dense_bf16.dense_chain_plain` (the same blocks composed, so the same
    numbers as block after block).  It does not call
    `BlazeFaceNet.forward`."""
    _check_input(net, x, island)
    island = island_blocks(net.spec, island)
    w = list(kbb._leaves(net))
    return _compose(
        net, torch.relu(kbb._stem(x, w[0], w[1])), island,
        lambda y, seg: run_segment_plain(net, y, seg, island),
        lambda y, i: kbb._block(y, *w[2 + 4 * i:6 + 4 * i], _stride(net, i)),
        lambda y, i: kd.dense_block_plain(net, i, y),
        lambda y, first, last: kd.dense_chain_plain(net, first, last, y))


# ------------------------------------------------------------------ kernel
def _segment_args(net: BlazeFaceNet, seg: str, island=()):
    first, last, h = segment_plan(net.spec,
                                  island_blocks(net.spec, island))[seg]
    blocks = range(first, last + 1)
    return (blocks, net.spec.block_channels[first:last + 1],
            [_stride(net, i) for i in blocks], h, _channels(net.spec)[first])


def segment_launches(net: BlazeFaceNet, seg: str, island=()) -> list[int]:
    """The kernel launches of segment `seg` (of the plan with `island`) on
    the card: the number of blocks each one runs, in order (a run of
    stride-1 blocks whose map fits in a CTA's shared memory is one launch of
    chain_kernel; every other block one of block_kernel).  Builds the
    library."""
    _, channels, strides, h, cin = _segment_args(net, seg, island)
    sizes = (ctypes.c_int * len(channels))()
    n = lib.library("backbone2").headpose_backbone2_groups(
        c_ints(channels), c_ints(strides), len(channels), h, cin, sizes)
    return list(sizes[:n])


@torch.no_grad()
def run_segment_cuda(net: BlazeFaceNet, x: torch.Tensor, seg: str,
                     pack: SegmentPack | None = None,
                     island=(), opens: bool = False) -> torch.Tensor:
    """The kernel: what `run_segment_plain` computes, on a CUDA device, on
    the current stream, without synchronising: one call of the op
    `headpose_tpu_torch::backbone2_segment`.  `pack` is
    `pack_backbone(net)`, when the caller holds it; `opens` is set by
    `apply_fused_cuda` on its plan's first segment, whose launch counts the
    call.  Raises on anything the kernel does not take, and when a launch
    fails."""
    _check_segment_input(net, x, seg, island)
    kbb._check_cuda(net, x)
    pack = pack if pack is not None else pack_backbone(net)
    blocks, channels, strides, _, _ = _segment_args(net, seg, island)
    return lib.backbone2_segment(
        x, pack.f32.weights, [o for i in blocks for o in pack.f32_offsets(i)],
        pack.bf16.weights, [o for i in blocks for o in pack.bf16_offsets(i)],
        list(channels), strides, opens)


@torch.no_grad()
def apply_fused_cuda(net: BlazeFaceNet, x: torch.Tensor, island=()):
    """The kernels: what `apply_fused_plain` computes, on a CUDA device: the
    fp32 stem, each segment, each fp32 block, each island block alone and
    each chain of the island, on the current stream, without
    synchronising."""
    _check_input(net, x, island)
    kbb._check_cuda(net, x)
    island = island_blocks(net.spec, island)
    current = stamp(net)             # one walk of the parameters for all
    pack = pack_backbone(net, current)   # checked against the weights once
    dpack = kd.dense_pack(net, current) if island else None
    first = next(iter(segment_plan(net.spec, island)), None)
    return _compose(
        net, kbb.stem_forward_cuda(net, x, pack.f32), island,
        lambda y, seg: run_segment_cuda(net, y, seg, pack, island,
                                        opens=seg == first),
        lambda y, i: kbb.block_forward_cuda(net, i, y, pack.f32),
        lambda y, i: kd.dense_block_cuda(net, i, y, dpack),
        lambda y, first, last: kd.dense_chain_cuda(net, first, last, y,
                                                   dpack))


@torch.no_grad()
def segment_inputs(net: BlazeFaceNet, x: torch.Tensor, pack: SegmentPack,
                   island=()) -> dict:
    """Each segment's own input (keyed by its name) and each island block's
    (keyed by its index) for frames x on a CUDA device (one pass through
    the kernels, every island block alone, `dense_block_cuda`, so that the
    blocks inside a chain have their inputs too): what the tools time the
    segments, the island blocks and the chains (a chain's input is its
    first block's) alone on."""
    island = island_blocks(net.spec, island)
    dpack = kd.dense_pack(net) if island else None
    inputs = {}

    def segment(y, seg):
        inputs[seg] = y
        return run_segment_cuda(net, y, seg, pack, island)

    def island_block(y, i):
        inputs[i] = y
        return kd.dense_block_cuda(net, i, y, dpack)

    def chain(y, first, last):
        t = None
        for i in range(first, last + 1):
            y = island_block(y, i)
            t = y if i == net.spec.tap88_block else t
        return y, t

    _compose(net, kbb.stem_forward_cuda(net, x, pack.f32), island, segment,
             lambda y, i: kbb.block_forward_cuda(net, i, y, pack.f32),
             island_block, chain)
    return inputs


def run_segment(net: BlazeFaceNet, x: torch.Tensor, seg: str,
                island=()) -> torch.Tensor:
    """Segment `seg` (of the plan with `island`) of the backbone over its
    NHWC input: the CUDA kernel for a tensor on a CUDA device, the plain
    version for a tensor on the CPU.  `run_segment.launches` counts the
    segments launched."""
    if x.device.type == "cpu":
        return run_segment_plain(net, x, seg, island)
    return run_segment_cuda(net, x, seg, island=island)


def apply_fused(net: BlazeFaceNet, x: torch.Tensor, island=()):
    """(feat88, feat96) NHWC of x (B, S, S, 3): the CUDA kernels for a
    tensor on a CUDA device, the plain version for a tensor on the CPU.
    `island` lists the blocks that run at single-pass bf16 through the
    island kernels (`dense_bf16.dense_block`, `dense_bf16.dense_chain`, as
    `dense_bf16.island_chains` groups them) instead of the plan.

    `apply_fused.launches` counts the calls that launched the split-bf16
    kernel (one per call whose plan has a segment: the stem, every segment
    and every fp32 block); the island's launches count on
    `dense_bf16.dense_block.launches` and `dense_bf16.dense_chain.launches`."""
    if x.device.type == "cpu":
        return apply_fused_plain(net, x, island)
    return apply_fused_cuda(net, x, island)


run_segment = lib.Counted(run_segment, "backbone2_segment")
apply_fused = lib.Counted(apply_fused, "apply_fused")
