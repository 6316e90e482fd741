"""Island blocks at single-pass bf16 on the card: wrappers of
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
`dense_chain(net, first, last, x)` runs blocks first..last so, in order, in
one launch, and returns (the last map, the tap block's map or None).

`island_chains(spec, island)` is the island's plan, by shape alone: every
maximal run of consecutive island blocks on small maps (the 16x16 and 8x8
maps of both specs, the stride-2 block between them included) is one chain
when its layout fits a block's shared memory (`chain_plan`, a mirror of the
kernel's layout), and every other island block runs alone (the block kernel
picks its own tiles).
The detector's precision="turbo" and "max" run their islands so
(`backbone2.apply_fused(..., island=...)`).

A tensor on the CPU goes through `dense_block_plain` / `dense_chain_plain`,
the module's own island step (`BlazeBlock.forward(x, dense=True,
fast=True)`: an fp32 conv of the rounded operands with TF32 off) and its
composition; a tensor on a CUDA device goes through the hand-written
kernels, or the call raises.  Nothing else selects between the two.  The
kernels launch through the ops `headpose_tpu_torch::dense_block` and
`::dense_chain` (ops/kernels/library.py); the chain's op returns the inner
tap's map, or an empty tensor where the chain has none.  The
block kernel takes Cin <= Cout <= 128 (`MAX_CHANNELS`), stride 1 or 2, and
an even map at stride 2 (as every BlazeFace spec the backbone kernels
take); a chain, in addition, maps of at most 256 pixels and channels in
multiples of 4.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from ...models.blazeface import BlazeFace, BlazeFaceNet
from . import backbone as kbb
from . import library as lib
from .packing import Packed, packed, stamp

__all__ = ["dense_block", "dense_block_plain", "dense_block_cuda",
           "dense_chain", "dense_chain_plain", "dense_chain_cuda",
           "island_chains", "chain_plan", "ChainPlan", "tile_plan",
           "dense_pack",
           "DensePack", "MAX_CHANNELS", "SMEM_MAX", "LIBRARY"]

LIBRARY = lib.LIBRARIES["dense_bf16"]
SOURCE = LIBRARY.sources[0]
MAX_CHANNELS = 128

# csrc/dense_bf16.cu's constants, which the chain's layout mirror repeats
SMEM_MAX = 232448          # a block's shared memory on sm_90
WARPS = 16                 # 512 threads
CHAIN_PIXELS = 256         # a chain's map: an m-tile a warp
MAX_CHAIN = 16             # blocks per chain launch
MAX_STAGES = 4             # taps in the chain's weight ring
SKIP_NT = 4                # n-tiles of a stride-2 chain unit
CHAIN_NT = 12              # n-tiles of any chain unit


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ------------------------------------------------------------ layouts
class ChainPlan(NamedTuple):
    """island_chain_kernel's layout for one chain: weight-ring slots,
    shared memory in bytes, the fp32 map's bytes (rounded to 16), and NT
    (the widest n-tile unit of a warp, rounded up to 4)."""
    stages: int
    smem: int
    map: int
    nt: int


def _block_takes(h: int, cin: int, cout: int, stride: int) -> bool:
    return (1 <= cin <= cout <= MAX_CHANNELS and h >= 1 and stride in (1, 2)
            and (stride == 1 or h % 2 == 0))


def _units(n_pix: int, nt: int) -> tuple[int, int, int]:
    """(m-tiles, n-tile groups, n-tiles a group): the warps' units."""
    m_tiles = _cdiv(n_pix, 16)
    groups = min(max(WARPS // m_tiles, 1), nt)
    per = _cdiv(nt, groups)
    return m_tiles, _cdiv(nt, per), per


def chain_plan(channels, strides, h: int) -> ChainPlan | None:
    """The chain kernel's layout of blocks with `channels` (n + 1 counts),
    `strides` (n) on an h x h input map (`make_chain` and `chain_layout` in
    the source): the fp32 map at each resolution's own channel stride (its
    widest map), the largest block's bf16 A operand with its halo, and as
    many ring slots of the widest tap's weights as fit (at most
    MAX_STAGES), with an 8-byte mbarrier a slot.  None when the kernel does not take the chain: a map over
    CHAIN_PIXELS, channels not multiples of 4, more than MAX_CHAIN blocks, a
    warp's unit wider than CHAIN_NT n-tiles, or fewer than 2 slots fit."""
    channels, strides = [int(c) for c in channels], [int(s) for s in strides]
    n = len(strides)
    if not 1 <= n <= MAX_CHAIN or len(channels) != n + 1:
        return None
    widest, level, lv, per = [channels[0]], [], 0, 0
    sides = []
    for k in range(n):
        cin, cout, s = channels[k], channels[k + 1], strides[k]
        if (not _block_takes(h, cin, cout, s) or cin % 4 or cout % 4
                or h * h > CHAIN_PIXELS):
            return None
        level.append(lv)
        sides.append(h)
        if s == 2:
            lv += 1
            widest.append(0)
        widest[lv] = max(widest[lv], cout)
        h //= s
        unit = _units(h * h, _round_up(cout, 8) // 8)[2]
        if (s == 2 and unit > SKIP_NT) or unit > CHAIN_NT:
            return None
        per = max(per, unit)
    map_, a, slot = 0, 0, 0
    for k in range(n):
        cin, cout, s, side = channels[k], channels[k + 1], strides[k], sides[k]
        cs_in = _round_up(widest[level[k]], 4)
        cs_out = _round_up(widest[level[k] + (s == 2)], 4)
        ho, kp = side // s, _round_up(cin, 16)
        pc, ws = (side + 2, kp // 2 + 4) if s == 1 else (side + 1,
                                                          kp // 2 + 2)
        map_ = max(map_, 4 * side * side * cs_in, 4 * ho * ho * cs_out)
        a = max(a, 4 * pc * pc * ws)
        slot = max(slot, 4 * _round_up(cout, 8) * (kp // 2 + 4))
    ring = _round_up(map_, 16) + _round_up(a, 16)
    bars = 8 * MAX_STAGES
    stages = min(max(SMEM_MAX - ring - bars, 0) // slot, MAX_STAGES)
    if stages < 2:
        return None
    return ChainPlan(stages, ring + stages * slot + bars, _round_up(map_, 16),
                     _round_up(per, 4))


def _shapes(spec: BlazeFace) -> list[tuple[int, int, int, int]]:
    """(Cin, Cout, stride, input side) of every block of `spec`."""
    chans = (spec.stem_features, *spec.block_channels)
    out, h = [], spec.input_size // 2
    for i in range(len(spec.block_channels)):
        s = 2 if i in spec.downsample_blocks else 1
        out.append((chans[i], chans[i + 1], s, h))
        h //= s
    return out


def _chain_args(spec: BlazeFace, first: int, last: int):
    """(channels, strides, input side) of blocks first..last."""
    shapes = _shapes(spec)[first:last + 1]
    return ([shapes[0][0]] + [c[1] for c in shapes], [c[2] for c in shapes],
            shapes[0][3])


@functools.lru_cache(maxsize=256)
def _island_chains(spec: BlazeFace, island: tuple[int, ...]):
    shapes = _shapes(spec)
    steps, run = [], []

    def flush():
        if run and chain_plan(*_chain_args(spec, run[0], run[-1])):
            steps.append(("chain", run[0], run[-1]))
        else:
            steps.extend(("block", i) for i in run)
        run.clear()

    for i in island:
        cin, cout, s, h = shapes[i]
        small = (h * h <= CHAIN_PIXELS and cin % 4 == 0 and cout % 4 == 0
                 and _block_takes(h, cin, cout, s))
        if not (small and run and i == run[-1] + 1):
            flush()
        if small:
            run.append(i)
        else:
            steps.append(("block", i))
    flush()
    return tuple(steps)


def island_chains(spec: BlazeFace, island=()) -> tuple[tuple, ...]:
    """The island's launches, in block order: ("block", i) for a block that
    runs alone (`dense_block`), ("chain", first, last) for a run of blocks
    in one launch (`dense_chain`).  A chain is a maximal run of
    consecutive island blocks on maps of at most CHAIN_PIXELS pixels
    (channels in multiples of 4) whose layout fits (`chain_plan`); a run
    that does not fit runs block by block.  Decided by shape alone.
    ValueError for a block `spec` does not have."""
    island = tuple(sorted({int(i) for i in island}))
    n = len(spec.block_channels)
    bad = [i for i in island if not 0 <= i < n]
    if bad:
        raise ValueError(f"island blocks {bad} are not blocks of this spec "
                         f"(0..{n - 1})")
    return _island_chains(spec, island)


def tile_plan(batch: int, h: int, cin: int, cout: int,
              stride: int) -> tuple[int, int, int] | None:
    """island_block_kernel's own launch plan of one block, from the built
    library (needs nvcc): (channel slices, output rows a tile, shared
    memory bytes), or None when the kernel does not take the block."""
    plan = (ctypes.c_int * 3)()
    rc = lib.library("dense_bf16").headpose_dense_bf16_block_plan(batch, h, cin, cout,
                                                       stride, plan)
    return tuple(plan) if rc == 0 else None


# ------------------------------------------------------------------ weights
def _kernel_leaves(net: BlazeFaceNet):
    """Per block: the composed kernel as (9, Np, Kp + 8), [tap][out][in]
    with tap = 3 a + b, zero-padded to the mma tile (Np = Cout rounded up
    to 8, Kp = Cin rounded up to 16) and each row by 8 more zeros: the
    image of the kernels' weight rows in shared memory (16 bytes longer, so
    that a warp's B-fragment loads hit 32 banks), a tap one copy.  fp32:
    `packed` rounds it to bf16 once."""
    for blk in net.blocks:
        K, _ = blk.composed()                          # (Cout, Cin, 3, 3)
        cout, cin = K.shape[:2]
        pad = K.new_zeros((9, _round_up(cout, 8), _round_up(cin, 16) + 8))
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
    """Every block's composed kernel in bf16 (`kernels`, (9, Np, Kp + 8)
    each, 16-byte aligned: what both kernels read) and its bias in fp32
    (`biases`, (Np,) each)."""
    kernels: Packed
    biases: Packed
    shapes: tuple[tuple[int, int], ...]    # (Np, Kp) per block

    def kernel(self, block: int) -> torch.Tensor:
        """Block `block`'s composed kernel, (9, Np, Kp) bfloat16: a view of
        the pack without the rows' 8 pad columns."""
        n, k = self.shapes[block]
        off = self.kernels.offsets[block]
        return self.kernels.weights[off:off + 9 * n * (k + 8)].view(
            9, n, k + 8)[:, :, :k]

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
    launch of island_block_kernel on the current stream, without
    synchronising.  `pack` is `dense_pack(net)`, when the caller holds it.
    Raises on anything the kernel does not take, and when the launch
    fails."""
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
    return lib.dense_block(x, pack.kernels.weights, pack.biases.weights,
                           pack.kernels.offsets[i], pack.biases.offsets[i],
                           cout, s)


def dense_block(net: BlazeFaceNet, i: int, x: torch.Tensor) -> torch.Tensor:
    """Block i of `net` as a single-pass bf16 island over NHWC x: the CUDA
    kernel for a tensor on a CUDA device, the plain version for a tensor on
    the CPU.  `dense_block.launches` counts the kernel's launches."""
    if x.device.type == "cpu":
        return dense_block_plain(net, i, x)
    return dense_block_cuda(net, i, x)


dense_block = lib.Counted(dense_block, "dense_block")


# ------------------------------------------------------------------ chains
def _check_chain(net: BlazeFaceNet, first: int, last: int,
                 x: torch.Tensor) -> None:
    """ValueError unless blocks first..last are one chain of the island plan
    (`island_chains`) and x is their (B, H, H, Cin) float32 input."""
    n = len(net.blocks)
    if not 0 <= first <= last < n:
        raise ValueError(f"blocks {first}..{last} are not blocks of this "
                         f"spec (0..{n - 1})")
    steps = island_chains(net.spec, range(first, last + 1))
    if steps != (("chain", first, last),):
        raise ValueError(f"blocks {first}..{last} are not a chain of the "
                         f"island plan (it runs them as {steps})")
    _check_input(net, first, x)
    h = _shapes(net.spec)[first][3]
    if x.shape[1] != h:
        raise ValueError(f"chain {first}-{last} takes (B, {h}, {h}, "
                         f"{x.shape[3]}), got {tuple(x.shape)}")


def _tap_of(net: BlazeFaceNet, first: int, last: int) -> int | None:
    """The spec's tap block when it lies in first..last, else None."""
    tap = net.spec.tap88_block
    return tap if first <= tap <= last else None


@torch.no_grad()
def dense_chain_plain(net: BlazeFaceNet, first: int, last: int,
                      x: torch.Tensor):
    """Blocks first..last of `net` as one chain, in plain torch ops over
    NHWC x: `dense_block_plain` block after block.  Returns (the last
    block's map, the tap block's map when it lies in the chain, else
    None)."""
    _check_chain(net, first, last, x)
    tap, y, t = _tap_of(net, first, last), x, None
    for i in range(first, last + 1):
        y = dense_block_plain(net, i, y)
        if i == tap:
            t = y
    return y, t


@torch.no_grad()
def dense_chain_cuda(net: BlazeFaceNet, first: int, last: int,
                     x: torch.Tensor, pack: DensePack | None = None):
    """The kernel: what `dense_chain_plain` computes, on a CUDA device, one
    launch of island_chain_kernel on the current stream, without
    synchronising.  `pack` is `dense_pack(net)`, when the caller holds it.
    Raises on anything the kernel does not take, and when the launch
    fails."""
    _check_chain(net, first, last, x)
    kbb._check_cuda(net, x)
    channels, strides, _ = _chain_args(net.spec, first, last)
    pack = pack if pack is not None else dense_pack(net)
    tap = _tap_of(net, first, last)
    inner = tap is not None and tap < last     # the kernel writes it apart
    blocks = range(first, last + 1)
    out, tap_out = lib.dense_chain(
        x, pack.kernels.weights, pack.biases.weights,
        [pack.kernels.offsets[i] for i in blocks],
        [pack.biases.offsets[i] for i in blocks], channels, strides,
        tap - first if inner else -1)
    return out, (tap_out if inner else out if tap is not None else None)


def dense_chain(net: BlazeFaceNet, first: int, last: int, x: torch.Tensor):
    """Blocks first..last of `net` (a chain of `island_chains`) as
    single-pass bf16 islands over NHWC x, in one launch: the CUDA kernel
    for a tensor on a CUDA device, the plain version for a tensor on the
    CPU.  Returns (last map, tap map or None).  `dense_chain.launches`
    counts the kernel's launches."""
    if x.device.type == "cpu":
        return dense_chain_plain(net, first, last, x)
    return dense_chain_cuda(net, first, last, x)


dense_chain = lib.Counted(dense_chain, "dense_chain")
