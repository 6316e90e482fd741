"""The fused BlazeFace backbone on the card: wrapper of csrc/backbone.cu.

`backbone_forward(net, x)` is the counterpart of the TPU kernel
headpose_tpu/ops/pallas/backbone.py::backbone_forward: the 5x5/2 stem and
every BlazeBlock of `net` (a `BlazeFaceNet`) over x (B, S, S, 3) float32
NHWC, returning NHWC (feat88 (B, S/8, S/8, C88), feat96 (B, S/16, S/16,
C96)), the JAX function's layout.  A tensor on the CPU goes through
`backbone_forward_plain`, which repeats the TPU kernel's arithmetic in plain
torch ops; a tensor on a CUDA device goes through the hand-written kernels,
or the call raises.  Nothing else selects between the two.

The JAX function's `tile` (images per grid step) and `interpret` (Pallas
interpret mode) are TPU-grid knobs and have no counterpart here: the CUDA
kernels choose their own bands of rows, and the CPU path is the plain
version.

Its domain is the JAX kernel's: a spec whose taps land at S/8 and S/16
(`backbone.py:176-177`), i.e. three stride-2 blocks, the tap block after the
second, and S divisible by 16.  `BLAZEFACE_BACK` (taps at S/16 and S/32) is
outside it and raises.

`stem_forward_cuda` and `block_forward_cuda` launch the stem or one block
alone, in fp32, through the ops `headpose_tpu_torch::backbone_stem` and
`::backbone_block` (ops/kernels/library.py): the split-bf16 backbone
(`backbone2.apply_fused`) runs its stem and block 11 through them, and an
exported program (tools/aot.py) holds them as nodes.  They count no launch
of their own; the caller's wrapper counts.  `backbone_forward_cuda` (kernel
#2) is on no exported program's path (`detect` at "highest" runs the cuDNN
network, `detect_fused` is not exported): it stays a direct ctypes launch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...models.blazeface import BlazeFace, BlazeFaceNet
from . import library as lib
from .packing import Packed, c_ints, packed

__all__ = ["backbone_forward", "backbone_forward_plain",
           "backbone_forward_cuda", "backbone_pack", "stem_forward_cuda",
           "block_forward_cuda", "LIBRARY"]

LIBRARY = lib.LIBRARIES["backbone"]
SOURCE = LIBRARY.sources[0]
MAX_CHANNELS = 128   # the kernels keep up to 4 channels per lane


def _check_domain(spec: BlazeFace) -> list[int]:
    """The map size after each block, or ValueError when the spec lies
    outside the kernel's domain (the JAX kernel's: taps at S/8 and S/16)."""
    s = spec.input_size
    if s % 16:
        raise ValueError(f"backbone_forward needs an input size divisible by "
                         f"16, got {s}")
    sizes, h, cin = [], s // 2, spec.stem_features
    for i, cout in enumerate(spec.block_channels):
        h //= 2 if i in spec.downsample_blocks else 1
        sizes.append(h)
        if cout < cin:
            raise ValueError(f"block {i} narrows {cin} -> {cout}")
        cin = cout
    if sizes[spec.tap88_block] != s // 8 or sizes[-1] != s // 16:
        raise ValueError(
            f"backbone_forward serves specs whose taps land at S/8 and S/16 "
            f"(as the JAX kernel fixes them); this spec's land at "
            f"{sizes[spec.tap88_block]} and {sizes[-1]} for S={s}")
    if max(spec.stem_features, *spec.block_channels) > MAX_CHANNELS:
        raise ValueError(f"backbone_forward takes at most {MAX_CHANNELS} "
                         "channels per layer")
    return sizes


def _leaves(net: BlazeFaceNet):
    """The weights in the kernels' layout: stem (5, 5, 3, C) HWIO and bias,
    then per block dw (3, 3, Cin), dw bias, pw (Cin, Cout), pw bias."""
    yield net.stem.weight.permute(2, 3, 1, 0)
    yield net.stem.bias
    for blk in net.blocks:
        yield blk.dw.weight[:, 0].permute(1, 2, 0)
        yield blk.dw.bias
        yield blk.pw.weight[:, :, 0, 0].t()
        yield blk.pw.bias


def backbone_pack(net: BlazeFaceNet, current: tuple | None = None) -> Packed:
    """`net`'s weights in one buffer on its device (packed once per module;
    `current` as for `packing.packed`)."""
    return packed(net, _leaves, current=current)


# ------------------------------------------------------------ plain version
def _pad_hw(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    return F.pad(x, (0, 0, before, after, before, after))


def _stem(x, w, b):
    """5x5/2 conv, TF SAME (1 before, 2 after): 25 shifted (B*So*So, 3) @
    (3, C) taps."""
    B, S, _, ci = x.shape
    So = S // 2
    p = _pad_hw(x, 1, 3)              # one more row/col keeps slices in range
    acc = x.new_zeros((B, So, So, w.shape[3]))
    for di in range(5):
        for dj in range(5):
            sl = p[:, di:di + S:2, dj:dj + S:2, :]
            acc = acc + (sl.reshape(-1, ci) @ w[di, dj]).reshape(acc.shape)
    return acc + b


def _depthwise(x, w, b, stride: int):
    """3x3 depthwise conv, TF SAME (stride 1: 1/1, stride 2: 0/1): 9 shifted
    multiply-adds."""
    B, H, W, C = x.shape
    if stride == 1:
        p = _pad_hw(x, 1, 1)
        acc = torch.zeros_like(x)
        for di in range(3):
            for dj in range(3):
                acc = acc + p[:, di:di + H, dj:dj + W, :] * w[di, dj]
        return acc + b
    p = _pad_hw(x, 0, 2)
    acc = x.new_zeros((B, H // 2, W // 2, C))
    for di in range(3):
        for dj in range(3):
            acc = acc + p[:, di:di + H:2, dj:dj + W:2, :] * w[di, dj]
    return acc + b


def _maxpool2(x):
    B, H, W, C = x.shape
    r = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return torch.maximum(torch.maximum(r[:, :, 0, :, 0], r[:, :, 0, :, 1]),
                         torch.maximum(r[:, :, 1, :, 0], r[:, :, 1, :, 1]))


def _finish(t, y, stride: int):
    """relu(t + skip): the skip is y, max-pooled 2x2/2 at stride 2, zero-
    padded on the channel axis to t's width."""
    skip = _maxpool2(y) if stride == 2 else y
    if t.shape[-1] > skip.shape[-1]:
        skip = F.pad(skip, (0, t.shape[-1] - skip.shape[-1]))
    return torch.relu(t + skip)


def _block(y, dw_w, dw_b, pw_w, pw_b, stride: int):
    """One BlazeBlock in fp32: depthwise, the pointwise as a product over
    channels, bias, skip, ReLU."""
    t = _depthwise(y, dw_w, dw_b, stride)
    cin, cout = pw_w.shape
    t = (t.reshape(-1, cin) @ pw_w).reshape(*t.shape[:3], cout) + pw_b
    return _finish(t, y, stride)


def _check_input(net: BlazeFaceNet, x: torch.Tensor) -> list[int]:
    s = net.spec.input_size
    if x.ndim != 4 or tuple(x.shape[1:]) != (s, s, 3):
        raise ValueError(f"x must be (B, {s}, {s}, 3), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    return _check_domain(net.spec)


@torch.no_grad()
def backbone_forward_plain(net: BlazeFaceNet, x: torch.Tensor):
    """The TPU kernel's arithmetic in plain torch ops (NHWC): stem taps,
    shifted depthwise multiply-adds, the pointwise as a product over
    channels, the 2x2 max and the channel pad.  It does not call
    `BlazeFaceNet.forward`."""
    _check_input(net, x)
    spec = net.spec
    w = list(_leaves(net))
    y = torch.relu(_stem(x, w[0], w[1]))
    feat88 = None
    for i in range(len(spec.block_channels)):
        stride = 2 if i in spec.downsample_blocks else 1
        y = _block(y, *w[2 + 4 * i:6 + 4 * i], stride)
        if i == spec.tap88_block:
            feat88 = y
    return feat88, y


# ------------------------------------------------------------------ kernel
def _check_cuda(net: BlazeFaceNet, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    if net.stem.weight.device != x.device:
        raise ValueError(f"net is on {net.stem.weight.device}, x on "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{'a layer too wide' if err < 0 else 'CUDA error'}"
                           f" ({err})")


@torch.no_grad()
def backbone_forward_cuda(net: BlazeFaceNet, x: torch.Tensor):
    """The kernels: what `backbone_forward_plain` computes, on a CUDA device.

    One call launches the stem and one fused kernel per block on the current
    stream, without synchronising.  Raises on anything the kernels do not
    take, and when a launch fails."""
    sizes = _check_input(net, x)
    _check_cuda(net, x)
    spec = net.spec
    B, S = x.shape[0], spec.input_size
    c88 = spec.block_channels[spec.tap88_block]
    c96 = spec.block_channels[-1]
    out88 = x.new_empty((B, S // 8, S // 8, c88))
    out96 = x.new_empty((B, S // 16, S // 16, c96))
    if B == 0:
        return out88, out96
    scratch = B * max([(S // 2) ** 2 * spec.stem_features]
                      + [h * h * c for h, c in zip(sizes,
                                                   spec.block_channels)])
    buf_a, buf_b = x.new_empty(scratch), x.new_empty(scratch)
    pack = backbone_pack(net)
    n = len(spec.block_channels)
    if x.data_ptr() % 16:
        raise ValueError("x must start 16-byte aligned (the kernels stage "
                         "its rows with 16-byte copies)")
    with torch.cuda.device(x.device):
        err = lib.library("backbone").headpose_backbone_forward(
            x.data_ptr(), pack.weights.data_ptr(), c_ints(pack.offsets),
            c_ints(spec.block_channels),
            c_ints(2 if i in spec.downsample_blocks else 1 for i in range(n)),
            n, spec.stem_features, S, spec.tap88_block, buf_a.data_ptr(),
            buf_b.data_ptr(), out88.data_ptr(), out96.data_ptr(), B,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "backbone kernel")
    backbone_forward.launches += 1
    return out88, out96


@torch.no_grad()
def stem_forward_cuda(net: BlazeFaceNet, x: torch.Tensor,
                      pack: Packed | None = None) -> torch.Tensor:
    """relu(stem(x)) in fp32 on a CUDA device, one launch: x (B, S, S, 3) ->
    (B, S/2, S/2, C0).  `pack` is `backbone_pack(net)`, when the caller
    holds it.  Raises on anything the kernel does not take."""
    s = net.spec.input_size
    if x.ndim != 4 or tuple(x.shape[1:]) != (s, s, 3):
        raise ValueError(f"x must be (B, {s}, {s}, 3), got {tuple(x.shape)}")
    _check_cuda(net, x)
    pack = pack if pack is not None else backbone_pack(net)
    return lib.backbone_stem(x, pack.weights, pack.offsets[0],
                             pack.offsets[1], net.spec.stem_features)


@torch.no_grad()
def block_forward_cuda(net: BlazeFaceNet, i: int, x: torch.Tensor,
                       pack: Packed | None = None) -> torch.Tensor:
    """Block i of `net` in fp32 on a CUDA device, one launch: x (B, H, H,
    Cin) -> (B, H/s, H/s, Cout).  `pack` is `backbone_pack(net)`, when the
    caller holds it.  Raises on anything the kernel does not take."""
    blk = net.blocks[i]
    cin, cout = blk.dw.weight.shape[0], blk.pw.weight.shape[0]
    if x.ndim != 4 or x.shape[1] != x.shape[2] or x.shape[3] != cin:
        raise ValueError(f"x must be (B, H, H, {cin}), got {tuple(x.shape)}")
    if max(cin, cout) > MAX_CHANNELS:
        raise ValueError(f"block {i} is wider than {MAX_CHANNELS} channels")
    _check_cuda(net, x)
    pack = pack if pack is not None else backbone_pack(net)
    return lib.backbone_block(x, pack.weights,
                              list(pack.offsets[2 + 4 * i:6 + 4 * i]), cout,
                              blk.stride)


def backbone_forward(net: BlazeFaceNet, x: torch.Tensor):
    """(feat88, feat96) NHWC of x (B, S, S, 3): the CUDA kernels for a tensor
    on a CUDA device, the plain version for a tensor on the CPU.

    `backbone_forward.launches` counts the calls that launched the kernels
    (one per call: the stem and one launch per block)."""
    if x.device.type == "cpu":
        return backbone_forward_plain(net, x)
    return backbone_forward_cuda(net, x)


backbone_forward.launches = 0
