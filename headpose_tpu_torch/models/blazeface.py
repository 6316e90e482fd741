"""BlazeFace backbone + SSD heads, PyTorch edition.

Port of headpose_tpu/models/blazeface.py on its separable path:

  128x128x3 → 5x5/2 conv (24ch, relu) → 16 BlazeBlocks:
    channels 24,28,32*,36,42,48*,56,64,72,80,88,96*,96,96,96,96
    (* = stride-2 downsample)
  A BlazeBlock is depthwise-3x3 + pointwise-1x1 with a residual skip; the
  skip is max-pooled 2x2/2 on downsample blocks and zero-padded on the
  channel axis when channels grow, then ReLU.

The spec (`BlazeFace`) drives the network, so `BLAZEFACE_BACK` (256 input,
one more downsample stage) builds the same way.

Layout: the public forward takes and returns NHWC, like the JAX package;
the convs run NCHW inside.  Two details carry TF semantics over:

  * TF SAME padding is asymmetric at stride 2 — the 5x5/2 stem pads 1
    top/left and 2 bottom/right, the 3x3/2 depthwise 0 and 1 — so the
    stride-2 convs get an explicit F.pad and padding 0;
  * the SSD outputs are flattened anchor-major from NHWC (cell-major, then
    anchors of a cell), as the reference reshapes them.  Flattening the NCHW
    conv output directly would scramble the anchors.

`forward(x, dense=..., fast_blocks=...)` mirrors the JAX `BlazeFace.apply`
on the CPU:

  * dense=True composes each block's depthwise 3x3 and pointwise 1x1 into
    one dense 3x3 conv, K[co, ci, a, b] = pw[co, ci] * dw[ci, a, b] formed
    in fp32, with bias pw @ dw_bias + pw_bias (`BlazeBlock.composed`);
  * fast_blocks lists the blocks that run at single-pass bf16 (an island):
    each of their convs takes bf16(x) and bf16(kernel), both rounded to
    nearest even, and multiplies them in fp32 (the products of two bf16
    values are exact in fp32), bias unrounded.  That is the JAX function
    at `simulate_fast=True`, the model of the MXU's Precision.DEFAULT.
    When an island is given, the four SSD 1x1 heads run so too;
  * single_pass=True runs the whole network so, the stem too: the JAX
    function under `jax.default_matmul_precision("default")`, the
    detector's precision "default" (core/single_pass.py);
  * simulate_fast="weights" or "acts" rounds only that operand of the
    island's convs (JAX's error-decomposition probes); False rounds
    neither, the fp32 function JAX computes for an island on its CPU;
  * `tap(x, tap_blocks)` returns the listed blocks' maps as 'block{i}_out'
    (NHWC, -1 the stem's; JAX's `apply(tap_blocks=)`), running no block
    past the last of them and no SSD head: the hooks of stage-wise
    distillation (train/detector.py::distill_prefix);
  * `turbo_fast_blocks(spec)` is the island of the detector's "turbo" mode.

`BlazeFace.init(generator)` draws random parameters in JAX layout (the
trainers' start, train/detector.py).  The rounding `bf16_round` is a cast
there and back, so autograd rounds its cotangent to bf16, as the transpose
of JAX's `astype` does: the calibration trainer (train/calibrate.py)
differentiates through it.

The dense island block (`BlazeBlock.forward(x, dense=True, fast=True)`) is
the plain version of the island kernel (ops/kernels/dense_bf16.py).  TF32
is off inside every single-pass conv (`fp32_exact`), so the products stay
exact on a CUDA device too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.single_pass import bf16_round, fp32_exact
from ..utils.device import resolve_device
from .heads import _uniform

__all__ = ["BlazeFace", "BlazeFaceNet", "BLAZEFACE_FRONT", "BLAZEFACE_BACK",
           "turbo_fast_blocks", "TURBO_FAST_BLOCKS", "blazeface_from_h5",
           "blazeface_from_modeldef"]


@dataclasses.dataclass(frozen=True)
class BlazeFace:
    """BlazeFace detector configuration (front camera by default)."""

    input_size: int = 128
    stem_features: int = 24
    block_channels: tuple[int, ...] = (24, 28, 32, 36, 42, 48, 56, 64,
                                       72, 80, 88, 96, 96, 96, 96, 96)
    downsample_blocks: tuple[int, ...] = (2, 5, 11)  # stride-2 block indices
    tap88_block: int = 10   # output of this block = 16x16x88 feature map
    cls_channels: tuple[int, int] = (2, 6)    # anchors per cell, front/back grid
    loc_channels: tuple[int, int] = (32, 96)  # 16 values * anchors per cell

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters in JAX layout (float32 numpy arrays, the
        kernels HWIO, a depthwise kernel (3, 3, 1, C)): Glorot-uniform with
        JAX's limits, a conv's sqrt(6 / (fan_in + fan_out)) with fan_in =
        kh·kw·cin and fan_out = kh·kw·cout, a depthwise kernel's
        sqrt(6 / (9·cin + 9)); every bias zero.  Each kernel is one
        `uniform_` of its shape from `generator`, in this order: the stem,
        then block by block the depthwise and the pointwise kernel, then
        cls_front, cls_back, loc_front, loc_back."""
        def conv(kh, kw, cin, cout):
            lim = math.sqrt(6.0 / (kh * kw * cin + kh * kw * cout))
            return {"kernel": _uniform(generator, (kh, kw, cin, cout), lim),
                    "bias": np.zeros((cout,), np.float32)}

        params: dict = {"stem": conv(5, 5, 3, self.stem_features)}
        blocks, cin = [], self.stem_features
        for cout in self.block_channels:
            dw = _uniform(generator, (3, 3, 1, cin),
                          math.sqrt(6.0 / (9 * cin + 9)))
            pw = conv(1, 1, cin, cout)
            blocks.append({"dw_kernel": dw,
                           "dw_bias": np.zeros((cin,), np.float32),
                           "pw_kernel": pw["kernel"], "pw_bias": pw["bias"]})
            cin = cout
        params["blocks"] = blocks
        c88 = self.block_channels[self.tap88_block]
        c96 = self.block_channels[-1]
        params["cls_front"] = conv(1, 1, c88, self.cls_channels[0])
        params["cls_back"] = conv(1, 1, c96, self.cls_channels[1])
        params["loc_front"] = conv(1, 1, c88, self.loc_channels[0])
        params["loc_back"] = conv(1, 1, c96, self.loc_channels[1])
        return params


BLAZEFACE_FRONT = BlazeFace()

# Back-camera topology (256 input): one extra stride-2 stage so the SSD grids
# land on 16x16 and 8x8, matching the 896-anchor table of
# models.anchors.BACK_CONFIG.
BLAZEFACE_BACK = BlazeFace(
    input_size=256,
    block_channels=(24, 24, 28, 32, 36, 42, 48, 56, 64,
                    72, 80, 88, 96, 96, 96, 96, 96),
    downsample_blocks=(0, 3, 6, 12),
    tap88_block=11,
)


def turbo_fast_blocks(spec: BlazeFace) -> tuple[int, ...]:
    """The single-pass bf16 island of the "turbo" mode: the block that
    feeds the last downsample block, that block, and every block after it
    (the front spec's 10-15, the back spec's 11-16), as the JAX package
    defines it (models/blazeface.py::turbo_fast_blocks)."""
    return tuple(range(spec.downsample_blocks[-1] - 1,
                       len(spec.block_channels)))


TURBO_FAST_BLOCKS = turbo_fast_blocks(BLAZEFACE_FRONT)   # (10, ..., 15)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _roundings(mode: bool | str):
    """(activation rounding, weight rounding) of an island conv under a
    simulate_fast mode: True rounds both operands, "weights" or "acts" only
    that one, False neither."""
    if not mode:
        return _identity, _identity
    return (_identity if mode == "weights" else bf16_round,
            _identity if mode == "acts" else bf16_round)


def _pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF SAME zero padding of an NCHW map for a k x k window at stride s:
    the smaller half before, the larger half after."""
    h, w = x.shape[-2:]
    ph = max((-(-h // s) - 1) * s + k - h, 0)
    pw = max((-(-w // s) - 1) * s + k - w, 0)
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


class BlazeBlock(nn.Module):
    """Depthwise 3x3 + pointwise 1x1 with a residual skip, then ReLU."""

    def __init__(self, cin: int, cout: int, stride: int,
                 device: torch.device):
        super().__init__()
        if cout < cin:
            raise ValueError(f"a BlazeBlock cannot narrow {cin} -> {cout}")
        self.stride = stride
        self.grow = cout - cin
        # stride 1: SAME is the symmetric pad of 1; stride 2 pads in forward
        self.dw = nn.Conv2d(cin, cin, 3, stride=stride,
                            padding=1 if stride == 1 else 0, groups=cin,
                            device=device)
        self.pw = nn.Conv2d(cin, cout, 1, device=device)

    def composed(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The dense 3x3 conv this block's depthwise and pointwise compose
        to, in fp32: K (Cout, Cin, 3, 3) = pw[co, ci] * dw[ci, a, b] (one
        product each, exact as in the JAX function), and its bias pw @
        dw_bias + pw_bias (elementwise products summed, so no TF32)."""
        pw = self.pw.weight[:, :, 0, 0]                        # (Cout, Cin)
        K = pw[:, :, None, None] * self.dw.weight[:, 0][None]
        return K, (pw * self.dw.bias[None, :]).sum(1) + self.pw.bias

    def _conv3(self, x: torch.Tensor, w: torch.Tensor, groups: int = 1):
        if self.stride == 2:
            return F.conv2d(_pad_same(x, 3, 2), w, stride=2, groups=groups)
        return F.conv2d(x, w, padding=1, groups=groups)

    def forward(self, x: torch.Tensor, dense: bool = False,
                fast: bool | str = False) -> torch.Tensor:
        """The block over NCHW x: separable (the default) or `dense`
        (`composed`); `fast` runs its convs at single-pass bf16 (True: both
        operands rounded; "weights" or "acts": that one only).  With dense
        and True, the island step: the composed conv of bf16(x) and bf16(K)
        in fp32 (TF32 off) plus the fp32 bias, then the skip and the ReLU,
        the plain version of the island kernel (ops/kernels/dense_bf16.py)."""
        ra, rw = _roundings(fast)
        with fp32_exact() if fast else contextlib.nullcontext():
            if dense:
                K, bias = self.composed()
                t = self._conv3(ra(x), rw(K)) + bias[:, None, None]
            elif fast:
                t = self.pointwise(self.depthwise(x, fast), fast)
            else:
                t = self.pw(self.dw(_pad_same(x, 3, 2) if self.stride == 2
                                    else x))
        return self.finish(t, x)

    def depthwise(self, x: torch.Tensor,
                  fast: bool | str = True) -> torch.Tensor:
        """The separable island's first product over NCHW x: the depthwise
        3x3 of its rounded operands (as `forward`'s `fast`) in fp32, plus
        the bias unrounded."""
        ra, rw = _roundings(fast)
        with fp32_exact():
            return (self._conv3(ra(x), rw(self.dw.weight), self.dw.groups)
                    + self.dw.bias[:, None, None])

    def pointwise(self, t: torch.Tensor,
                  fast: bool | str = True) -> torch.Tensor:
        """The separable island's second product: the pointwise 1x1 of the
        depthwise output t, its operands rounded as `depthwise`'s."""
        ra, rw = _roundings(fast)
        with fp32_exact():
            return (F.conv2d(ra(t), rw(self.pw.weight))
                    + self.pw.bias[:, None, None])

    def finish(self, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """relu(t + skip): the skip is x, max-pooled 2x2/2 at stride 2 and
        zero-padded on the channel axis when the block widens."""
        skip = x
        if self.stride == 2:
            # ceil_mode is TF SAME for a 2x2/2 window (odd edges pad with -inf)
            skip = F.max_pool2d(skip, 2, 2, ceil_mode=True)
        if self.grow:
            skip = F.pad(skip, (0, 0, 0, 0, 0, self.grow))
        return torch.relu(t + skip)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class BlazeFaceNet(nn.Module):
    """The backbone + SSD heads of one `BlazeFace` spec.

    forward(x (B, S, S, 3) in [-1, 1]) returns a dict: feat88 (B, 16, 16, 88),
    feat96 (B, 8, 8, 96), scores (B, 896) logits, loc (B, 896, 16)."""

    def __init__(self, spec: BlazeFace = BLAZEFACE_FRONT, *,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.stem = nn.Conv2d(3, spec.stem_features, 5, stride=2,
                              device=device)
        blocks, cin = [], spec.stem_features
        for i, cout in enumerate(spec.block_channels):
            stride = 2 if i in spec.downsample_blocks else 1
            blocks.append(BlazeBlock(cin, cout, stride, device))
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        c88 = spec.block_channels[spec.tap88_block]
        c96 = spec.block_channels[-1]
        self.cls_front = nn.Conv2d(c88, spec.cls_channels[0], 1, device=device)
        self.cls_back = nn.Conv2d(c96, spec.cls_channels[1], 1, device=device)
        self.loc_front = nn.Conv2d(c88, spec.loc_channels[0], 1, device=device)
        self.loc_back = nn.Conv2d(c96, spec.loc_channels[1], 1, device=device)

    def forward(self, x: torch.Tensor, *, dense: bool = False,
                fast_blocks: tuple[int, ...] | None = None,
                simulate_fast: bool | str = True,
                single_pass: bool = False) -> dict[str, torch.Tensor]:
        """x (B, S, S, 3) NHWC → the dict above.  `dense` composes every
        block into one 3x3 conv; `fast_blocks` are the blocks at single-pass
        bf16, and when there are any, the SSD heads run so too (the JAX
        `BlazeFace.apply` with `simulate_fast=True`; "weights" or "acts"
        round that operand only, False neither).  The stem stays fp32.

        `single_pass=True` is the whole network at single-pass bf16, the
        JAX function under `jax.default_matmul_precision("default")`: the
        stem too, every block and the SSD heads (core/single_pass.py);
        it takes no `fast_blocks` and rounds both operands."""
        if single_pass:
            if fast_blocks is not None or simulate_fast is not True:
                raise ValueError("single_pass rounds every conv of the "
                                 "network: it takes no fast_blocks and no "
                                 "simulate_fast other than True")
            fast_blocks = range(len(self.blocks))
        fast = frozenset(fast_blocks or ())
        bad = sorted(i for i in fast if not 0 <= i < len(self.blocks))
        if bad:
            raise ValueError(f"fast_blocks {bad} are not blocks of this "
                             f"spec (0..{len(self.blocks) - 1})")
        if not (isinstance(simulate_fast, bool)
                or simulate_fast in ("weights", "acts")):
            raise ValueError(f"simulate_fast must be True, False, "
                             f"'weights' or 'acts', got {simulate_fast!r}")
        y = self._stem(x, single_pass)
        feat88 = None
        for i, block in enumerate(self.blocks):
            y = block(y, dense=dense, fast=simulate_fast if i in fast
                      else False)
            if i == self.spec.tap88_block:
                feat88 = y
        feat96 = y
        scores, loc = self.ssd(feat88, feat96,
                               simulate_fast if fast else False)
        return {"feat88": _nhwc(feat88).contiguous(),
                "feat96": _nhwc(feat96).contiguous(),
                "scores": scores, "loc": loc}

    def ssd(self, feat88: torch.Tensor, feat96: torch.Tensor,
            fast: bool | str = False) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores (B, 896), loc (B, 896, 16)) of the four SSD 1x1 heads on
        the NCHW taps, flattened anchor-major; `fast` rounds their operands
        as an island conv's (the bias unrounded)."""
        ra, rw = _roundings(fast)

        def head(conv, feat):
            if not fast:
                return _nhwc(conv(feat))
            with fp32_exact():
                return _nhwc(F.conv2d(ra(feat), rw(conv.weight))
                             + conv.bias[:, None, None])

        B = feat88.shape[0]
        scores = torch.cat([head(self.cls_front, feat88).reshape(B, -1),
                            head(self.cls_back, feat96).reshape(B, -1)], 1)
        loc = torch.cat([head(self.loc_front, feat88).reshape(B, -1, 16),
                         head(self.loc_back, feat96).reshape(B, -1, 16)], 1)
        return scores, loc

    def tap(self, x: torch.Tensor, tap_blocks: tuple[int, ...],
            single_pass: bool = False) -> dict[str, torch.Tensor]:
        """x (B, S, S, 3) NHWC → {'block{i}_out': the map after block i
        (NHWC; -1 is the stem's)} for each i in `tap_blocks`, in fp32, or
        with `single_pass` each conv at single-pass bf16, as `forward`.
        The stem and the blocks up to the last tap run, nothing past them
        (no later block, no SSD head)."""
        bad = sorted(i for i in tap_blocks
                     if not -1 <= i < len(self.blocks))
        if bad:
            raise ValueError(f"tap_blocks {bad} are not blocks of this spec "
                             f"(-1 the stem, 0..{len(self.blocks) - 1})")
        y = self._stem(x, single_pass)
        taps = {-1: y}
        last = max(tap_blocks, default=-1)
        for i, block in enumerate(self.blocks[:last + 1]):
            y = taps[i] = block(y, fast=single_pass)
        return {f"block{i}_out": _nhwc(taps[i]).contiguous()
                for i in tap_blocks}

    def _stem(self, x: torch.Tensor, single_pass: bool = False
              ) -> torch.Tensor:
        """The 5x5/2 stem and its ReLU over NHWC x, NCHW out; with
        `single_pass`, of bf16(x) and bf16(kernel) in fp32, the bias
        unrounded."""
        x = _pad_same(x.permute(0, 3, 1, 2), 5, 2)
        if not single_pass:
            return torch.relu(self.stem(x))
        with fp32_exact():
            return torch.relu(F.conv2d(bf16_round(x),
                                       bf16_round(self.stem.weight), stride=2)
                              + self.stem.bias[:, None, None])


def blazeface_from_h5(path) -> tuple[BlazeFace, dict]:
    """Backbone + SSD head weights of a reference unified H5 (a path, or a
    ModelDef parsed already) → (BLAZEFACE_FRONT, params in JAX layout)."""
    from ..core.h5io import _as_modeldef

    return blazeface_from_modeldef(_as_modeldef(path))


def blazeface_from_modeldef(md) -> tuple[BlazeFace, dict]:
    """The same import from a parsed core.h5io.ModelDef, so that a caller
    which also needs the graph (unified_from_h5) parses the file once.  The
    layer names are the reference graph's: conv2d (the stem),
    depthwise_conv2d[_i] and conv2d_{i+1} (block i), conv2d_17..20 (the SSD
    heads)."""

    def w(layer: str) -> dict[str, np.ndarray]:
        return md.layers[layer].weights

    def f32(a) -> np.ndarray:
        return np.asarray(a, np.float32)

    spec = BLAZEFACE_FRONT
    params: dict = {"stem": {"kernel": f32(w("conv2d")["kernel"]),
                             "bias": f32(w("conv2d")["bias"])}}
    blocks = []
    for i in range(len(spec.block_channels)):
        dw = w(f"depthwise_conv2d_{i}" if i else "depthwise_conv2d")
        pw = w(f"conv2d_{i + 1}")
        dwk = f32(dw["depthwise_kernel"])      # (3,3,Cin,1) → (3,3,1,Cin)
        blocks.append({"dw_kernel": dwk.reshape(3, 3, 1, dwk.shape[2]),
                       "dw_bias": f32(dw["bias"]),
                       "pw_kernel": f32(pw["kernel"]),
                       "pw_bias": f32(pw["bias"])})
    params["blocks"] = blocks
    for name, layer in [("cls_front", "conv2d_17"), ("cls_back", "conv2d_18"),
                        ("loc_front", "conv2d_19"), ("loc_back", "conv2d_20")]:
        params[name] = {"kernel": f32(w(layer)["kernel"]),
                        "bias": f32(w(layer)["bias"])}
    return spec, params
