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
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

__all__ = ["BlazeFace", "BlazeFaceNet", "BLAZEFACE_FRONT", "BLAZEFACE_BACK"]


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x
        if self.stride == 2:
            x = _pad_same(x, 3, 2)
            # ceil_mode is TF SAME for a 2x2/2 window (odd edges pad with -inf)
            skip = F.max_pool2d(skip, 2, 2, ceil_mode=True)
        t = self.pw(self.dw(x))
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

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        B = x.shape[0]
        y = torch.relu(self.stem(_pad_same(x.permute(0, 3, 1, 2), 5, 2)))
        feat88 = None
        for i, block in enumerate(self.blocks):
            y = block(y)
            if i == self.spec.tap88_block:
                feat88 = y
        feat96 = y
        scores = torch.cat([_nhwc(self.cls_front(feat88)).reshape(B, -1),
                            _nhwc(self.cls_back(feat96)).reshape(B, -1)], 1)
        loc = torch.cat([_nhwc(self.loc_front(feat88)).reshape(B, -1, 16),
                         _nhwc(self.loc_back(feat96)).reshape(B, -1, 16)], 1)
        return {"feat88": _nhwc(feat88).contiguous(),
                "feat96": _nhwc(feat96).contiguous(),
                "scores": scores, "loc": loc}
