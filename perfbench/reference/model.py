"""The unified BlazeFace network and its two pose heads, plain PyTorch.

BlazeFace (arXiv:1907.05047) on its separable path: a 5x5 stride-2 stem
with ReLU, then BlazeBlocks (depthwise 3x3, pointwise 1x1, a skip that is
max-pooled 2x2/2 on a stride-2 block and zero-padded on the channel axis
where the block widens, ReLU), SSD 1x1 heads on the tap block's map and on
the last map, flattened cell-major then anchor.  TensorFlow's SAME padding
is asymmetric at stride 2 (the smaller half before), so those convs pad
explicitly.  Each pose head runs over every cell of its map, as the
module of its kind builds it: `spec[head]["kind"]` names
`perfbench/reference/heads/<kind>.py` (`head_kind`).

The weights come from a shipped `params.npz` (JAX layout: HWIO kernels, a
depthwise kernel (3, 3, 1, C), dense `w` as (in, out)); the sizes from the
configuration's `spec`.  Everything is float32; TF32 is turned off by
`Reference`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..harness.cells import PERFBENCH, module

HEADS = ("head88", "head96")


def head_kind(kind: str, root: str = PERFBENCH):
    """The module of a head kind, `<root>/reference/heads/<kind>.py`: its
    `build(head_spec, params, prefix, device)` gives the head over (B, H,
    W, C) maps, `flops(head_spec, cells)` the model's own operations over
    `cells` cells (a multiply-add 2), and `COUPLES_CELLS` whether a cell's
    answer depends on the map's other cells."""
    return module("reference/heads", kind, root)


def pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF SAME zero padding of an NCHW map for a k x k window at stride s."""
    h, w = x.shape[-2:]
    ph = max((-(-h // s) - 1) * s + k - h, 0)
    pw = max((-(-w // s) - 1) * s + k - w, 0)
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


class Network:
    """The network of one spec with its weights on `device`."""

    def __init__(self, spec: dict, params_path: str, device,
                 root: str = PERFBENCH):
        z = np.load(params_path)

        def t(key):
            return torch.from_numpy(np.asarray(z[key], np.float32)).to(device)

        def hwio(key):                       # HWIO → OIHW
            return t(key).permute(3, 2, 0, 1).contiguous()

        bb = spec["backbone"]
        self.spec = spec
        self.stem = (hwio("backbone/stem/kernel"), t("backbone/stem/bias"))
        self.blocks = []
        for i, _ in enumerate(bb["block_channels"]):
            p = f"backbone/blocks/{i}/"
            stride = 2 if i in bb["downsample_blocks"] else 1
            self.blocks.append((hwio(p + "dw_kernel"), t(p + "dw_bias"),
                                hwio(p + "pw_kernel"), t(p + "pw_bias"),
                                stride))
        self.ssd = {name: (hwio(f"backbone/{name}/kernel"),
                           t(f"backbone/{name}/bias"))
                    for name in ("cls_front", "cls_back", "loc_front",
                                 "loc_back")}
        kinds = {name: head_kind(spec[name]["kind"], root) for name in HEADS}
        self.heads = {name: kind.build(spec[name], z, name + "/", device)
                      for name, kind in kinds.items()}
        self.coupled = [name for name, kind in kinds.items()
                        if kind.COUPLES_CELLS]

    def _block(self, x, dw, dw_b, pw, pw_b, stride):
        cin, cout = x.shape[1], pw.shape[0]
        if stride == 2:
            y = F.conv2d(pad_same(x, 3, 2), dw, dw_b, stride=2, groups=cin)
            skip = F.max_pool2d(x, 2, 2, ceil_mode=True)
        else:
            y = F.conv2d(x, dw, dw_b, padding=1, groups=cin)
            skip = x
        y = F.conv2d(y, pw, pw_b)
        if cout > cin:
            skip = F.pad(skip, (0, 0, 0, 0, 0, cout - cin))
        return torch.relu(y + skip)

    def taps(self, x: torch.Tensor) -> tuple:
        """x (B, S, S, 3) NHWC in [-1, 1] → the tap block's map and the
        last map, NCHW."""
        w, b = self.stem
        y = torch.relu(F.conv2d(pad_same(x.permute(0, 3, 1, 2), 5, 2), w, b,
                                stride=2))
        tap = self.spec["backbone"]["tap88_block"]
        f88 = None
        for i, blk in enumerate(self.blocks):
            y = self._block(y, *blk)
            if i == tap:
                f88 = y
        return f88, y

    def __call__(self, x: torch.Tensor) -> dict:
        """x (B, S, S, 3) NHWC in [-1, 1] → scores (B, A) logits, loc
        (B, A, 16), pose_front (B, 16, 16, 3), pose_back (B, 8, 8, 3)."""
        B = x.shape[0]
        f88, f96 = self.taps(x)

        def head(name, f):
            return F.conv2d(f, *self.ssd[name]).permute(0, 2, 3, 1)

        scores = torch.cat([head("cls_front", f88).reshape(B, -1),
                            head("cls_back", f96).reshape(B, -1)], 1)
        loc = torch.cat([head("loc_front", f88).reshape(B, -1, 16),
                         head("loc_back", f96).reshape(B, -1, 16)], 1)
        f88, f96 = f88.permute(0, 2, 3, 1), f96.permute(0, 2, 3, 1)
        return {"scores": scores, "loc": loc,
                "pose_front": self.heads["head88"](f88),
                "pose_back": self.heads["head96"](f96)}
