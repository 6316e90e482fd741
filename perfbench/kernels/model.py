"""The model's own operations a frame: the separable network as the spec
describes it (stem, each block's depthwise and pointwise convs, the four
SSD heads, both pose heads over every cell of their maps, each by its
kind's `flops`, perfbench/reference/heads/<kind>.py) and the two bicubic
resize products where a frame is resized.  A multiply-add counts 2;
biases and activations are left out.  Not the dense composition a TPU
runs, nor a kernel's extra passes: the work the model asks for."""
from __future__ import annotations

from ..harness.cells import PERFBENCH
from ..reference.image import resize_flops
from ..reference.model import HEADS, head_kind
from .head_mlp import map_cells


def network_flops(spec: dict, root: str = PERFBENCH) -> int:
    bb = spec["backbone"]
    h = bb["input_size"] // 2
    flops = 2 * h * h * 25 * 3 * bb["stem_features"]
    cin = bb["stem_features"]
    for i, cout in enumerate(bb["block_channels"]):
        h //= 2 if i in bb["downsample_blocks"] else 1
        flops += 2 * h * h * 9 * cin + 2 * h * h * cin * cout
        cin = cout
    cells = map_cells(bb)
    c88 = bb["block_channels"][bb["tap88_block"]]
    c96 = bb["block_channels"][-1]
    flops += 2 * cells["head88"] * c88 * (bb["cls_channels"][0]
                                          + bb["loc_channels"][0])
    flops += 2 * cells["head96"] * c96 * (bb["cls_channels"][1]
                                          + bb["loc_channels"][1])
    for name in HEADS:
        flops += head_kind(spec[name]["kind"], root).flops(spec[name],
                                                           cells[name])
    return flops


def flops_per_frame(spec: dict, frame_hw: tuple[int, int]) -> int:
    size = spec["backbone"]["input_size"]
    return network_flops(spec) + resize_flops(*frame_hw, size)
