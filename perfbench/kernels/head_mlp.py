"""Kernel #4, the MLP pose head (csrc/head_mlp.cu: `mlp_head_kernel<R>`),
one launch a head of kind "mlp" over every cell of its map.

Work: every multiply-add 2, bias and activation 1 each, fp32 on the CUDA
cores; bytes: the rows read once, the outputs written once, the weights
once."""
from __future__ import annotations

from . import peaks


def matches(name: str) -> bool:
    return "mlp_head_kernel" in name


def map_cells(bb: dict) -> dict:
    """Cells of the tap map (head88) and the last map (head96)."""
    h = bb["input_size"] // 2
    for i in range(bb["tap88_block"] + 1):
        h //= 2 if i in bb["downsample_blocks"] else 1
    h88 = h
    for i in range(bb["tap88_block"] + 1, len(bb["block_channels"])):
        h //= 2 if i in bb["downsample_blocks"] else 1
    return {"head88": h88 * h88, "head96": h * h}


def work(spec: dict, B: int) -> tuple[int, int]:
    """(fp32 operations, bytes) of the heads of kind "mlp" over B frames'
    maps."""
    ops = nbytes = 0
    for name, cells in map_cells(spec["backbone"]).items():
        if spec[name]["kind"] != "mlp":
            continue
        n, cin = B * cells, spec[name]["in_features"]
        nbytes += 4 * n * (cin + spec[name]["layers"][-1][0])
        for cout, _ in spec[name]["layers"]:
            ops += n * (2 * cin * cout + 2 * cout)
            nbytes += 4 * (cin * cout + cout)
            cin = cout
    return ops, nbytes


def bound_s(spec: dict, B: int) -> float:
    ops, nbytes = work(spec, B)
    return peaks.bound_s(nbytes=nbytes, fp32=ops)
