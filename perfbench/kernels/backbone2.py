"""Kernel #3, the split-bf16 backbone segments (csrc/backbone2.cu:
`block_kernel<NT, STRIDE>` and `chain_kernel`).

Work of the segments of a spec for B frames: each pointwise multiply-add
counts 2 on the tensor cores, three times (hi.hi, lo.hi, hi.lo); the
depthwise multiply-adds 2, its bias and the split's subtraction 1 each,
the bias, skip add and ReLU 1 each, in fp32.  Bytes: the maps that enter
the segments from outside them read once, the maps that leave them (the
two taps, an fp32 block's input) written once, the weights once (fp32 and
the bf16 hi/lo packs).  The segment table is the program's plan: on the
front topology of the flagship blocks 0-2, 3-5, 6-10 and 12-15 (block 11
in fp32); on any other spec every block, in segments that start at the
first block, at each downsample block and after the tap block.
"""
from __future__ import annotations

from . import peaks

FRONT_SEGMENTS = ((0, 2), (3, 5), (6, 10), (12, 15))


def matches(name: str) -> bool:
    return "chain_kernel" in name or ("block_kernel" in name
                                      and "bfloat16" in name)


def _front_domain(bb: dict) -> bool:
    return (bb["input_size"] == 128
            and tuple(bb["downsample_blocks"]) == (2, 5, 11)
            and bb["tap88_block"] == 10 and len(bb["block_channels"]) == 16
            and 89 <= bb["block_channels"][11] <= 96)


def segments(bb: dict) -> tuple[tuple[int, int], ...]:
    """(first, last) block of each segment of the backbone spec `bb`."""
    if _front_domain(bb):
        return FRONT_SEGMENTS
    n = len(bb["block_channels"])
    starts = [i for i in range(n) if i == 0 or i in bb["downsample_blocks"]
              or i == bb["tap88_block"] + 1]
    return tuple(zip(starts, [s - 1 for s in starts[1:]] + [n - 1]))


def work(bb: dict, B: int) -> tuple[int, int, int]:
    """(tensor-core operations, fp32 operations, bytes) for B frames."""
    chans = (bb["stem_features"], *bb["block_channels"])
    n = len(bb["block_channels"])
    h, sizes, inputs = bb["input_size"] // 2, [], []
    for i in range(n):
        inputs.append(h)
        h //= 2 if i in bb["downsample_blocks"] else 1
        sizes.append(h)
    plan = segments(bb)
    split = {i for first, last in plan for i in range(first, last + 1)}
    tc = f32 = weights = maps = 0
    for first, last in plan:
        if first - 1 not in split:
            maps += inputs[first] ** 2 * chans[first]
        if last == bb["tap88_block"] or last == n - 1 or last + 1 not in split:
            maps += sizes[last] ** 2 * chans[last + 1]
        for i in range(first, last + 1):
            cin, cout, pix = chans[i], chans[i + 1], sizes[i] ** 2
            tc += 3 * 2 * pix * cin * cout
            f32 += 2 * 9 * pix * cin + 2 * pix * cin + 3 * pix * cout
            weights += (4 * (10 * cin + cout)
                        + 2 * 2 * (-(-cout // 8) * 8) * (-(-cin // 16) * 16))
    return B * tc, B * f32, 4 * B * maps + weights


def bound_s(spec: dict, B: int) -> float:
    tc, f32, nbytes = work(spec["backbone"], B)
    return peaks.bound_s(nbytes=nbytes, fp32=f32, bf16=tc)
