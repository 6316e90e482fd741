"""Kernel #5, the SE-Transformer pose head (csrc/se_attention.cu: three
grids a head over maps of more than one cell, `gate_kernel`, `kv_kernel`
and `attend_kernel<D, H>`), one call a head of kind "se_transformer" over
every cell of its map.

Work, set by the head's spec and B alone, whatever computes it: the
model's own multiply-adds (q/k/v, Q·Kᵀ, P·V, the output projection, the
FFN, the two 1x1s) count 2 each, three times, at the bf16 tensor-core
peak: three bf16 passes are the cheapest tensor-core route to products
near fp32's accuracy.  On the CUDA cores, 1 each: the token mean and the
gate's two products, the biases, residual adds, ReLUs and LayerNorms (8 an
element), the softmax (5 a score, a divide an output).  Bytes: the maps
read once, the poses written once, the weights once."""
from __future__ import annotations

import re

from . import peaks
from .head_mlp import map_cells

_NAMES = re.compile(r"\b(gate_kernel|kv_kernel|attend_kernel)\b")


def matches(name: str) -> bool:
    return _NAMES.search(name) is not None


def head_work(head: dict, B: int, T: int) -> tuple[int, int, int]:
    """(tensor-core operations in three passes, fp32 operations, bytes) of
    one head over B maps of T tokens."""
    C, H, D = head["in_features"], head["num_heads"], head["key_dim"]
    M, F = C // head["reduction"], head["ff_dim"]
    hidden, out = head["hidden"], head["out_features"]
    HD = H * D
    attention = T * C * 3 * HD + T * T * HD * 2
    tail = T * HD * C + 2 * T * C * F + T * C * hidden + T * hidden * out
    gate = 2 * T * C + M + C + 4 * C * M
    rest = 2 * T * C + 2 * 8 * T * C + T * (F + C + 2 * hidden + out)
    softmax = 3 * T * HD + 5 * H * T * T + T * HD
    weights = (2 * C * M + M + C + 3 * (C * HD + HD) + HD * C + C + 4 * C
               + 2 * C * F + F + C + C * hidden + hidden + hidden * out
               + out)
    nbytes = 4 * (B * T * (C + out) + weights)
    return 3 * B * 2 * (attention + tail), B * (gate + rest + softmax), nbytes


def work(spec: dict, B: int) -> tuple[int, int, int]:
    """(tensor-core operations, fp32 operations, bytes) of the heads of
    kind "se_transformer" over B frames' maps."""
    total = [0, 0, 0]
    for name, cells in map_cells(spec["backbone"]).items():
        if spec[name]["kind"] == "se_transformer":
            total = [a + b for a, b in zip(total, head_work(spec[name], B,
                                                            cells))]
    return tuple(total)


def bound_s(spec: dict, B: int) -> float:
    tc, f32, nbytes = work(spec, B)
    return peaks.bound_s(nbytes=nbytes, fp32=f32, bf16=tc)
