"""Per-layer metrics: each is a reader of its own,
`perfbench/metrics/<name>.py`, whose `read(ctx)` returns the metric's
value from a `Context`, or None where it finds nothing to read; the
harness then leaves the metric out of the line."""
from __future__ import annotations

import dataclasses

from .cells import PERFBENCH, module


@dataclasses.dataclass
class Context:
    config: dict            # the cell's configuration
    traffic: dict           # the cell's traffic mix
    chips: int
    trace: object           # harness.trace.Trace of this chip (rank 0)
    batches: int            # batches this chip ran in the traced window
    rows: int               # frames a batch on this chip
    survivors: float        # faces kept a traced batch on this chip
    frames_per_s: float     # frames of all chips over the traced window
    busy_s: float           # device busy seconds, averaged over the chips
    frame_hw: tuple         # (height, width) of a frame
    spans: dict             # host spans of the timed window: name → [s]


def reader(name: str, root: str = PERFBENCH):
    return module("metrics", name, root).read


def read_all(per_layer: list, ctx: Context) -> dict:
    out = {}
    for m in per_layer:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
