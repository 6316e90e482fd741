"""What both runners share: the program's detector for a configuration,
a seeded reservoir of checked batches, the launch-plan guard of the traced
window, and the reference check."""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..harness import check, trace
from ..harness.cells import PERFBENCH, ROOT, module

RETAKES = 3
# the detector's options that the harness sets itself; a configuration's
# "detector" object may not set them again
HARNESS_OPTIONS = ("precision", "score_threshold", "iou_threshold",
                   "max_faces", "device", "mesh")


class Phases:
    """Seconds of the set-up's phases, each from the end of the one
    before; the first, "imports", from the process's start `t0` on `clock`
    (perf_counter, or time.time across processes)."""

    def __init__(self, t0: float, clock=time.perf_counter):
        self._clock = clock
        self._last = t0
        self.spans: dict = {}
        self.mark("imports")

    def mark(self, name: str) -> None:
        now = self._clock()
        self.spans[name] = now - self._last
        self._last = now


def detector(config: dict, device, **kw):
    """The program's FaceDetector for `config`: its shipped model at its
    precision and thresholds, with the keyword options of the
    configuration's optional "detector" object (e.g. {"head_eval":
    "map"}); ValueError where one of them is an option the harness sets."""
    from headpose_tpu_torch.runtime.detector import FaceDetector

    options = config.get("detector", {})
    clash = sorted(set(options) & set(HARNESS_OPTIONS))
    if clash:
        raise ValueError(f"perfbench: the configuration's \"detector\" sets "
                         f"{clash}, which the harness sets itself")
    path = os.path.join(ROOT, os.path.dirname(config["weights"]))
    return FaceDetector.from_native(
        path, precision=config["precision"],
        score_threshold=config["score_threshold"],
        iou_threshold=config["iou_threshold"],
        max_faces=config["max_faces"], device=device, **kw, **options)


class Reservoir:
    """A uniform sample of `k` of the window's batches, drawn from the seed
    as the batches complete: (ring slot, the program's answers)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 0x5EED])
        self.kept: list = []
        self.seen = 0

    def offer(self, slot: int, results) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((slot, results))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.kept[j] = (slot, results)


def matchers(plan: dict, root: str = PERFBENCH) -> dict:
    """{key: the `matches` of <root>/kernels/<key>.py} for each kernel of a
    launch plan; FileNotFoundError naming the file of an unknown key."""
    return {k: module("kernels", k, root).matches for k in plan}


def guarded_profile(run, plan: dict, batches: int,
                    agree=lambda ok: ok) -> tuple:
    """Profile `run()` (which drives `batches` batches) and count each
    kernel of the launch plan; where a count differs from plan × batches
    (the profiler drops launch records late in a process) take the window
    again, up to RETAKES times.  `agree(ok)` makes the verdict common to
    all ranks.  Returns (trace, retakes, counts)."""
    want = {k: v * batches for k, v in plan.items()}
    found = matchers(plan)
    for retakes in range(RETAKES + 1):
        tr = trace.profile(run)
        counts = trace.launches(tr, found)
        if agree(counts == want):
            return tr, retakes, counts
        print(f"perfbench: traced launches {counts}, the plan {want}; "
              "taking the window again", file=sys.stderr)
    raise RuntimeError(f"the traced window's launches {counts} never met "
                       f"the launch plan {want} in {RETAKES + 1} windows")


def reference_check(cell, ring: list, sample: list, device) -> dict:
    """The plain reference over the sampled batches' frames, compared with
    the program's answers (harness.check)."""
    from ..reference.detector import Reference

    ref = Reference(cell.config, os.path.join(ROOT, cell.config["weights"]),
                    device=device)
    got, want = [], []
    for slot, results in sample:
        got.append(results)
        want.append(ref.detect(ring[slot]))
    return check.compare(got, want, cell.config, cell.limits["margins"])
