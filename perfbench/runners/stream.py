"""One card, one process: pinned host batches from the traffic's ring flow
through `runtime.streaming.detect_stream(det, batches, prefetch)`, and every
yielded `BatchResults` is trimmed to per-image `Results` on the host.

A batch's latency runs from when the stream takes it from the feed to when
its `trim()` returns.  The window hands batches to the stream for
`seconds`, then drains; the rate is the frames whose answers reached the
host over the whole window.  With `trace`, a short window right after the
warm-up runs under the profiler (taken again where launches went
missing), and the timed window times each `detect` and each `trim()`, the
latter after waiting on the batch's completion event."""
from __future__ import annotations

import itertools
import time
from collections import deque

import numpy as np
import torch

from ..harness import frames as framegen
from ..harness import metrics, trace
from ..reference.detector import tf32_mode
from . import common


class _Timed:
    """The detector as the stream sees it, with a span around each
    `detect` and a completion event recorded after it."""

    def __init__(self, det):
        self.det = det
        self.device = det.device
        self.dispatch: list = []
        self.done: deque = deque()

    def detect(self, x):
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench.dispatch"):
            out = self.det.detect(x)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self.done.append(ev)
        self.dispatch.append(time.perf_counter() - t0)
        return out


def _feed(ring, count=None, until=None, handed=None):
    """The ring's batches in turn: `count` of them, or until the clock
    passes `until`; `handed` collects the time each is taken."""
    for k in itertools.count():
        if count is not None and k >= count:
            return
        now = time.perf_counter()
        if until is not None and now >= until:
            return
        if handed is not None:
            handed.append(now)
        with torch.profiler.record_function("perfbench.feed"):
            batch = ring[k % len(ring)]
        yield batch


def _drive(det, ring, prefetch, feed, on_result):
    from headpose_tpu_torch.runtime.streaming import detect_stream

    for k, br in enumerate(detect_stream(det, feed, prefetch=prefetch)):
        on_result(k, br)


def run(cell, seed: int, seconds: float, traced: bool, t0: float,
        device="cuda", tf32: bool = False) -> dict:
    """One run of the cell; `tf32` (the control of a float32
    configuration) switches TF32 on in cuBLAS and cuDNN once the detector
    is built."""
    with tf32_mode(tf32):
        return _run(cell, seed, seconds, traced, t0, torch.device(device),
                    tf32)


def _run(cell, seed, seconds, traced, t0, device, tf32) -> dict:
    tr = cell.traffic
    on_card = device.type == "cuda"
    phases = common.Phases(t0)
    det = common.detector(cell.config, device)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    phases.mark("detector")
    images = framegen.corpus(tr)
    host = framegen.ring(tr, seed, images)
    ring = [torch.from_numpy(f) for f in host]
    phases.mark("frames")
    if on_card:
        ring = [t.pin_memory() for t in ring]
    phases.mark("pin")
    B, prefetch = int(tr["batch"]), int(tr["prefetch"])
    survivors = []

    def trim(k, br):
        with torch.profiler.record_function("perfbench.trim"):
            survivors.append(sum(len(r) for r in br.trim()))

    _drive(det, ring, prefetch, _feed(ring, count=1), trim)
    phases.mark("first_batch")
    _drive(det, ring, prefetch,
           _feed(ring, count=int(tr["warmup_batches"]) - 1), trim)
    if on_card:
        torch.cuda.synchronize(device)
    phases.mark("warmup")
    out: dict = {"setup_phases": phases.spans}
    timed = _Timed(det) if traced else det
    if traced and on_card:
        n = int(tr["profile_batches"])

        def window():
            survivors.clear()
            _drive(timed, ring, prefetch, _feed(ring, count=n), trim)

        out["trace"], out["retakes"], out["launches"] = (
            common.guarded_profile(window, cell.config["launches"], n))
        out["survivors"] = float(np.mean(survivors))
        timed.dispatch.clear()
        timed.done.clear()
        phases.mark("profile")

    handed, done, trims = [], [], []
    sample = common.Reservoir(int(tr["check_batches"]), seed)

    def collect(k, br):
        if traced and on_card:
            timed.done.popleft().synchronize()
        t = time.perf_counter()
        results = br.trim()
        now = time.perf_counter()
        trims.append(now - t)
        done.append(now)
        sample.offer(k % len(ring), results)

    t_start = time.perf_counter()
    out["setup_s"] = t_start - t0
    _drive(timed, ring, prefetch,
           _feed(ring, until=t_start + seconds, handed=handed), collect)
    wall = done[-1] - t_start
    lat = np.asarray(done) - np.asarray(handed[:len(done)])
    out.update(
        attempted=len(handed) * B, completed=len(done) * B,
        frames_per_s=len(done) * B / wall, window_s=wall,
        latency_p95_ms=1e3 * float(np.percentile(lat, 95)),
        memory_peak_bytes=(torch.cuda.max_memory_allocated(device)
                           if on_card else 0),
        spans={"dispatch": timed.dispatch if traced else [],
               "trim": trims if traced else []})
    del det, timed
    if on_card:
        torch.cuda.empty_cache()
    out["readings"] = common.reference_check(cell, host, sample.kept, device)
    if traced and on_card:
        tr_ = out["trace"]
        busy = trace.busy_us(tr_.device) / 1e6
        out["busy_s"] = busy
        out["ctx"] = metrics.Context(
            config=cell.config, traffic=tr, chips=1, trace=tr_,
            batches=int(tr["profile_batches"]), rows=B,
            survivors=out["survivors"],
            frames_per_s=int(tr["profile_batches"]) * B / tr_.window_s,
            busy_s=busy, frame_hw=framegen.frame_shape(tr, images),
            spans=out["spans"])
    return out
