"""Light tracing and timing, PyTorch edition.

Port of headpose_tpu/utils/profiling.py: the reference's frame-rate counter
(`FpsCounter`), a section timer (`Timer`), a device trace (`trace`, a
`torch.profiler` context), and the repository's one sustained-throughput
method (`staged_uint8_frames` + `sustained_seconds_per_dispatch`).

The program's own spans: `span(name)` marks a stage of the hot path as a
host event `headpose.<name>` on the profiler's clock, beside the kernels
and copies the same profiler records, and costs one global read when no
profiler records; `section(name)` times rare work (kernel registration,
builds and loads, weight packs) into the process-wide `TOTALS` always, and
is a span besides.  `trace()` writes both to its Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["FpsCounter", "Timer", "trace", "span", "section", "TOTALS",
           "staged_uint8_frames", "sustained_seconds_per_dispatch"]


def staged_uint8_frames(batch: int, size: int = 128, n_buffers: int = 8,
                        seed: int = 0,
                        device: str | torch.device | None = None) -> list:
    """`n_buffers` distinct random uint8 frame batches (B, size, size, 3),
    staged on `device` (None: the card).  Distinct buffers cycled through
    the timed loop keep a runtime from eliding same-input work, and staging
    keeps the upload out of the timed loop."""
    from .device import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, size=(batch, size, size, 3),
                                          dtype=np.int64).astype(np.uint8))
            .to(device) for _ in range(n_buffers)]


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def sustained_seconds_per_dispatch(fn, inputs: list, iters: int = 500
                                   ) -> float:
    """Sustained-throughput timing of `fn` over cycled staged inputs, the
    method the JAX package's benchmarks share: one warmup dispatch (kernels
    built, cuDNN plans chosen), then `iters` back-to-back dispatches cycling
    the staged buffers, one synchronize at the end; results stay on the
    device between iterations, as in serving.  Returns seconds per
    dispatch."""
    fn(inputs[0])
    _synchronize()
    n = len(inputs)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(inputs[i % n])
    _synchronize()
    return (time.perf_counter() - t0) / iters


class FpsCounter:
    """Frames per second over a sliding update window (the reference's
    updateFps)."""

    def __init__(self, update_every: int = 1):
        self.update_every = update_every
        self._count = 0
        self._last = time.time()
        self.fps = 0.0

    def tick(self) -> float:
        self._count += 1
        if self._count >= self.update_every:
            now = time.time()
            self.fps = self._count / (now - self._last + 1e-4)
            self._count = 0
            self._last = now
        return self.fps


class Timer:
    """Accumulating section timer: with t.section('decode'): ...  Sections
    may close on several threads at once."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def count(self, name: str) -> None:
        """One more of `name`, with no time: an event, not a section."""
        with self._lock:
            self.counts[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


TOTALS = Timer()              # rare sections (seconds, counts); event counts
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context marking a stage as the host event `headpose.<name>` while a
    profiler records; otherwise one shared no-op, so the cost is a read of
    the profiler's global flag.  The event is a host operation only: it
    puts nothing on the device's timeline, unlike
    `torch.profiler.record_function`, whose device-side mark would span the
    kernels launched inside it.  Under `torch.export` no profiler records,
    so a span traces to nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast("headpose." + name)


@contextlib.contextmanager
def section(name: str):
    """Rare work, always timed into `TOTALS` under `name` (seconds and a
    count), and a `span` besides."""
    with span(name), TOTALS.section(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str = "headpose_torch_trace"):
    """A device trace of the block with torch.profiler (CPU and, where a
    card is present, CUDA activity), written to `log_dir` as a Chrome trace
    (`trace.json`); yields the profiler, whose `key_averages()` tables the
    recorded kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
