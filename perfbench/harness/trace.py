"""The device trace of a short window and its reduction.

`profile(run)` runs `run()` under torch.profiler (host and CUDA activity)
inside a `perfbench.window` span and returns a `Trace`: the device's
kernels and copies, the host's spans and operations, all on the
profiler's clock (microseconds), and the window's bounds.  The union of
the device intervals is the busy time (`busy_us`: the method of
tools/profile_detect.py).  The breakdown gives the device operations that
took most time, by name, and the device's idle time by what the host was
doing at each gap (the harness's own span and the innermost host
operation)."""
from __future__ import annotations

import dataclasses

import torch

WINDOW = "perfbench.window"


@dataclasses.dataclass
class Trace:
    kernels: list          # (name, start_us, end_us) of device kernels
    copies: list           # (name, start_us, end_us) of device copies/sets
    host: list             # (name, start_us, end_us) of host events
    start_us: float
    end_us: float

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    @property
    def device(self) -> list:
        return self.kernels + self.copies


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def profile(run) -> Trace:
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            run()
            torch.cuda.synchronize()
    kernels, copies, host = [], [], []
    window = None
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name.startswith("perfbench.") and e.device_type != (
                torch.autograd.DeviceType.CPU):
            continue             # a span's mark on the device's timeline
        if e.device_type == torch.autograd.DeviceType.CUDA:
            (copies if _is_copy(e.name) else kernels).append(row)
        else:
            host.append(row)
            if e.name == WINDOW:
                window = row
    if window is None:
        raise RuntimeError("the profiler recorded no perfbench.window span")
    def inside(rows):
        return [r for r in rows if r[2] > window[1] and r[1] < window[2]]

    return Trace(inside(kernels), inside(copies), host, window[1], window[2])


def merged(intervals: list) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(rows: list) -> float:
    return sum(e - s for s, e in merged([(r[1], r[2]) for r in rows]))


def device_ops(trace: Trace, top: int = 10) -> list:
    """[[name, seconds]] of the device operations, summed by name, the
    largest first."""
    total: dict = {}
    for name, s, e in trace.device:
        key = name.replace("(anonymous namespace)::", "")[:100]
        total[key] = total.get(key, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(total.items(),
                                      key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """[[what the host was doing, seconds]]: the device's idle time in the
    window, summed by the harness span and the innermost host operation
    open at the middle of each gap, the largest first."""
    busy = merged([(max(s, trace.start_us), min(e, trace.end_us))
                   for _, s, e in trace.device])
    edges = [trace.start_us] + [x for iv in busy for x in iv] + [trace.end_us]
    host = [h for h in trace.host if h[0] != WINDOW]
    total: dict = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        open_ = [h for h in host if h[1] <= mid < h[2]]
        spans = [h for h in open_ if h[0].startswith("perfbench.")]
        ops = [h for h in open_ if not h[0].startswith("perfbench.")]
        span = min(spans, key=lambda h: h[1])[0] if spans else "-"
        op = max(ops, key=lambda h: h[1])[0] if ops else "-"
        key = f"{span} / {op}"[:100]
        total[key] = total.get(key, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(total.items(),
                                      key=lambda kv: -kv[1])[:top]]


def launches(trace: Trace, matchers: dict) -> dict:
    """{kernel name in the launch plan: launches in the trace}."""
    return {name: sum(1 for k in trace.kernels if match(k[0]))
            for name, match in matchers.items()}
