"""The port's spans and sections (headpose_tpu_torch/utils/profiling.py) on
the CPU: a detect and its trim under torch.profiler give the stage spans
nested and in order; without a profiler a span is one shared no-op; a
section counts into TOTALS, and a weight pack built counts one
`pack.build`; an exported `_pipeline` holds no span; DynamicBatcher keeps
each dispatched request's queue wait, reported by /v1/stats."""
import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from headpose_tpu_torch.ops.kernels.packing import packed
from headpose_tpu_torch.pretrained import flagship_detector
from headpose_tpu_torch.runtime import results as tres
from headpose_tpu_torch.runtime.http import PoseServer
from headpose_tpu_torch.runtime.server import DynamicBatcher
from headpose_tpu_torch.utils.profiling import TOTALS, section, span

from test_torch_http import TIMEOUT, StubDetector, call, npy, stub_frames

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def detector():
    return flagship_detector(device="cpu")


def _spans(prof) -> list[tuple[str, float, float]]:
    """(name, start, end) of the recorded headpose.* events, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("headpose.")),
                  key=lambda r: r[1])


def _children(spans, parent: str, names) -> list[str]:
    """The spans among `names` inside the one span `parent`, in order."""
    [(_, s0, e0)] = [r for r in spans if r[0] == parent]
    return [n for n, s, e in spans if n in names and s0 <= s and e <= e0]


def test_detect_and_trim_spans_nest_in_order(detector):
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:2]
    detector.detect(imgs).trim()                          # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = detector.detect(imgs).trim()
    assert len(results) == 2
    spans = _spans(prof)
    stages = ["headpose.detect." + s for s in
              ("checks", "preprocess", "network", "postprocess")]
    assert _children(spans, "headpose.detect", stages) == stages
    parts = ["headpose.results.copy", "headpose.results.split"]
    assert _children(spans, "headpose.results.trim", parts) == parts
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in prof.events() if e.name.startswith("headpose."))


def test_span_without_a_profiler_is_one_shared_noop():
    off = span("detect")
    assert off is span("results.split") is span("x")
    assert isinstance(off, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = span("x")
        with on:
            pass
    assert on is not off
    assert [r[0] for r in _spans(prof)] == ["headpose.x"]
    with off:                                   # recorded by no profiler
        pass


def test_section_counts_and_totals_into_totals():
    name = "test.section"
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with section(name):
                pass
        with section(name):
            pass
        assert TOTALS.counts[name] == 2 and TOTALS.totals[name] >= 0.0
        assert [r[0] for r in _spans(prof)] == ["headpose." + name]
        with pytest.raises(ValueError), section(name):
            raise ValueError("counted all the same")
        assert TOTALS.counts[name] == 3
    finally:
        TOTALS.counts.pop(name, None)
        TOTALS.totals.pop(name, None)


def test_a_pack_built_counts_one_pack_build():
    net = nn.Linear(4, 3)

    def leaves(m):
        return [m.weight, m.bias]

    before = TOTALS.counts.get("pack.build", 0)
    first = packed(net, leaves)
    assert TOTALS.counts["pack.build"] == before + 1
    assert packed(net, leaves) is first                 # a hit: no build
    assert TOTALS.counts["pack.build"] == before + 1
    with torch.no_grad():
        net.bias.add_(1.0)                              # stale: rebuilt
    packed(net, leaves)
    assert TOTALS.counts["pack.build"] == before + 2


def test_kernel_registration_is_a_section():
    """Importing the op library registered the ops inside the section
    `kernels.register` (the CPU has no nvcc, so no build or load)."""
    import headpose_tpu_torch.ops.kernels.library  # noqa: F401

    assert TOTALS.counts["kernels.register"] >= 2
    assert TOTALS.totals["kernels.register"] > 0.0


def test_exported_pipeline_holds_no_span(detector):
    """torch.export of `_pipeline` (tools/aot.py's program) holds no
    headpose.* span, record_function or profiler node: no profiler records
    during an export, so every span is the no-op."""
    from headpose_tpu_torch.tools.aot import _Serve

    detector.detect(np.zeros((1, 128, 128, 3), np.uint8))      # the packs
    with torch.no_grad():
        program = torch.export.export(
            _Serve(detector),
            (torch.zeros((1, 128, 128, 3), dtype=torch.uint8),))
    nodes = [f"{n.name} {n.target}" for n in program.graph.nodes]
    assert any("headpose_tpu_torch.postprocess" in n for n in nodes)
    for n in nodes:
        assert "headpose." not in n and "record_function" not in n, n
        assert "profiler" not in n, n


def test_batcher_records_each_requests_queue_wait():
    """Every dispatched request's wait, submit to dispatch, in a window of
    the last 1000; a lone request waits out max_delay."""
    with DynamicBatcher(StubDetector(tres), max_batch=4,
                        max_delay=0.05) as b:
        assert b.queue_waits() == []
        b.detect(stub_frames(1)[0], timeout=TIMEOUT)
        [wait] = b.queue_waits()
        assert 0.04 <= wait < TIMEOUT
        futs = [b.submit(f) for f in stub_frames(1005, seed=1)]
        for fut in futs:
            fut.result(TIMEOUT)
        waits = b.queue_waits()
        assert len(waits) == 1000 and waits == sorted(waits)
        assert all(w >= 0.0 for w in waits)


def test_stats_report_queue_wait_beside_latency():
    with PoseServer(StubDetector(tres), port=0, max_batch=8,
                    max_delay=0.01) as srv:
        stats = json.loads(call(srv.url, "GET", "/v1/stats")[2])
        assert "queue_wait_ms" not in stats
        for f in stub_frames(3, seed=2):
            assert call(srv.url, "POST", "/v1/detect", npy(f))[0] == 200
        stats = json.loads(call(srv.url, "GET", "/v1/stats")[2])
    waits = stats["queue_wait_ms"]
    assert waits["window"] == 3 and stats["latency_ms"]["window"] == 3
    assert 0.0 <= waits["p50"] <= waits["p99"]
    assert list(stats)[-1] == "queue_wait_ms"
