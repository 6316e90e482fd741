"""The readers of the program's spans and sections: each span reader's mean
a batch over a synthetic trace (events inside the traced window only, by
exact name) and None where the span is absent; `setup.kernels_s` from the
program's `TOTALS`, and None where it holds no kernel section."""
import pytest

from headpose_tpu_torch.utils import profiling
from perfbench.harness import metrics, trace

SPAN_READERS = {
    "stream.stage_ms": "headpose.stream.stage",
    "detect.host_ms": "headpose.detect",
    "detect.network_host_ms": "headpose.detect.network",
    "results.copy_ms": "headpose.results.copy",
    "results.split_ms": "headpose.results.split",
}


def _ctx(host, batches=2):
    tr = trace.Trace(kernels=[], copies=[], host=host, start_us=1000.0,
                     end_us=9000.0)
    return metrics.Context(config={}, traffic={}, chips=1, trace=tr,
                           batches=batches, rows=256, survivors=0.0,
                           frames_per_s=0.0, busy_s=0.0, frame_hw=(128, 128),
                           spans={})


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_span_reader_mean_a_batch(metric):
    span = SPAN_READERS[metric]
    host = [(span, 1500.0, 2100.0), (span, 5000.0, 6400.0),
            (span, 100.0, 900.0),                   # before the window
            (span, 8500.0, 9500.0),                 # past its end
            (span + ".inner", 1600.0, 1700.0),      # another name
            ("perfbench.window", 1000.0, 9000.0), ("aten::add", 1500.0,
                                                   1510.0)]
    read = metrics.reader(metric)
    # (600 + 1400) µs over 2 batches
    assert read(_ctx(host)) == pytest.approx(1.0)
    assert read(_ctx(host, batches=4)) == pytest.approx(0.5)


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_span_reader_finds_nothing(metric):
    host = [("perfbench.window", 1000.0, 9000.0),
            (SPAN_READERS[metric], 100.0, 900.0)]
    assert metrics.reader(metric)(_ctx(host)) is None


def test_setup_kernels_reads_the_kernel_sections(monkeypatch):
    totals = profiling.Timer()
    monkeypatch.setattr(profiling, "TOTALS", totals)
    read = metrics.reader("setup.kernels_s")
    assert read(_ctx([])) is None
    totals.totals.update({"kernels.register": 1.5, "kernels.build": 30.0,
                          "kernels.load": 0.25, "pack.build": 9.0})
    totals.counts.update({"kernels.register": 9, "kernels.build": 4,
                          "kernels.load": 5, "pack.build": 3})
    assert read(_ctx([])) == pytest.approx(31.75)
    del totals.counts["kernels.build"], totals.totals["kernels.build"]
    assert read(_ctx([])) == pytest.approx(1.75)
