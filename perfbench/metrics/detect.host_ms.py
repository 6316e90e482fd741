"""Host milliseconds a batch inside the program's `headpose.detect` span
(runtime/detector.py::FaceDetector._detect: checks, upload, preprocess, the
network's wrappers and launches, the postprocess), on the profiler's clock,
in the traced window: the program's own view of what `host.dispatch_ms`
times from outside, under the profiler's cost."""

SPAN = "headpose.detect"


def read(ctx):
    t = [e - s for name, s, e in ctx.trace.host if name == SPAN
         and s >= ctx.trace.start_us and e <= ctx.trace.end_us]
    return sum(t) / 1e3 / ctx.batches if t else None
