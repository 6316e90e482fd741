"""Host milliseconds a batch inside the program's `headpose.results.copy`
span (runtime/results.py::BatchResults.trim: the wait for the batch and
the slab's copy to pageable host memory), on the profiler's clock, in the
traced window."""

SPAN = "headpose.results.copy"


def read(ctx):
    t = [e - s for name, s, e in ctx.trace.host if name == SPAN
         and s >= ctx.trace.start_us and e <= ctx.trace.end_us]
    return sum(t) / 1e3 / ctx.batches if t else None
