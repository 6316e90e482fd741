"""Host milliseconds a batch inside the program's `headpose.results.split`
span (runtime/results.py::BatchResults.trim: the host slab split into one
`Results` a frame), on the profiler's clock, in the traced window."""

SPAN = "headpose.results.split"


def read(ctx):
    t = [e - s for name, s, e in ctx.trace.host if name == SPAN
         and s >= ctx.trace.start_us and e <= ctx.trace.end_us]
    return sum(t) / 1e3 / ctx.batches if t else None
