"""Host milliseconds a batch inside the program's `headpose.stream.stage`
spans (runtime/streaming.py: a batch's pinning checked, its host→device
copy issued on the side stream and its event recorded), on the profiler's
clock, in the traced window."""

SPAN = "headpose.stream.stage"


def read(ctx):
    t = [e - s for name, s, e in ctx.trace.host if name == SPAN
         and s >= ctx.trace.start_us and e <= ctx.trace.end_us]
    return sum(t) / 1e3 / ctx.batches if t else None
