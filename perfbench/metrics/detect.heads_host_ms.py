"""Host milliseconds a batch inside the program's `headpose.detect.heads`
span (runtime/fused.py::fused_network: both pose heads' wrappers, weight
stamps and kernel launches), on the profiler's clock, in the traced
window."""

SPAN = "headpose.detect.heads"


def read(ctx):
    t = [e - s for name, s, e in ctx.trace.host if name == SPAN
         and s >= ctx.trace.start_us and e <= ctx.trace.end_us]
    return sum(t) / 1e3 / ctx.batches if t else None
