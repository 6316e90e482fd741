"""Device milliseconds of the host→device copies a batch (the frames
feeding ops/image.py::preprocess), from the profiler's memcpy records."""


def read(ctx):
    t = sum(e - s for name, s, e in ctx.trace.copies if "HtoD" in name)
    return t / 1e3 / ctx.batches if t > 0 else None
