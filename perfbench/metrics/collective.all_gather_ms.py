"""Device milliseconds of the NCCL all-gather of the slab a step
(parallel/distributed.py::all_gather_rows), on rank 0."""
from perfbench.kernels import all_gather


def read(ctx):
    t = sum(e - s for name, s, e in ctx.trace.kernels
            if all_gather.matches(name))
    return t / 1e3 / ctx.batches if t > 0 else None
