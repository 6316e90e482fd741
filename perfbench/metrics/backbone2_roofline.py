"""Kernel #3's share of its roofline: the bound of the split-bf16
segments at the cell's shapes (perfbench/kernels/backbone2.py) over the
device time of its launches a batch."""
from perfbench.kernels import backbone2


def read(ctx):
    t = sum(e - s for name, s, e in ctx.trace.kernels
            if backbone2.matches(name)) / 1e6 / ctx.batches
    if t <= 0:
        return None
    return 100.0 * backbone2.bound_s(ctx.config["spec"], ctx.rows) / t
