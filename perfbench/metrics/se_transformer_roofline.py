"""Kernel #5's share of its roofline: the bound of both SE-Transformer
heads over every cell of their maps (perfbench/kernels/se_transformer.py)
over the device time of their three grids a head, a batch."""
from perfbench.kernels import se_transformer


def read(ctx):
    t = sum(e - s for name, s, e in ctx.trace.kernels
            if se_transformer.matches(name)) / 1e6 / ctx.batches
    if t <= 0:
        return None
    return 100.0 * se_transformer.bound_s(ctx.config["spec"], ctx.rows) / t
