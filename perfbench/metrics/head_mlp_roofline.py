"""Kernel #4's share of its roofline: the bound of both MLP heads over
every cell of their maps (perfbench/kernels/head_mlp.py) over the device
time of their launches a batch."""
from perfbench.kernels import head_mlp


def read(ctx):
    t = sum(e - s for name, s, e in ctx.trace.kernels
            if head_mlp.matches(name)) / 1e6 / ctx.batches
    if t <= 0:
        return None
    return 100.0 * head_mlp.bound_s(ctx.config["spec"], ctx.rows) / t
