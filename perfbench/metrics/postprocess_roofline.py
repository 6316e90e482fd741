"""Kernel #1's share of its roofline: its inputs read once and the slab
written once, and the operations the kept faces ask for
(perfbench/kernels/postprocess.py), over the device time of its launches
a batch."""
from perfbench.kernels import postprocess


def read(ctx):
    t = sum(e - s for name, s, e in ctx.trace.kernels
            if postprocess.matches(name)) / 1e6 / ctx.batches
    if t <= 0:
        return None
    bound = postprocess.bound_s(ctx.rows, ctx.config["max_faces"],
                                ctx.survivors)
    return 100.0 * bound / t
