"""The whole step's share of the chips' peak: the model's own operations a
frame (perfbench/kernels/model.py) × the traced window's frames a second,
over the configuration's stated peak × the chips, in %."""
from perfbench.kernels import model


def read(ctx):
    flops = model.flops_per_frame(ctx.config["spec"], ctx.frame_hw)
    peak = ctx.config["peak_tflops"] * 1e12 * ctx.chips
    return 100.0 * flops * ctx.frames_per_s / peak
