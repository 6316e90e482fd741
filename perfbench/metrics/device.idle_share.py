"""The share of the traced window in which no kernel or copy ran on the
device: 1 - busy / window, averaged over the chips, in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.trace.window_s)
