"""Seconds this process spent registering the program's custom ops,
building its CUDA libraries with nvcc and loading them: the sections
`kernels.register`, `kernels.build` and `kernels.load` of
`headpose_tpu_torch.utils.profiling.TOTALS`, from the process's start.
None where the program keeps no such sections."""

SECTIONS = ("kernels.register", "kernels.build", "kernels.load")


def read(ctx):
    try:
        from headpose_tpu_torch.utils.profiling import TOTALS
    except ImportError:
        return None
    t = [TOTALS.totals[k] for k in SECTIONS if TOTALS.counts.get(k)]
    return sum(t) if t else None
