"""Runs of a cell for its readings: the program on some seeds and the
control on others, in one process (one set of ranks for the mesh), each a
short window at the cell's own size.

The control is the configuration's `control`: another precision of the
program (its single-pass bf16 "default" under "fast"), or "tf32", the
program with TF32 switched on in cuBLAS and cuDNN (under "highest")."""
from __future__ import annotations

import copy
import time


def runs(cell, jobs: list, seconds: float, device="cuda") -> list:
    """[(seed, control)] → the runner's results, in order."""
    from ..runners import mesh, stream

    if cell.traffic["runner"] == "mesh":
        return mesh.run(cell, 0, seconds, False, time.perf_counter(),
                        device=device, jobs=jobs, timeout=3000.0)
    outs = []
    for seed, control in jobs:
        c = copy.deepcopy(cell)
        tf32 = control and c.config["control"] == "tf32"
        if control and not tf32:
            c.config["precision"] = c.config["control"]
        outs.append(stream.run(c, seed, seconds, False, time.perf_counter(),
                               device=device, tf32=tf32))
    return outs
