"""The control of each cell, on the card at the cell's batch and frame
size (a shorter ring and window than a run's): the program at the
precision below its configuration's ("default" under "fast"; TF32 under
"highest") must come out not correct, the program itself correct.  The
readings its limits were set from are in PERF.md; perfbench/readings.py
takes them at full size.  Run on the card with `python -m pytest
perfbench/tests -m gpu`."""
import os

import pytest

from perfbench.harness import cells, check, control

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# every cell that has a limits file: BENCHMARK.json's, and those kept in
# files for a later PR
WORKLOADS = sorted(f[:-5] for f in os.listdir(
    os.path.join(ROOT, "perfbench", "limits")) if f.endswith(".json"))


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_the_program_passes(workload):
    import torch

    cell = cells.from_files(workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} CUDA device(s)")
    cell.traffic.update(ring=2, warmup_batches=4)
    seed = 2**31 + 1234
    sound, ctl = control.runs(cell, [(seed, False), (seed + 1, True)], 1.0)
    assert check.verdict(sound["readings"], cell.limits["limits"])[0]
    assert not check.verdict(ctl["readings"], cell.limits["limits"])[0]
