"""The benchmark of headpose_tpu_torch on NVIDIA H100s (`python3
perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1`).

Driven by data: `BENCHMARK.json` at the repository's root names the cells;
each configuration (`configs/`), traffic mix (`traffic/`), correctness
limit set (`limits/`), per-layer metric reader (`metrics/`), kernel count
(`kernels/`, one a key of a configuration's launch plan) and pose-head kind
of the reference (`reference/heads/`, one a head's `kind`) sits in a file
of its own, found by name.
"""
