"""Operation and byte counts of the program's kernels and of the model,
from a configuration's spec and the cell's shapes, and the names by which
a kernel's launches show in a device trace.  One file a kernel, named by
its key in a configuration's launch plan; the launch guard
(`runners/common.py::matchers`) and the per-layer metric readers
(`perfbench/metrics/`) take them by name."""
