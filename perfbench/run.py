"""Run one cell of the benchmark once; see perfbench/harness/cli.py.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout."""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's kernels build into build/ inside the checkout; the build and
# kernel caches of torch and triton are kept beside them, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "perfbench-cache", sub)
# one process, few threads: the served path computes on the card, and idle
# CPU thread pools only compete with the thread that feeds it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
sys.path[0] = ROOT

from perfbench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
