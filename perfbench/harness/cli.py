"""One run of one cell: `python3 perfbench/run.py --workload NAME --seed N
--seconds S --trace 0|1`.

It refuses to run (exit 2, no result) without as many CUDA devices as the
cell asks for; it loads the cell's files, hands the cell to its traffic's
runner, and prints the numbers compared with the reference on standard
error and, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), device, with `--trace 1` the breakdown,
and last the compared numbers beside their limits.  It exits 3 without a
result if JAX, jaxlib, flax or the JAX package is loaded once the window
has closed."""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from . import cells, check, metrics, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "headpose_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `headpose_tpu_torch` is not `headpose_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, out: dict, traced: bool, device_count: int,
                kind: str) -> tuple[dict, list]:
    """The result object and the stderr lines of the compared numbers."""
    correct, shown = check.verdict(out["readings"], cell.limits["limits"])
    if traced:
        values = metrics.read_all(cell.per_layer, out["ctx"])
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = {name: {"value": float(out[name]), "unit": units[name]}
                  for name in units}
    device = {"platform": "gpu", "kind": kind, "count": device_count,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["attempted"] - out["completed"]),
            "metrics": values, "device": device}
    if traced:
        device["busy_s"] = float(out["busy_s"])
        device["window_s"] = float(out["ctx"].trace.window_s)
        line["breakdown"] = {"device_ops": trace.device_ops(out["ctx"].trace),
                             "idle_gaps": trace.idle_gaps(out["ctx"].trace)}
        line["trace_retakes"] = out["retakes"]
    if "setup_phases" in out:
        line["setup_phases"] = out["setup_phases"]
    line["frames_checked"] = out["readings"]["frames"]
    line["compared"] = shown
    lines = [f"compared {k} {v} limit {lim}" for k, (v, lim) in shown.items()]
    return line, lines


def main(argv=None, t0: float = 0.0) -> int:
    args = parse(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell asks for {cell.chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    runner = importlib.import_module(
        f"perfbench.runners.{cell.traffic['runner']}")
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace), t0)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    line, lines = result_line(cell, out, bool(args.trace), cell.chips,
                              torch.cuda.get_device_name(0))
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
