"""The readings that a cell's correctness limits are set from, at the
cell's own size: the program over many seeds and the control over a few
(perfbench/harness/control.py), in one process.

    python3 perfbench/readings.py --workload NAME --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2 [--out FILE]

One JSON line a run: the seed, whether it was the control, the compared
numbers, frames/s and the p95 latency."""
import argparse
import json
import os
import sys


def main():
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from perfbench.harness import cells, control

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    try:
        cell = cells.load(args.workload)
    except KeyError:                  # a cell kept in files for a later PR
        cell = cells.from_files(args.workload)
    jobs = ([(int(s), False) for s in args.seeds.split(",")]
            + [(int(s), True) for s in args.control_seeds.split(",") if s])
    lines = [json.dumps({
        "workload": args.workload, "seed": seed, "control": ctl,
        "readings": out["readings"], "frames_per_s": out["frames_per_s"],
        "latency_p95_ms": out["latency_p95_ms"]})
        for (seed, ctl), out in zip(jobs, control.runs(cell, jobs,
                                                        args.seconds))]
    print("\n".join(lines), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
