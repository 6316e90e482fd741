"""Backfill evaluation metrics into historical training runs, PyTorch
edition (port of headpose_tpu/tools/backfill.py).

Capability parity with Model-96/test.py:71-122
(log_test_aflw2000_mae_for_runs): the reference re-evaluated old checkpoints
and pushed `test_AFLW2000_mae/loss` into their wandb run summaries.  Here the
run store is the local JSONL run directory (train/logging.py); this tool
re-evaluates each run's best checkpoint against a dataset and updates its
summary.json (and wandb, when configured, via the same logger stack).

    python -m headpose_tpu_torch.tools.backfill runs/ \
        --dataset AFLW2000_features_96_0.7_1.npz --metric test_AFLW2000_mae

It evaluates on the card; `--device cpu` (or `device="cpu"`) asks for the
CPU.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..data.datasets import load_dataset
from ..train.checkpoints import restore_pytree
from ..train.config import TrainConfig
from ..train.loop import build_head, evaluate

__all__ = ["backfill_runs"]


def backfill_runs(runs_dir: str, dataset_path: str,
                  metric_name: str = "test_AFLW2000_mae",
                  checkpoint_root: str | None = None,
                  verbose: bool = True,
                  device: str | torch.device | None = None
                  ) -> dict[str, float | None]:
    """Evaluate every run under runs_dir on the dataset; write the MAE/MSE
    into each run's summary.json.  Returns {run_id: mae or None}."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    ds = load_dataset(dataset_path)
    results: dict[str, float | None] = {}
    for run_id in sorted(os.listdir(runs_dir)):
        run_dir = os.path.join(runs_dir, run_id)
        cfg_path = os.path.join(run_dir, "config.json")
        if not os.path.isfile(cfg_path):
            continue
        try:
            with open(cfg_path) as f:
                cfg = TrainConfig.from_dict(json.load(f))
            ckpt_dir = os.path.join(checkpoint_root or cfg.checkpoint_dir,
                                    cfg.run_name or run_id)
            best = os.path.join(ckpt_dir, "best")
            if not os.path.isdir(best):
                raise FileNotFoundError(f"no best checkpoint at {best}")
            spec = build_head(cfg)
            params = restore_pytree(best)
            m = evaluate(spec, params, ds, device)
            results[run_id] = m["mae"]
            summary_path = os.path.join(run_dir, "summary.json")
            summary = {}
            if os.path.isfile(summary_path):
                with open(summary_path) as f:
                    summary = json.load(f)
            summary[metric_name] = m["mae"]
            # derive the loss key safely: a metric name without 'mae' must
            # NOT collapse onto metric_name and overwrite the MAE entry
            loss_key = (metric_name.replace("mae", "loss")
                        if "mae" in metric_name else metric_name + "_loss")
            summary[loss_key] = m["loss"]
            with open(summary_path, "w") as f:
                json.dump(summary, f, indent=2)
            if verbose:
                print(f"{run_id}: {metric_name} = {m['mae']:.4f} — updated")
        except Exception as e:  # keep going, report per run (test.py:118-120)
            results[run_id] = None
            if verbose:
                print(f"{run_id}: FAILED — {e}")
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("runs_dir")
    p.add_argument("--dataset", required=True)
    p.add_argument("--metric", default="test_AFLW2000_mae")
    p.add_argument("--checkpoint_root", default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' to evaluate on the CPU (default: the card)")
    args = p.parse_args(argv)
    results = backfill_runs(args.runs_dir, args.dataset, args.metric,
                            args.checkpoint_root, device=args.device)
    ok = sum(v is not None for v in results.values())
    print(f"\nSummary: {ok}/{len(results)} runs updated")


if __name__ == "__main__":
    main()
