"""Training / sweep CLI, PyTorch edition (port of
headpose_tpu/tools/train_cli.py) — the entry-point equivalents of the
reference's
``python train_96.py --num_filters ...`` (train_96.py:215-238),
``python train_88.py`` (train_88.py:401-403), and ``wandb agent`` driving
sweep.yaml.

Usage:
    python -m headpose_tpu_torch.tools.train_cli --family 96 --num_filters 64
    python -m headpose_tpu_torch.tools.train_cli --family 88
    python -m headpose_tpu_torch.tools.train_cli --family 96 --sweep path/to/sweep.yaml

It trains on the card; `--device cpu` asks for the CPU.  Each run writes
runs/<id>/ (config.json, metrics.jsonl, summary.json) and its checkpoints
under --checkpoint_dir/<id>/.  The dataset directory resolves from
--data_dir, then $FEATUREMAPS_DIR_PATH, then ./FeatureMaps-Datasets.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..data import standard_splits
from ..utils.device import resolve_device
from ..train import (TrainConfig, config_88, config_96, fit, make_logger,
                     new_run_id, angle_distribution_summary,
                     load_sweep_file, run_sweep)

DEFAULT_DATA_DIR = os.environ.get("FEATUREMAPS_DIR_PATH",
                                  "FeatureMaps-Datasets")


def _base_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", choices=("88", "96"), default="96")
    p.add_argument("--data_dir", default=DEFAULT_DATA_DIR)
    p.add_argument("--sweep", default=None, help="sweep YAML/JSON (wandb schema)")
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--runs_dir", default="runs")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--use_sample_weights", action="store_true")
    # sweep-driven hyperparameters (same flags as train_96.py:217-235)
    p.add_argument("--dropout_rate", type=float, default=None)
    p.add_argument("--regularizer_rate", type=float, default=None)
    p.add_argument("--num_filters", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--optimizer", default=None)
    p.add_argument("--head", default=None)
    p.add_argument("--total_epochs", type=int, default=None)
    p.add_argument("--run_name", default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' to train on the CPU (default: the card)")
    return p


def _make_config(args) -> TrainConfig:
    cfg = config_88() if args.family == "88" else config_96()
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and hasattr(cfg, k)}
    return cfg.replace(**overrides)


def _run_once(cfg: TrainConfig, splits, args) -> dict[str, float]:
    run_id = cfg.run_name or new_run_id()
    cfg = cfg.replace(run_name=run_id)
    run_dir = os.path.join(args.runs_dir, run_id)
    logger = make_logger(run_dir, cfg.to_dict(), args.wandb_project)

    train_ds = splits["train"]
    logger.summary({"angle_distributions":
                    angle_distribution_summary(train_ds.poses)})
    test_sets = {k[5:]: v for k, v in splits.items() if k.startswith("test_")}
    result = fit(cfg, train_ds, test_sets=test_sets, logger=logger,
                 resume=args.resume, progress_every=25, device=args.device)
    logger.finish()

    out = {"val_loss": result.best_val_loss, "run_id": run_id}
    for name, m in result.test_metrics.items():
        out[f"test_{name}_mae"] = m["mae"]
        out[f"test_{name}_loss"] = m["loss"]
    # reference sweep objective name (sweep.yaml:3-5)
    if "test_aflw2000_mae" in out:
        out["test_AFLW2000_mae"] = out["test_aflw2000_mae"]
    print(json.dumps(out, indent=2))
    return out


def main(argv=None) -> None:
    args = _base_parser().parse_args(argv)
    resolve_device(args.device)           # no card and no --device: raise
    channels = 88 if args.family == "88" else 96
    splits = standard_splits(args.data_dir, channels,
                             with_weights=args.use_sample_weights)
    if "train" not in splits:
        sys.exit(f"no training datasets found under {args.data_dir}")

    if args.sweep:
        sweep_cfg = load_sweep_file(args.sweep)
        # gate BEFORE training: an unproducible sweep metric (e.g. the
        # AFLW2000 test npz missing from data_dir) would otherwise KeyError
        # in run_sweep only after the first full training run completes,
        # losing every finished run's results
        producible = {"val_loss"}
        for k in splits:
            if k.startswith("test_"):
                producible.update({f"{k}_mae", f"{k}_loss"})
        if "test_aflw2000_mae" in producible:  # reference sweep.yaml alias
            producible.add("test_AFLW2000_mae")
        if sweep_cfg.metric not in producible:
            sys.exit(
                f"sweep metric {sweep_cfg.metric!r} cannot be produced from "
                f"the datasets under {args.data_dir} "
                f"(producible: {sorted(producible)})")

        def objective(assignment):
            cfg = _make_config(args).replace(run_name=None, **assignment)
            return _run_once(cfg, splits, args)

        result = run_sweep(sweep_cfg, objective)
        print("best:", json.dumps(result.best, indent=2, default=str))
        with open(os.path.join(args.runs_dir, "sweep_result.json"), "w") as f:
            json.dump({"best": result.best, "runs": result.runs}, f,
                      indent=2, default=str)
    else:
        _run_once(_make_config(args), splits, args)


if __name__ == "__main__":
    main()
