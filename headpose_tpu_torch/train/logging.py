"""Metric logging / observability, PyTorch edition.

Port of headpose_tpu/train/logging.py.

The reference logs everything to wandb (per-epoch metrics, run summaries,
angle-distribution images — SURVEY.md §5.5).  wandb is optional here: the
always-available backend is a local JSONL run directory with the same logical
schema (per-epoch log + final summary), and a WandbLogger activates when the
package is importable.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Protocol

import numpy as np
import torch

__all__ = ["MetricLogger", "JsonlLogger", "WandbLogger", "MultiLogger",
           "make_logger", "new_run_id", "angle_distribution_summary",
           "learning_curve_summary", "plot_learning_curves",
           "plot_angle_distributions", "to_jsonable"]


def new_run_id() -> str:
    return uuid.uuid4().hex[:8]


class MetricLogger(Protocol):
    def log(self, metrics: dict[str, Any], step: int | None = None) -> None: ...
    def summary(self, values: dict[str, Any]) -> None: ...
    def finish(self) -> None: ...


class JsonlLogger:
    """Local run directory: config.json + metrics.jsonl + summary.json."""

    def __init__(self, run_dir: str, config: dict[str, Any] | None = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        if config is not None:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)
        self._f = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._summary: dict[str, Any] = {}

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        rec = {"_time": time.time()}
        if step is not None:
            rec["step"] = step
        rec.update({k: _to_py(v) for k, v in metrics.items()})
        # default=str: a non-numeric object must degrade to its repr, not
        # kill the training run mid-epoch with a TypeError
        self._f.write(json.dumps(rec, default=str) + "\n")
        self._f.flush()

    def summary(self, values: dict[str, Any]) -> None:
        self._summary.update({k: _to_py(v) for k, v in values.items()})
        with open(os.path.join(self.run_dir, "summary.json"), "w") as f:
            json.dump(self._summary, f, indent=2, default=str)

    def finish(self) -> None:
        self._f.close()


class WandbLogger:
    """wandb backend matching the reference's usage (project/config/tags at
    init, per-epoch wandb.log, run summary).  Import-gated."""

    def __init__(self, project: str, config: dict[str, Any] | None = None,
                 tags: list[str] | None = None, notes: str = ""):
        import wandb  # noqa: deferred, optional dependency

        self._wandb = wandb
        self.run = wandb.init(project=project, config=config, tags=tags, notes=notes)

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        self._wandb.log(metrics, step=step)

    def summary(self, values: dict[str, Any]) -> None:
        for k, v in values.items():
            self.run.summary[k] = v

    def finish(self) -> None:
        self.run.finish()


class MultiLogger:
    def __init__(self, *loggers: MetricLogger):
        self.loggers = [l for l in loggers if l is not None]

    def log(self, metrics, step=None):
        for l in self.loggers:
            l.log(metrics, step)

    def summary(self, values):
        for l in self.loggers:
            l.summary(values)

    def finish(self):
        for l in self.loggers:
            l.finish()


def make_logger(run_dir: str, config: dict[str, Any] | None = None,
                wandb_project: str | None = None) -> MetricLogger:
    """JSONL always; wandb stacked on top when requested AND importable."""
    loggers: list[MetricLogger] = [JsonlLogger(run_dir, config)]
    if wandb_project:
        try:
            loggers.append(WandbLogger(wandb_project, config))
        except ImportError:
            pass
    return MultiLogger(*loggers) if len(loggers) > 1 else loggers[0]


def learning_curve_summary(history: list[dict[str, Any]]) -> dict[str, Any]:
    """Numeric counterpart of log_learningcurves (Model-88/utilities.py:93-129):
    the loss/MAE curves plus best-epoch markers, ready to plot or log."""
    if not history:
        return {}
    keys = ("train_loss", "val_loss", "train_mae", "val_mae")
    curves = {k: [float(h[k]) for h in history] for k in keys if k in history[0]}
    best = int(np.argmin(curves.get("val_loss", [0.0])))
    return {"curves": curves, "best_epoch": best + 1,
            **{f"best_epoch_{k}": curves[k][best] for k in curves}}


def plot_learning_curves(history: list[dict[str, Any]], path: str) -> str | None:
    """Optional matplotlib rendering of the learning curves to a PNG."""
    if not history:
        # e.g. every epoch hit the NaN-recovery path — nothing to plot,
        # degrade like the matplotlib-missing case instead of KeyError
        return None
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    s = learning_curve_summary(history)
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    for ax, pair in zip(axes, (("train_loss", "val_loss"),
                               ("train_mae", "val_mae"))):
        for k in pair:
            if k in s["curves"]:
                ax.plot(s["curves"][k], label=k)
        ax.axvline(s["best_epoch"] - 1, ls="--", c="gray", lw=1)
        ax.legend()
        ax.set_xlabel("epoch")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_angle_distributions(train_poses: np.ndarray, test_poses: np.ndarray,
                             path: str) -> str | None:
    """2x3 histogram grid of yaw/pitch/roll for train and test sets — the
    image artifact of analyze_angle_distributions (Model-88/utilities.py:80-125),
    written to a PNG instead of wandb.  Returns the path, or None without
    matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, axes = plt.subplots(2, 3, figsize=(15, 10))
    fig.suptitle("Angle Distributions in Train and Test Sets", fontsize=16)
    for row, (poses, label, color) in enumerate(
            ((np.unique(train_poses, axis=0), "Train", "blue"),
             (np.unique(test_poses, axis=0), "Test", "red"))):
        for idx, name in enumerate(("Yaw", "Pitch", "Roll")):
            ax = axes[row][idx]
            ax.hist(poses[:, idx], bins=50, alpha=0.5, label=label, color=color)
            ax.set_title(f"{name} Distribution")
            ax.set_xlabel("Angle (degrees)")
            ax.set_ylabel("Count")
            ax.legend()
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def angle_distribution_summary(poses: np.ndarray) -> dict[str, Any]:
    """Numeric counterpart of the reference's angle-distribution histograms
    (Model-88/utilities.py:46-91): dedup, then per-angle histogram stats."""
    unique = np.unique(poses, axis=0)
    out: dict[str, Any] = {"num_unique": int(unique.shape[0])}
    for i, name in enumerate(("yaw", "pitch", "roll")):
        col = unique[:, i]
        hist, edges = np.histogram(col, bins=50)
        out[name] = {
            "min": float(col.min()), "max": float(col.max()),
            "mean": float(col.mean()), "std": float(col.std()),
            "hist": hist.tolist(),
            "bin_edges": [float(edges[0]), float(edges[-1])],
        }
    return out


def to_jsonable(v):
    """numpy scalars and torch/numpy 0-d arrays → Python scalars, arrays →
    nested lists, everything else unchanged.  The one converter for run
    artifacts (JSONL metrics, summary.json, checkpoint metadata)."""
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        return v.item()
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return v.item() if v.ndim == 0 else v.tolist()
    return v


_to_py = to_jsonable  # internal alias
