"""Standalone head evaluation, PyTorch edition (Model-96/test.py:9-69).

Port of headpose_tpu/tools/evaluate.py.  `evaluate_head_pose_model(model,
dataset)` → per-angle and average MAE/MSE, printed in the reference's
format.  The head runs as its module in fp32 with TF32 off, the
counterpart of JAX's `_apply_highest`.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..data.datasets import Dataset, load_dataset
from ..models.blazeface import fp32_exact
from ..models.heads import head_net
from ..utils.device import resolve_device
from .convert import load_native, params_from_jax

__all__ = ["evaluate_head_pose_model", "pose_metrics", "predict"]

ANGLES = ("yaw", "pitch", "roll")


def pose_metrics(predictions: np.ndarray, ground_truth: np.ndarray) -> dict:
    """Per-angle and average MAE/MSE, the reference evaluator's schema."""
    predictions = predictions.reshape(ground_truth.shape)
    err = predictions - ground_truth
    mae = np.mean(np.abs(err), axis=0)
    mse = np.mean(np.square(err), axis=0)
    metrics = {
        "MAE": {a: float(mae[i]) for i, a in enumerate(ANGLES)},
        "MSE": {a: float(mse[i]) for i, a in enumerate(ANGLES)},
    }
    metrics["MAE"]["average"] = float(mae.mean())
    metrics["MSE"]["average"] = float(mse.mean())
    return metrics


def _print_metrics(metrics: dict) -> None:
    print("Evaluation Results:")
    print("------------------")
    for kind in ("MAE", "MSE"):
        label = ("Mean Absolute Error (MAE):" if kind == "MAE"
                 else "\nMean Squared Error (MSE):")
        print(label)
        for a in ANGLES:
            print(f"  {a}: {metrics[kind][a]:.4f}")
        print(f"  Average: {metrics[kind]['average']:.4f}")


def predict(spec: Any, params: Any, features: np.ndarray,
            device: str | torch.device | None = None) -> np.ndarray:
    """A head (spec, params in JAX layout) over (N, C) feature rows, as its
    module in fp32 with TF32 off → (N, 3) numpy."""
    device = resolve_device(device)
    net = head_net(spec, device=device).eval()
    net.load_state_dict(params_from_jax(spec, params))
    with fp32_exact(), torch.inference_mode():
        x = torch.as_tensor(np.asarray(features, np.float32), device=device)
        return net(x).cpu().numpy()


def evaluate_head_pose_model(model: Any, dataset: Any, params: Any = None,
                             verbose: bool = True,
                             device: str | torch.device | None = None
                             ) -> dict:
    """Evaluate a pose head on a feature dataset.

    model: a head spec (with `params` in JAX layout) or the path of a
      native model directory (`tools.export.save_model`); an H5 head raises
      NotImplementedError (the H5 import is ROADMAP §1 item 9).
    dataset: a `Dataset` or the path of an .npz.
    device: None (the card) or "cpu"."""
    if isinstance(dataset, str):
        dataset = load_dataset(dataset)
    if not isinstance(dataset, Dataset):
        raise TypeError(f"dataset must be a Dataset or an .npz path, got "
                        f"{type(dataset).__name__}")
    if isinstance(model, str):
        if not os.path.isdir(model):
            raise NotImplementedError(
                f"{model}: reading a reference H5 head is not ported yet "
                "(ROADMAP §1 item 9); pass a native model directory or a "
                "spec with its params")
        model, params = load_native(model)
    if params is None:
        raise ValueError("a head spec needs its params")
    metrics = pose_metrics(predict(model, params, dataset.features, device),
                           dataset.poses)
    if verbose:
        _print_metrics(metrics)
    return metrics
