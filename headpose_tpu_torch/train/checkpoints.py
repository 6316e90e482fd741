"""Checkpoint / resume, PyTorch edition.

JAX's checkpoints are Orbax pytrees, which cannot be read without jax, so
the port writes its own format: a checkpoint is a directory holding
`tree.npz` (the leaves, keyed by path as `tools.convert.flatten_params`
names them, dtypes kept) and `meta.json`.  Training checkpoints carry the
params (JAX layout), the optimizer state, the epoch and the early-stop
bookkeeping, so an interrupted run resumes exactly.  JAX checkpoints reach
the port only through the weight bridge (`tools.convert`); this module
reads none.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from ..tools.convert import flatten_params, unflatten_params

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "save_pytree", "restore_pytree"]

_TREE = "tree.npz"


def _host(tree: Any) -> Any:
    """Tensors (any device) → numpy arrays, containers kept."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_pytree(path: str, tree: Any) -> None:
    """Save one tree of arrays (e.g. the best params) as the directory
    `path`, replacing it; written beside it first and renamed, so a reader
    never sees half a checkpoint."""
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, _TREE), "wb") as f:
        np.savez(f, **flatten_params(_host(tree)))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def restore_pytree(path: str) -> Any:
    """A tree saved by `save_pytree` → nested dicts/lists of numpy arrays."""
    with np.load(os.path.join(path, _TREE), allow_pickle=False) as data:
        return unflatten_params({k: data[k] for k in data.files})


def save_checkpoint(ckpt_dir: str, step: int, params: Any, opt_state: Any,
                    extra: dict[str, Any] | None = None, keep: int = 3,
                    best_params: Any | None = None) -> None:
    """Save a training checkpoint at ckpt_dir/step_<N>; keep the newest
    `keep`.  params/opt_state are the live pair at `step`; `best_params`
    the early-stopping best weights where they differ from the live ones."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}")
    tree = {"params": params, "opt_state": opt_state}
    if best_params is not None:
        tree["best_params"] = best_params
    save_pytree(path, tree)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, "has_best_params": best_params is not None,
                   **(extra or {})}, f, default=_to_py)
    for old in sorted(_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{old}"),
                      ignore_errors=True)


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(ckpt_dir))
            if m]


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str
                       ) -> tuple[int, Any, Any, dict, Any] | None:
    """The newest checkpoint → (step, params, opt_state, meta,
    best_params-or-None), or None if there is none."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    path = os.path.join(ckpt_dir, f"step_{step}")
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    tree = restore_pytree(path)
    return (step, tree["params"], tree.get("opt_state", {}), meta,
            tree.get("best_params"))


def _to_py(v):
    # json.dump's `default`: numeric leaves through the shared converter,
    # anything else as its str
    from .logging import to_jsonable

    j = to_jsonable(v)
    return j if j is not v else str(v)
