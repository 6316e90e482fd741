"""Checkpoint / resume, PyTorch edition.

JAX's checkpoints are Orbax pytrees, which cannot be read without jax, so
the port writes its own format: a checkpoint is a directory holding
`tree.npz` (the leaves, keyed by path as `models.params.flatten_params`
names them, dtypes kept) and `meta.json`.  Training checkpoints carry the
params (JAX layout), the optimizer state, the epoch and the early-stop
bookkeeping, so an interrupted run resumes exactly.  JAX checkpoints reach
the port only through the weight bridge (`models.params`); this module
reads none.

Under a process group of more than one rank every rank calls the savers
(as every JAX process enters orbax's collective save): each first gathers
its DTensor leaves (`full_tensor()`, a collective), then rank 0 alone
removes, writes and prunes, and every rank meets at a barrier before it
returns, so a rank that goes on to restore reads the finished checkpoint.
The directory must be the same path on every rank.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..models.params import flatten_params, unflatten_params
from ..parallel.distributed import barrier, is_distributed

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "save_pytree", "restore_pytree"]

_TREE = "tree.npz"


def _host(tree: Any) -> Any:
    """Tensors (any device; a DTensor gathered whole) → numpy arrays,
    containers kept."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _writer() -> bool:
    """Whether this process writes: rank 0 under a process group of more
    than one rank, else the one process."""
    return not is_distributed() or dist.get_rank() == 0


def save_pytree(path: str, tree: Any) -> None:
    """Save one tree of arrays (e.g. the best params) as the directory
    `path`, replacing it; written beside it first and renamed, so a reader
    never sees half a checkpoint.  Under a process group, rank 0 writes
    and every rank returns after it has (see the module's notes)."""
    host = _host(tree)                  # every rank: DTensors gather here
    if _writer():
        _write_tree(os.path.abspath(path), host)
    barrier()


def _write_tree(path: str, host: Any) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, _TREE), "wb") as f:
        np.savez(f, **flatten_params(host))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _impose(like: Any, tree: Any) -> Any:
    """`tree`'s leaves on `like`'s structure: containers take `like`'s types
    (a tuple or NamedTuple comes back as one), leaves stay as restored.  An
    empty container saves no leaf, so it is restored from `like` alone."""
    if isinstance(like, (dict, list, tuple)) and not like:
        return type(like)()
    if isinstance(like, dict):
        return type(like)((k, _impose(v, tree[k])) for k, v in like.items())
    if isinstance(like, (list, tuple)):
        items = [_impose(v, tree[i]) for i, v in enumerate(like)]
        if hasattr(like, "_fields"):                  # a NamedTuple
            return type(like)(*items)
        return type(like)(items)
    return tree


def restore_pytree(path: str, like: Any | None = None) -> Any:
    """A tree saved by `save_pytree` → nested dicts/lists of numpy arrays.
    With `like`, the restored leaves are re-imposed onto its structure and
    container types (tuples, NamedTuples), as JAX's `restore_pytree` does."""
    with np.load(os.path.join(path, _TREE), allow_pickle=False) as data:
        tree = unflatten_params({k: data[k] for k in data.files})
    return tree if like is None else _impose(like, tree)


def save_checkpoint(ckpt_dir: str, step: int, params: Any, opt_state: Any,
                    extra: dict[str, Any] | None = None, keep: int = 3,
                    best_params: Any | None = None) -> None:
    """Save a training checkpoint at ckpt_dir/step_<N>; keep the newest
    `keep`.  params/opt_state are the live pair at `step`; `best_params`
    the early-stopping best weights where they differ from the live ones."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    tree = {"params": params, "opt_state": opt_state}
    if best_params is not None:
        tree["best_params"] = best_params
    host = _host(tree)                  # every rank: DTensors gather here
    if _writer():
        os.makedirs(ckpt_dir, exist_ok=True)
        _write_tree(os.path.abspath(path), host)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"step": step,
                       "has_best_params": best_params is not None,
                       **(extra or {})}, f, default=_to_py)
        for old in sorted(_steps(ckpt_dir))[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{old}"),
                          ignore_errors=True)
    barrier()


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(ckpt_dir))
            if m]


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like: Any | None = None
                       ) -> tuple[int, Any, Any, dict, Any] | None:
    """The newest checkpoint → (step, params, opt_state, meta,
    best_params-or-None), or None if there is none.  `like` ({"params": ...,
    "opt_state": ...}) gives the restored tree its structure and types, as
    `restore_pytree` does; `best_params`, where saved, shares `params`'."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    path = os.path.join(ckpt_dir, f"step_{step}")
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if like is not None and meta.get("has_best_params"):
        like = {**like, "best_params": like["params"]}
    tree = restore_pytree(path, like)
    return (step, tree["params"], tree.get("opt_state", {}), meta,
            tree.get("best_params"))


def _to_py(v):
    # json.dump's `default`: numeric leaves through the shared converter,
    # anything else as its str
    from .logging import to_jsonable

    j = to_jsonable(v)
    return j if j is not v else str(v)
