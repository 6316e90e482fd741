"""Model specs and the weight bridge between the JAX layout and the port.

A native model directory of the port holds
    spec.json   — the architecture, in the JAX package's spec.json format
    params.npz  — the parameter leaves in JAX layout, keyed by path
                  (e.g. ``backbone/blocks/3/dw_kernel``)

The leaves stay in JAX layout on disk (HWIO convs, depthwise (3, 3, 1, C),
dense (in, out)), so `params_from_jax` is the one conversion on every path:
the committed weights, weights handed over from a JAX process as numpy
arrays, and the tests all go through it.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..models.blazeface import BlazeFace
from ..models.heads import MLPHead
from ..models.unified import UnifiedPoseModel

__all__ = ["spec_from_dict", "params_from_jax", "params_to_jax",
           "flatten_params", "unflatten_params", "save_npz", "load_npz",
           "load_native"]

_SPEC_CLASSES = {cls.__name__: cls for cls in (MLPHead, BlazeFace,
                                               UnifiedPoseModel)}


# ------------------------------------------------------------------ specs
def _decode(value: Any) -> Any:
    if isinstance(value, dict) and "__spec__" in value:
        name = value["__spec__"]
        if name not in _SPEC_CLASSES:
            raise NotImplementedError(
                f"spec type {name!r} is not ported (the port serves "
                f"{sorted(_SPEC_CLASSES)})")
        return _SPEC_CLASSES[name](**{k: _decode(v)
                                      for k, v in value["fields"].items()})
    if isinstance(value, dict) and "__tuple__" in value:
        return tuple(_decode(v) for v in value["__tuple__"])
    if isinstance(value, list):
        return [_decode(v) for v in value]
    return value


def spec_from_dict(d: dict) -> Any:
    """JSON spec (the JAX package's format) → UnifiedPoseModel / BlazeFace /
    MLPHead.  Other head types raise NotImplementedError."""
    return _decode(d)


# ------------------------------------------------------------ the bridge
def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if a.ndim == 4:      # HWIO → OIHW; depthwise (3,3,1,C) → (C,1,3,3)
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2:    # dense (in, out) → (out, in)
        a = a.T
    return torch.tensor(np.ascontiguousarray(a))


def _to_jax(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)
    elif a.ndim == 2:
        a = a.T
    return np.ascontiguousarray(a)


def _conv_pairs(spec: BlazeFace, prefix: str):
    """(state_dict key, JAX path) pairs of one backbone."""
    yield f"{prefix}stem.weight", ("stem", "kernel")
    yield f"{prefix}stem.bias", ("stem", "bias")
    for i in range(len(spec.block_channels)):
        for conv in ("dw", "pw"):
            yield (f"{prefix}blocks.{i}.{conv}.weight",
                   ("blocks", i, f"{conv}_kernel"))
            yield (f"{prefix}blocks.{i}.{conv}.bias",
                   ("blocks", i, f"{conv}_bias"))
    for head in ("cls_front", "cls_back", "loc_front", "loc_back"):
        yield f"{prefix}{head}.weight", (head, "kernel")
        yield f"{prefix}{head}.bias", (head, "bias")


def _head_pairs(spec: MLPHead, prefix: str):
    for i in range(len(spec.layers)):
        yield f"{prefix}layers.{i}.weight", ("layers", i, "w")
        yield f"{prefix}layers.{i}.bias", ("layers", i, "b")


def _pairs(spec: Any):
    if isinstance(spec, UnifiedPoseModel):
        for key, path in _conv_pairs(spec.backbone, "backbone."):
            yield key, ("backbone", *path)
        for name in ("head88", "head96"):
            head = getattr(spec, name)
            if head is not None:
                for key, path in _head_pairs(head, f"{name}."):
                    yield key, (name, *path)
    elif isinstance(spec, BlazeFace):
        yield from _conv_pairs(spec, "")
    elif isinstance(spec, MLPHead):
        yield from _head_pairs(spec, "")
    else:
        raise NotImplementedError(f"spec type {type(spec).__name__} is not "
                                  "ported")


def params_from_jax(spec: Any, tree: Any) -> dict[str, torch.Tensor]:
    """JAX params (nested dicts and lists of arrays) → the state_dict of the
    port's module for `spec` (UnifiedPoseNet / BlazeFaceNet / MLPHeadNet).
    Converts HWIO → OIHW, depthwise (3, 3, 1, C) → (C, 1, 3, 3) and dense
    (in, out) → (out, in); values are unchanged."""
    out = {}
    for key, path in _pairs(spec):
        leaf = tree
        for p in path:
            leaf = leaf[p]
        out[key] = _to_torch(leaf)
    return out


def params_to_jax(spec: Any, state_dict: dict[str, torch.Tensor]) -> Any:
    """The inverse of `params_from_jax`: a state_dict → JAX-layout params
    (nested dicts and lists of numpy arrays)."""
    return unflatten_params({"/".join(str(p) for p in path): _to_jax(
        state_dict[key]) for key, path in _pairs(spec)})


# ------------------------------------------------------------- npz files
def flatten_params(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists of arrays → {"a/b/0/c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_params(flat: dict[str, np.ndarray]) -> Any:
    """Inverse of `flatten_params`: integer path parts become list indices."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_npz(path: str, tree: Any) -> None:
    """Save params (JAX layout) as path-keyed float32 leaves."""
    flat = {k: np.asarray(v, np.float32) for k, v in
            flatten_params(tree).items()}
    with open(path, "wb") as f:     # a file object: np.savez adds no suffix
        np.savez(f, **flat)


def load_npz(path: str) -> Any:
    """Load params saved by `save_npz` → nested dicts/lists of numpy arrays."""
    with np.load(path, allow_pickle=False) as data:
        return unflatten_params({k: data[k] for k in data.files})


# ------------------------------------------------- native model directory
def load_native(path: str) -> tuple[Any, Any]:
    """A native model directory → (spec, params in JAX layout)."""
    with open(os.path.join(path, "spec.json")) as f:
        doc = json.load(f)
    return (spec_from_dict(doc["spec"]),
            load_npz(os.path.join(path, "params.npz")))

