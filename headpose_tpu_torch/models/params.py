"""The weight bridge: parameter trees in the JAX package's layout and the
port's modules, npz trees and native model directories.

A native model directory of the port holds
    spec.json   — the architecture, in the JAX package's spec.json format
    params.npz  — the parameter leaves in JAX layout, keyed by path
                  (e.g. ``backbone/blocks/3/dw_kernel``)

The leaves stay in JAX layout on disk (HWIO convs, depthwise (3, 3, 1, C),
dense (in, out)), so `params_from_jax` is the one conversion on every path:
the committed weights, weights handed over from a JAX process as numpy
arrays, and the tests all go through it.  `leaf_layouts(spec)` lists each
leaf's state_dict key, JAX path and layout.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .blazeface import BlazeFace
from .heads import (EnsembleHead, MLPHead, ResidualMLPHead, SEMLPHead,
                    SETransformerHead, SkipMLPHead)
from .unified import UnifiedPoseModel

__all__ = ["CONV", "DENSE", "SAME", "SPEC_CLASSES", "spec_from_dict",
           "leaf_layouts", "params_from_jax", "params_to_jax",
           "flatten_params", "unflatten_params", "save_npz", "load_npz",
           "load_native"]

_HEADS = (MLPHead, ResidualMLPHead, SkipMLPHead, SEMLPHead,
          SETransformerHead, EnsembleHead)
SPEC_CLASSES = {cls.__name__: cls for cls in (*_HEADS, BlazeFace,
                                              UnifiedPoseModel)}


# ------------------------------------------------------------------ specs
def _decode(value: Any) -> Any:
    if isinstance(value, dict) and "__spec__" in value:
        name = value["__spec__"]
        if name not in SPEC_CLASSES:
            raise NotImplementedError(
                f"spec type {name!r} is not ported (the port serves "
                f"{sorted(SPEC_CLASSES)})")
        return SPEC_CLASSES[name](**{k: _decode(v)
                                     for k, v in value["fields"].items()})
    if isinstance(value, dict) and "__tuple__" in value:
        return tuple(_decode(v) for v in value["__tuple__"])
    if isinstance(value, list):
        return [_decode(v) for v in value]
    return value


def spec_from_dict(d: dict) -> Any:
    """JSON spec (the JAX package's format) → UnifiedPoseModel, BlazeFace or
    a head of any family.  An unknown spec type raises
    NotImplementedError."""
    return _decode(d)


# ------------------------------------------------------------ the bridge
# Each leaf is converted by what it is, not by its rank: a convolution
# kernel HWIO → OIHW (depthwise (3, 3, 1, C) → (C, 1, 3, 3)), a dense kernel
# (in, out) → nn.Linear's (out, in); everything else (biases, LayerNorm
# gains, the SE-Transformer's (C, H, D) / (H, D) / (H, D, C) attention
# weights) keeps its JAX layout.
CONV, DENSE, SAME = "conv", "dense", "same"


def _to_torch(a: np.ndarray, layout: str) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if layout == CONV:
        a = a.transpose(3, 2, 0, 1)
    elif layout == DENSE:
        a = a.T
    return torch.tensor(np.ascontiguousarray(a))


def _to_jax(t: torch.Tensor, layout: str) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if layout == CONV:
        a = a.transpose(2, 3, 1, 0)
    elif layout == DENSE:
        a = a.T
    return np.ascontiguousarray(a)


def _conv_pairs(spec: BlazeFace):
    """(state_dict key, JAX path, layout) of one backbone's leaves."""
    yield "stem.weight", ("stem", "kernel"), CONV
    yield "stem.bias", ("stem", "bias"), SAME
    for i in range(len(spec.block_channels)):
        for conv in ("dw", "pw"):
            yield (f"blocks.{i}.{conv}.weight",
                   ("blocks", i, f"{conv}_kernel"), CONV)
            yield (f"blocks.{i}.{conv}.bias", ("blocks", i, f"{conv}_bias"),
                   SAME)
    for head in ("cls_front", "cls_back", "loc_front", "loc_back"):
        yield f"{head}.weight", (head, "kernel"), CONV
        yield f"{head}.bias", (head, "bias"), SAME


def _dense(*path):
    """An nn.Linear whose module path is the JAX path of its {w, b}."""
    key = ".".join(str(p) for p in path)
    yield f"{key}.weight", (*path, "w"), DENSE
    yield f"{key}.bias", (*path, "b"), SAME


def _same(*path, leaves=("w", "b")):
    key = ".".join(str(p) for p in path)
    for leaf in leaves:
        yield f"{key}.{leaf}", (*path, leaf), SAME


def _head_pairs(spec: Any):
    """(state_dict key, JAX path, layout) of one head's leaves."""
    if isinstance(spec, MLPHead):
        for i in range(len(spec.layers)):
            yield f"layers.{i}.weight", ("layers", i, "w"), DENSE
            yield f"layers.{i}.bias", ("layers", i, "b"), SAME
    elif isinstance(spec, ResidualMLPHead):
        yield from _dense("proj")
        for b in range(spec.num_blocks):
            yield from _dense("blocks", b, "fc1")
            yield from _dense("blocks", b, "fc2")
        yield from _dense("bottleneck")
        yield from _dense("out")
    elif isinstance(spec, SkipMLPHead):
        for name in ("enc1", "enc2", "dec", "out"):
            yield from _dense(name)
    elif isinstance(spec, SEMLPHead):
        for path in (("se", "fc1"), ("se", "fc2"), ("fc",), ("out",)):
            yield from _dense(*path)
    elif isinstance(spec, SETransformerHead):
        yield from _dense("se", "fc1")
        yield from _dense("se", "fc2")
        for name in ("query", "key", "value", "attn_out"):
            yield from _same(name)
        yield from _same("ln1", leaves=("g", "b"))
        yield from _dense("ff1")
        yield from _dense("ff2")
        yield from _same("ln2", leaves=("g", "b"))
        yield from _dense("fc")
        yield from _dense("out")
    elif isinstance(spec, EnsembleHead):
        for i, member in enumerate(spec.members):
            for key, path, layout in _head_pairs(member):
                yield f"members.{i}.{key}", ("members", i, *path), layout
    elif hasattr(spec, "param_pairs"):    # core.graph.TrainableGraphHead
        for key, path in spec.param_pairs():
            yield key, path, SAME
    else:
        raise NotImplementedError(f"spec type {type(spec).__name__} is not "
                                  "ported")


def leaf_layouts(spec: Any):
    """(state_dict key, JAX path, layout) of each leaf of the module for
    `spec` (a UnifiedPoseModel, a BlazeFace or a head of any family), in
    the module's order; the layout is CONV, DENSE or SAME."""
    if isinstance(spec, UnifiedPoseModel):
        for key, path, layout in _conv_pairs(spec.backbone):
            yield f"backbone.{key}", ("backbone", *path), layout
        for name in ("head88", "head96"):
            head = getattr(spec, name)
            if head is not None:
                for key, path, layout in _head_pairs(head):
                    yield f"{name}.{key}", (name, *path), layout
    elif isinstance(spec, BlazeFace):
        yield from _conv_pairs(spec)
    else:
        yield from _head_pairs(spec)


def params_from_jax(spec: Any, tree: Any) -> dict[str, torch.Tensor]:
    """JAX params (nested dicts and lists of arrays) → the state_dict of the
    port's module for `spec` (UnifiedPoseNet, BlazeFaceNet or a head
    module).  Converts convolution kernels to OIHW and dense kernels to
    (out, in); values are unchanged."""
    out = {}
    for key, path, layout in leaf_layouts(spec):
        leaf = tree
        for p in path:
            leaf = leaf[p]
        out[key] = _to_torch(leaf, layout)
    return out


def params_to_jax(spec: Any, state_dict: dict[str, torch.Tensor]) -> Any:
    """The inverse of `params_from_jax`: a state_dict → JAX-layout params
    (nested dicts and lists of numpy arrays)."""
    return unflatten_params({"/".join(str(p) for p in path): _to_jax(
        state_dict[key], layout) for key, path, layout in leaf_layouts(spec)})


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
