"""Model specs, the weight bridge between the JAX layout and the port, and
the conversion of reference H5 heads into native model directories.

A native model directory of the port holds
    spec.json   — the architecture, in the JAX package's spec.json format
    params.npz  — the parameter leaves in JAX layout, keyed by path
                  (e.g. ``backbone/blocks/3/dw_kernel``)

The leaves stay in JAX layout on disk (HWIO convs, depthwise (3, 3, 1, C),
dense (in, out)), so `params_from_jax` is the one conversion on every path:
the committed weights, weights handed over from a JAX process as numpy
arrays, and the tests all go through it.

Conversion (port of headpose_tpu/tools/convert.py, the reference's
InputShapeConvertor rethought): a reference head H5 is imported as a native
head (`models.head_from_h5`, shape-polymorphic, so no input-shape surgery)
and its equivalence proved against the H5's own graph (`core.graph`) on
random vectors and maps, at the reference's bar np.allclose(rtol=1e-5,
atol=1e-5): `validate_conversion`, `convert_head`, `batch_convert` and the
CLI

    python -m headpose_tpu_torch.tools.convert <h5 or dir> <out dir>
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
from typing import Any

import numpy as np
import torch

from ..models.blazeface import BlazeFace
from ..models.heads import (EnsembleHead, MLPHead, ResidualMLPHead,
                            SEMLPHead, SETransformerHead, SkipMLPHead)
from ..models.unified import UnifiedPoseModel

__all__ = ["spec_from_dict", "params_from_jax", "params_to_jax",
           "flatten_params", "unflatten_params", "save_npz", "load_npz",
           "load_native", "ConversionReport", "validate_conversion",
           "convert_head", "batch_convert"]

_HEADS = (MLPHead, ResidualMLPHead, SkipMLPHead, SEMLPHead,
          SETransformerHead, EnsembleHead)
_SPEC_CLASSES = {cls.__name__: cls for cls in (*_HEADS, BlazeFace,
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


def _pairs(spec: Any):
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
    for key, path, layout in _pairs(spec):
        leaf = tree
        for p in path:
            leaf = leaf[p]
        out[key] = _to_torch(leaf, layout)
    return out


def params_to_jax(spec: Any, state_dict: dict[str, torch.Tensor]) -> Any:
    """The inverse of `params_from_jax`: a state_dict → JAX-layout params
    (nested dicts and lists of numpy arrays)."""
    return unflatten_params({"/".join(str(p) for p in path): _to_jax(
        state_dict[key], layout) for key, path, layout in _pairs(spec)})


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



# ------------------------------------------------ reference H5 conversion
@dataclasses.dataclass
class ConversionReport:
    source: str
    output: str | None
    converted: bool
    validated: bool
    max_abs_error: float | None
    error: str | None = None


def validate_conversion(h5_path, spec, params, num_samples: int = 8,
                        rtol: float = 1e-5, atol: float = 1e-5,
                        device: str | torch.device | None = None) -> float:
    """Numeric equivalence of the native head (spec, params in JAX layout)
    and the original H5 graph (a path, or a ModelDef parsed already) on
    random inputs: a batch of vectors and, where the graph takes one, a
    spatial map; both in fp32 with TF32 off on `device` (None: the card).
    Returns the max abs error; raises AssertionError on a mismatch."""
    from ..core.graph import load_graph_model
    from ..models.blazeface import fp32_exact
    from ..models.heads import head_net
    from ..utils.device import resolve_device

    device = resolve_device(device)
    ref = load_graph_model(h5_path, device=device)
    net = head_net(spec, device=device).eval()
    net.load_state_dict(params_from_jax(spec, params))
    rng = np.random.default_rng(0)
    c = spec.in_features

    def run(module, x):
        with fp32_exact(), torch.inference_mode():
            return module(torch.tensor(x, device=device)).cpu().numpy()

    x = rng.normal(size=(num_samples, 1, 1, c)).astype(np.float32) * 3.0
    ref_out = run(ref, x).reshape(num_samples, -1)
    ours = run(net, x.reshape(num_samples, c))
    max_err = float(np.abs(ref_out - ours).max())
    np.testing.assert_allclose(ours, ref_out, rtol=rtol, atol=atol)

    xm = rng.normal(size=(2, 4, 4, c)).astype(np.float32)
    try:
        # only the reference graph may be excused (fixed-shape Flatten
        # variants reject spatial inputs); the native head failing or the
        # comparison failing propagates
        ref_map = run(ref, xm)
    except Exception:
        ref_map = None
    if ref_map is not None:
        ours_map = run(net, xm)
        if ref_map.shape == ours_map.shape:  # fixed-shape H5s can't do maps
            max_err = max(max_err, float(np.abs(ref_map - ours_map).max()))
            np.testing.assert_allclose(ours_map, ref_map, rtol=rtol,
                                       atol=atol)
    return max_err


def convert_head(h5_path: str, out_dir: str, validate: bool = True,
                 device: str | torch.device | None = None
                 ) -> ConversionReport:
    """One reference head H5 → a native model directory under `out_dir`
    (named by the file, less a 'model_runid_' prefix), validated first."""
    from ..models.heads import head_from_h5
    from .export import save_model

    name = re.sub(r"^model_runid_", "", os.path.basename(h5_path))[:-3]
    out_path = os.path.join(out_dir, name)
    try:
        spec, params = head_from_h5(h5_path)
    except Exception as e:
        return ConversionReport(h5_path, None, False, False, None, str(e))
    max_err = None
    if validate:
        try:
            max_err = validate_conversion(h5_path, spec, params,
                                          device=device)
        except Exception as e:
            return ConversionReport(h5_path, None, True, False, None, str(e))
    save_model(out_path, spec, params,
               metadata={"source_h5": os.path.abspath(h5_path)})
    return ConversionReport(h5_path, out_path, True, validate, max_err)


def batch_convert(src_dir: str, out_dir: str, pattern: str = "*.h5",
                  validate: bool = True, verbose: bool = True,
                  device: str | torch.device | None = None
                  ) -> list[ConversionReport]:
    """Convert a directory of head H5s; print the reference-style
    summary."""
    os.makedirs(out_dir, exist_ok=True)
    reports = []
    files = sorted(glob.glob(os.path.join(src_dir, pattern)))
    for i, path in enumerate(files):
        rep = convert_head(path, out_dir, validate, device=device)
        reports.append(rep)
        if verbose:
            status = ("ok" if rep.validated or (rep.converted and not validate)
                      else "FAILED")
            print(f"[{i + 1}/{len(files)}] {os.path.basename(path)}: {status}"
                  + (f" (max_err {rep.max_abs_error:.2e})"
                     if rep.max_abs_error is not None else "")
                  + (f" — {rep.error}" if rep.error else ""))
    converted = sum(r.converted for r in reports)
    validated = sum(r.validated for r in reports)
    failed = len(reports) - sum(bool(r.output) for r in reports)
    if verbose:
        print(f"\nSummary: {len(reports)} files, {converted} converted, "
              f"{validated} validated, {failed} failed")
    return reports


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="H5 file or directory of H5 heads")
    p.add_argument("out", help="output directory for native models")
    p.add_argument("--pattern", default="*.h5")
    p.add_argument("--no_validate", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cpu' to validate on the CPU; default: the card")
    args = p.parse_args(argv)
    if os.path.isdir(args.src):
        batch_convert(args.src, args.out, args.pattern,
                      validate=not args.no_validate, device=args.device)
    else:
        rep = convert_head(args.src, args.out, validate=not args.no_validate,
                           device=args.device)
        print(rep)


if __name__ == "__main__":
    main()
