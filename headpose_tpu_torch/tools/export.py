"""Native model serialization, PyTorch edition: spec JSON + params npz.

Port of headpose_tpu/tools/export.py.  The port's native model directory
holds
    spec.json   — {"spec": ..., "metadata": ...}, the JAX package's spec
                  format (frozen dataclass fields, recursive)
    params.npz  — the parameter leaves in JAX layout, keyed by path
                  (`tools.convert.save_npz`)
`FaceDetector.from_native`, `tools.convert.load_native` and `load_model`
read it.  The JAX package's own directories hold Orbax params instead,
which the port reaches only through the weight bridge.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from .convert import _SPEC_CLASSES, load_native, save_npz, spec_from_dict

__all__ = ["save_model", "load_model", "spec_to_dict", "spec_from_dict"]


def _encode(value: Any) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        if type(value).__name__ not in _SPEC_CLASSES:
            raise ValueError(f"unknown spec type {type(value).__name__}")
        return {"__spec__": type(value).__name__,
                "fields": {f.name: _encode(getattr(value, f.name))
                           for f in dataclasses.fields(value)}}
    if isinstance(value, tuple):
        return {"__tuple__": [_encode(v) for v in value]}
    if isinstance(value, list):
        return [_encode(v) for v in value]
    return value


def spec_to_dict(spec: Any) -> dict:
    """A spec (unified model, backbone or head of any family) → the JSON
    dict of the JAX package's spec.json."""
    return _encode(spec)


def save_model(path: str, spec: Any, params: Any,
               metadata: dict | None = None) -> None:
    """Save (spec, params in JAX layout) as a native model directory."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "spec.json"), "w") as f:
        json.dump({"spec": spec_to_dict(spec), "metadata": metadata or {}},
                  f, indent=2)
    save_npz(os.path.join(path, "params.npz"), params)


def load_model(path: str) -> tuple[Any, Any]:
    """A native model directory → (spec, params in JAX layout, numpy)."""
    return load_native(path)
