"""Pretrained models shipped with the port.

`pretrained_models/<name>/` holds `spec.json` and `params.npz` (JAX-layout
leaves keyed by path; tools.convert).  They are copies of the JAX package's
Orbax checkpoints of the same name, converted leaf for leaf, so loading them
needs neither Orbax nor JAX.

  * 'unified-stoqa9pt-hrchr82r' (FLAGSHIP): the production unified model —
    BlazeFace backbone + SSD heads + reg1 stoqa9pt + reg2 hrchr82r, 110,964
    params, imported from the reference's selected H5.
  * 'unified-best-distilled' (BEST): the same backbone and SSD heads with two
    256-128 tanh MLP pose heads distilled from the stacked ensembles.
  * 'unified-best' (UNIFIED_BEST): the same backbone and SSD heads with the
    two stacked ensembles themselves (EnsembleHead: 33 members on feat88,
    66 on feat96; MLP, residual, skip and SE-MLP members), 979,619 params.
    Its SE-MLP members make FaceDetector's head_eval="auto" serve it under
    the survivors profile.
  * 'unified-back-distilled': the 256-input back-camera topology
    (BLAZEFACE_BACK: 17 blocks, downsample blocks (0, 3, 6, 12), tap at
    block 11) distilled from the flagship on synthetic imagery, with the
    flagship's pose heads.  A topology bring-up, not a real-world
    back-camera detector: its spec.json labels it 'synthetic-bringup', and
    `load_pretrained` warns on it.

and the 14 pose heads of the JAX package's registry (`HEADS`), each a
(head spec, params) pair for `tools.evaluate`, `train.fit` (as initial
params) and `models.join_models`: the reference's production heads
'stoqa9pt-88' and 'hrchr82r-96' (imported); the trained-here sweep winners
'sweep88-best' and 'sweep96-best'; 'distill96', 'stack88-distilled' and
'stack96-distilled' (single MLPs distilled from teachers); and the
ensembles 'ensemble88', 'ensemble88-mixed', 'ensemble88-stacked',
'ensemble88-stacked-mixed', 'ensemble96', 'ensemble96-stacked' and
'ensemble96-stacked-mixed'.  Their provenance is in each spec.json's
metadata (and in headpose_tpu/pretrained.py's docstring).
"""
from __future__ import annotations

import json
import os
import warnings

from .tools.convert import load_native

__all__ = ["PRETRAINED_DIR", "FLAGSHIP", "BEST", "UNIFIED_BEST", "HEADS",
           "load_pretrained", "pretrained_quality", "resolve_model_path",
           "flagship_path", "load_flagship", "flagship_detector",
           "best_detector"]

PRETRAINED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "pretrained_models")
FLAGSHIP = "unified-stoqa9pt-hrchr82r"
BEST = "unified-best-distilled"
UNIFIED_BEST = "unified-best"
HEADS = ("stoqa9pt-88", "hrchr82r-96", "sweep88-best", "sweep96-best",
         "distill96", "stack88-distilled", "stack96-distilled",
         "ensemble88", "ensemble88-mixed", "ensemble88-stacked",
         "ensemble88-stacked-mixed", "ensemble96", "ensemble96-stacked",
         "ensemble96-stacked-mixed")


def _path(name: str) -> str:
    path = os.path.join(PRETRAINED_DIR, name)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"pretrained model missing: {path}")
    return path


def load_pretrained(name: str):
    """(spec, params in JAX layout) of a shipped artifact: a
    UnifiedPoseModel, or a head for the names in `HEADS`.  Warns
    (UserWarning) on a 'synthetic-bringup' artifact."""
    path = _path(name)
    if pretrained_quality(name) == "synthetic-bringup":
        warnings.warn(
            f"'{name}' is a synthetic-imagery bring-up artifact (its "
            "metadata documents the provenance): NOT parity-certified "
            "against the reference and NOT validated on real-world data; "
            "treat its outputs accordingly", UserWarning, stacklevel=2)
    return load_native(path)


def pretrained_quality(name: str) -> str:
    """The provenance tier in a shipped artifact's spec.json metadata:
    'parity-certified' (imported reference production weights),
    'trained-here' (weights trained on shipped data), 'synthetic-bringup'
    (a topology bring-up on synthetic imagery, e.g. 'unified-back-
    distilled'), or 'unlabeled' where the metadata names none."""
    path = os.path.join(_path(name), "spec.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"pretrained model missing: {path}")
    with open(path) as f:
        return json.load(f).get("metadata", {}).get("quality", "unlabeled")


def resolve_model_path(model_path: str | None) -> str | None:
    """Map a pretrained registry name (e.g. 'unified-best') to its shipped
    model directory; paths that exist on disk (and None) pass through.
    The --model flags of the serving and offline entry points route through
    this, so registry names work anywhere a path does."""
    if model_path is not None and not os.path.exists(model_path):
        registry = os.path.join(PRETRAINED_DIR, model_path)
        if os.path.isdir(registry):
            return registry
    return model_path


def flagship_path() -> str | None:
    path = os.path.join(PRETRAINED_DIR, FLAGSHIP)
    return path if os.path.isdir(path) else None


def load_flagship():
    """(UnifiedPoseModel spec, params in JAX layout) of the production
    model."""
    return load_pretrained(FLAGSHIP)


def flagship_detector(**kwargs):
    """A FaceDetector on the production model.  `device=None` (the default)
    means the CUDA device and raises when there is none."""
    from .runtime.detector import FaceDetector

    return FaceDetector.from_native(_path(FLAGSHIP), **kwargs)


def best_detector(**kwargs):
    """A FaceDetector on 'unified-best-distilled': the flagship's detections
    with the distilled 256-128 tanh pose heads."""
    from .runtime.detector import FaceDetector

    return FaceDetector.from_native(_path(BEST), **kwargs)
