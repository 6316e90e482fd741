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
"""
from __future__ import annotations

import json
import os
import warnings

from .tools.convert import load_native

__all__ = ["PRETRAINED_DIR", "FLAGSHIP", "BEST", "UNIFIED_BEST",
           "load_pretrained", "pretrained_quality", "flagship_detector",
           "best_detector"]

PRETRAINED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "pretrained_models")
FLAGSHIP = "unified-stoqa9pt-hrchr82r"
BEST = "unified-best-distilled"
UNIFIED_BEST = "unified-best"


def _path(name: str) -> str:
    path = os.path.join(PRETRAINED_DIR, name)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"pretrained model missing: {path}")
    return path


def load_pretrained(name: str):
    """(UnifiedPoseModel spec, params in JAX layout) of a shipped model.
    Warns (UserWarning) on a 'synthetic-bringup' artifact."""
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
