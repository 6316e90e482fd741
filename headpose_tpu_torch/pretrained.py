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
"""
from __future__ import annotations

import os

from .tools.convert import load_native

__all__ = ["PRETRAINED_DIR", "FLAGSHIP", "BEST", "UNIFIED_BEST",
           "load_pretrained", "flagship_detector", "best_detector"]

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
    """(UnifiedPoseModel spec, params in JAX layout) of a shipped model."""
    return load_native(_path(name))


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
