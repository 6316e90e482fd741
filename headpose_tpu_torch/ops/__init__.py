"""Tensor operations of the port: preprocess, postprocess, their kernels.

Exports resolve lazily (PEP 562), so a light consumer (`runtime.results`,
and through it `runtime.client`, needs only `ops.detection`'s slab layout)
does not import the kernels' wrappers and the models they read."""
import importlib

_EXPORTS = {
    "bicubic_matrix": ".bicubic", "resize_bicubic_np": ".bicubic",
    "MAX_FACES": ".detection", "postprocess": ".detection",
    "decode_boxes": ".detection", "decode_keypoints": ".detection",
    "pairwise_iou": ".detection", "nms_static": ".detection",
    "anchor_cells": ".detection", "gather_poses": ".detection",
    "score_threshold_to_logit": ".detection",
    "sanitize_model_outputs": ".detection",
    "preprocess": ".image", "resize_bicubic": ".image",
    "postprocess_kernel": ".kernels",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
        globals()[name] = value           # cache: __getattr__ runs once
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(__all__) | set(globals()))
