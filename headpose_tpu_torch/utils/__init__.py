"""Utilities: device resolution, pose geometry, profiling and tracing.

Exports resolve lazily (PEP 562), so a light consumer (the kernels' op
library needs only `utils.build`) does not import the others."""
import importlib

_EXPORTS = {
    "resolve_device": ".device",
    "euler_to_matrix": ".geometry", "pose_axes": ".geometry",
    "FpsCounter": ".profiling", "Timer": ".profiling", "trace": ".profiling",
}

__all__ = ["resolve_device", "euler_to_matrix", "pose_axes", "FpsCounter",
           "Timer", "trace"]


def __getattr__(name: str):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
        globals()[name] = value           # cache: __getattr__ runs once
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(__all__) | set(globals()))
