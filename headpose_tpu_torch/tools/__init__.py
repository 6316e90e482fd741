"""User-facing tools of the port: evaluation, conversion, joining, export,
CLIs.

Exports resolve lazily (PEP 562), so a light consumer does not import the
model and training chain.
"""
import importlib

_EXPORTS = {
    "evaluate_head_pose_model": ".evaluate", "pose_metrics": ".evaluate",
    "save_model": ".export", "load_model": ".export",
    "spec_to_dict": ".export", "spec_from_dict": ".export",
    "convert_head": ".convert", "validate_conversion": ".convert",
    "batch_convert": ".convert",
    "join_and_save": ".join_cli", "extract_id_from_path": ".join_cli",
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
