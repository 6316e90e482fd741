"""Detection runtime: the detector, its results, the serving front end
(batcher, HTTP server, client), temporal smoothing, IoU tracking,
streaming detection and drawing.

Exports resolve lazily (PEP 562), so a light consumer (`runtime.client`
needs only `results`) does not import the detector and the models.
"""
import importlib

_EXPORTS = {
    "FaceDetector": ".detector",
    "Results": ".results", "BatchResults": ".results",
    "DynamicBatcher": ".server",
    "PoseServer": ".http",
    "PoseClient": ".client",
    "EmaState": ".smoothing", "ema_init": ".smoothing",
    "ema_update": ".smoothing", "smooth_sequence": ".smoothing",
    "TrackSmoother": ".smoothing",
    "IoUTrackSmoother": ".tracking", "TrackState": ".tracking",
    "tracks_init": ".tracking", "tracks_update": ".tracking",
    "detect_stream": ".streaming",
    "draw_detections": ".viz",
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
