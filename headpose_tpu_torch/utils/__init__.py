"""Utilities: device resolution, pose geometry, profiling and tracing."""
from .device import resolve_device
from .geometry import euler_to_matrix, pose_axes
from .profiling import FpsCounter, Timer, trace

__all__ = ["resolve_device", "euler_to_matrix", "pose_axes", "FpsCounter",
           "Timer", "trace"]
