"""Pose geometry: Euler angles → rotation matrices and axis endpoints.

Port of headpose_tpu/utils/geometry.py (numpy only): the math of the
reference's EulerToMatrix / drawAxis_simo, so that the drawing layer needs
no cv2 to compute overlay geometry.

Convention (as the reference uses it): roll about z, yaw about y, pitch
about x, composed R = Rx(pitch) @ Ry(yaw) @ Rz(roll), angles in degrees.
"""
from __future__ import annotations

import numpy as np

__all__ = ["euler_to_matrix", "pose_axes"]


def euler_to_matrix(roll: float, yaw: float, pitch: float) -> np.ndarray:
    """Rotation matrix from Euler angles in degrees (R = Rx @ Ry @ Rz)."""
    r, y, p = np.deg2rad([roll, yaw, pitch])
    cr, sr = np.cos(r), np.sin(r)
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    rz = np.array([[cr, -sr, 0.0], [sr, cr, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    return rx @ ry @ rz


def pose_axes(yaw: float, pitch: float, roll: float,
              cx: float, cy: float, size: float = 100.0) -> dict[str, tuple]:
    """2D endpoints of the head-frame x/y/z axes of an overlay at (cx, cy):
    {'x': (x2, y2), 'y': ..., 'z': ...}, drawAxis_simo's endpoint math
    (negated angles, image-plane projection)."""
    m = euler_to_matrix(-roll, -yaw, -pitch)
    xa, ya, za = m[:, 0] * size, m[:, 1] * size, m[:, 2] * size
    return {
        "x": (cx + xa[0], cy - xa[1]),   # pitch axis (drawn green)
        "y": (cx - ya[0], cy + ya[1]),   # yaw axis (drawn red)
        "z": (cx + za[0], cy - za[1]),   # roll axis (drawn blue)
    }
