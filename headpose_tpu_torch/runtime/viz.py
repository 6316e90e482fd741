"""Detection visualization (cv2 behind a guard).

Port of headpose_tpu/runtime/viz.py, the reference's drawDetections /
draw_axis: boxes, scores, keypoints, per-face pose axes and angle text, and
an FPS overlay.  The geometry is utils.geometry's (numpy); only the
rasterization needs cv2, which is imported when a drawing is made.
"""
from __future__ import annotations

import numpy as np

from ..utils.geometry import pose_axes
from .results import Results

__all__ = ["draw_detections"]

_BOX_COLOR = (250, 22, 22)
_KP_COLOR = (18, 202, 214)
_FPS_COLOR = (22, 250, 22)


def _require_cv2():
    try:
        import cv2
        return cv2
    except ImportError as e:
        raise ImportError(
            "draw_detections needs opencv-python (install extra: viz)") from e


def draw_detections(img: np.ndarray, results: Results,
                    fps: float | None = None,
                    draw_axes: bool = True, draw_angles: bool = True
                    ) -> np.ndarray:
    """Draw boxes, scores, keypoints, pose axes and angle text onto a BGR
    image, in place; returns it."""
    cv2 = _require_cv2()
    h, w = img.shape[:2]
    for i in range(len(results)):
        x1, y1, x2, y2 = results.boxes[i]
        x1, y1, x2, y2 = int(x1 * w), int(y1 * h), int(x2 * w), int(y2 * h)
        cv2.rectangle(img, (x1, y1), (x2, y2), _BOX_COLOR, 2)
        cv2.putText(img, f"{results.scores[i]:.2f}", (x1, y1 - 6),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, _BOX_COLOR, 2)
        for kx, ky in results.keypoints[i]:
            cv2.circle(img, (int(kx * w), int(ky * h)), 4, _KP_COLOR, -1)

        yaw, pitch, roll = results.poses[i]
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        if draw_axes:
            size = max(min(x2 - x1, y2 - y1) / 2, 1)
            axes = pose_axes(yaw, pitch, roll, cx, cy, size)
            cv2.line(img, (int(cx), int(cy)),
                     (int(axes["x"][0]), int(axes["x"][1])), (0, 255, 0), 3)
            cv2.line(img, (int(cx), int(cy)),
                     (int(axes["y"][0]), int(axes["y"][1])), (0, 0, 255), 3)
            cv2.line(img, (int(cx), int(cy)),
                     (int(axes["z"][0]), int(axes["z"][1])), (255, 0, 0), 2)
        if draw_angles:
            for j, (label, val, color) in enumerate((
                    ("Yaw", yaw, (0, 0, 255)), ("Pitch", pitch, (0, 255, 0)),
                    ("Roll", roll, (255, 0, 0)))):
                cv2.putText(img, f"{label}: {val:.2f}", (x1, y2 + 25 + 23 * j),
                            cv2.FONT_HERSHEY_SIMPLEX, 1, color, 2)
    if fps is not None:
        cv2.putText(img, f"FPS: {int(fps)}", (40, 40),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, _FPS_COLOR, 2)
    return img
