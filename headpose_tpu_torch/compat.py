"""Drop-in compatibility shim for the reference API, PyTorch edition.

Port of headpose_tpu/compat.py.  Users of the reference instantiate
``blazeFaceDetector(scoreThreshold, iouThreshold)`` and call
``detectFaces(image)`` / ``drawDetections(img, results)``; this module gives
the same names on top of the port's runtime, so such call sites run
unchanged:

    from headpose_tpu_torch.compat import blazeFaceDetector
    detector = blazeFaceDetector()          # on the card
    results = detector.detectFaces(frame)   # .boxes .keypoints .scores .poses
    frame = detector.drawDetections(frame, results)

New code should use headpose_tpu_torch.runtime.FaceDetector directly
(batched, explicit).
"""
from __future__ import annotations

import math
import os

import numpy as np

from .runtime.results import Results
from .utils.profiling import FpsCounter

__all__ = ["blazeFaceDetector", "Results", "KEY_POINT_SIZE", "MAX_FACE_NUM",
           "INPUT_FRONT", "INPUT_BACK",
           "EMAFilter", "SsdAnchorsCalculatorOptions", "Anchor", "gen_anchors",
           "EulerToMatrix", "drawAxis_simo"]

# Not mirrored: the reference class's private pipeline stages
# (prepareInputForInference / inference / extractDetections /
# filterDetections / filterWithNonMaxSupression), which its own detectFaces
# composes; runtime.detector replaces them, and detectFaces is held to the
# JAX package's (tests/test_torch_compat.py).

# reference constants
KEY_POINT_SIZE = 6
MAX_FACE_NUM = 100
INPUT_FRONT = 128
INPUT_BACK = 256


class EMAFilter:
    """The reference demo's scalar smoother with its signature, with the
    seeding EMA of runtime.smoothing: the first update seeds the state,
    later ones blend with weight `alpha` on the new sample.  New code should
    use runtime.smoothing.TrackSmoother (vectorized, per slot)."""

    def __init__(self, alpha: float, initial_value: float = 0.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"EMA weight must lie in (0, 1]; got {alpha}")
        self.alpha = float(alpha)
        self.state = initial_value
        self.initialized = False

    def update(self, measurement: float) -> float:
        # y = alpha*x + (1-alpha)*y after the seeding sample
        if self.initialized:
            self.state = (self.alpha * measurement
                          + (1.0 - self.alpha) * self.state)
        else:
            self.state, self.initialized = measurement, True
        return self.state


class SsdAnchorsCalculatorOptions:
    """Anchor-generation options with the reference's constructor
    signature, backed by models.anchors.AnchorConfig."""

    def __init__(self, input_size_width, input_size_height, min_scale,
                 max_scale, num_layers, feature_map_width, feature_map_height,
                 strides, aspect_ratios, anchor_offset_x=0.5,
                 anchor_offset_y=0.5, reduce_boxes_in_lowest_layer=False,
                 interpolated_scale_aspect_ratio=1.0, fixed_anchor_size=False):
        from .models.anchors import AnchorConfig

        if list(feature_map_width) or list(feature_map_height):
            raise NotImplementedError(
                "explicit feature_map sizes are unused by the reference "
                "configs; stride-derived grids only")
        self.config = AnchorConfig(
            input_width=input_size_width, input_height=input_size_height,
            min_scale=min_scale, max_scale=max_scale, strides=tuple(strides),
            aspect_ratios=tuple(aspect_ratios),
            anchor_offset_x=anchor_offset_x, anchor_offset_y=anchor_offset_y,
            interpolated_scale_aspect_ratio=interpolated_scale_aspect_ratio,
            fixed_anchor_size=fixed_anchor_size,
            reduce_boxes_in_lowest_layer=reduce_boxes_in_lowest_layer)
        if num_layers != len(self.config.strides):
            raise ValueError("num_layers must equal len(strides)")


class Anchor:
    """Anchor record with the reference's field names."""

    def __init__(self, x_center, y_center, h, w):
        self.x_center, self.y_center, self.h, self.w = x_center, y_center, h, w

    def to_string(self):
        return (f"x_center: {self.x_center}, y_center: {self.y_center}, "
                f"h: {self.h}, w: {self.w}")


def gen_anchors(options: SsdAnchorsCalculatorOptions) -> list[Anchor]:
    """The reference's anchor list, from the vectorized table."""
    from .models.anchors import generate_anchors

    table = generate_anchors(options.config)
    return [Anchor(x, y, h, w) for x, y, w, h in table]


class blazeFaceDetector:  # noqa: N801 — the reference's name
    """The reference's detector facade over runtime.FaceDetector.

    `model_path`: None (the shipped flagship), a pretrained registry name,
    a native model directory or a unified H5 (FaceDetector.from_h5).
    `device`: None (the card) or "cpu"."""

    def __init__(self, scoreThreshold: float = 0.4, iouThreshold: float = 0.3,
                 model_path: str | None = None, device=None):
        from .pretrained import flagship_detector, resolve_model_path
        from .runtime.detector import FaceDetector

        self.scoreThreshold = scoreThreshold
        self.iouThreshold = iouThreshold
        kw = dict(score_threshold=scoreThreshold, iou_threshold=iouThreshold,
                  device=device)
        model_path = resolve_model_path(model_path)
        if model_path is None:
            self._detector = flagship_detector(**kw)
        else:
            loader = (FaceDetector.from_native if os.path.isdir(model_path)
                      else FaceDetector.from_h5)
            self._detector = loader(model_path, **kw)
        self._fps = FpsCounter()
        self.fps = 0
        # the reference __init__ sets these through initializeModel():
        # drop-in call sites read detector.anchors / inputWidth /
        # sigmoidScoreThreshold
        self.sigmoidScoreThreshold = float(
            np.log(scoreThreshold / (1.0 - scoreThreshold))
            if 0.0 < scoreThreshold < 1.0
            else (-np.inf if scoreThreshold <= 0.0 else np.inf))
        self.getModelInputDetails()
        self.generateAnchors()

    def detectFaces(self, image) -> Results:
        results = self._detector.detect_single(image)
        self.fps = int(self._fps.tick())
        return results

    def drawDetections(self, img, results: Results):
        from .runtime.viz import draw_detections

        return draw_detections(img, results, fps=self.fps)

    def updateFps(self) -> int:
        """The reference method: detectFaces already ticks the counter per
        call, so a loop that also calls updateFps() counts the extra tick,
        as the reference does."""
        self.fps = int(self._fps.tick())
        return self.fps

    def getModelInputDetails(self):
        """The reference method: the expected input geometry, on the
        instance."""
        self.inputHeight = self._detector.input_size
        self.inputWidth = self._detector.input_size
        self.channels = 3

    def generateAnchors(self):
        """The reference method: the anchor table under the reference's
        attribute name (the detector holds the same table)."""
        self.anchors = [Anchor(x, y, h, w) for x, y, w, h in
                        self._detector.anchors.cpu().numpy()]
        return self.anchors

    def draw_axis(self, img, yaw, pitch, roll, tdx, tdy, size=50,
                  thickness=2):
        """The reference's flat 2D-arrow overlay: yaw arrow red, pitch
        green, roll blue."""
        cv2 = _require_cv2()
        cx, cy = int(tdx), int(tdy)
        yr, pr, rr = (-math.radians(yaw), math.radians(pitch),
                      math.radians(roll))
        cv2.line(img, (cx, cy),
                 (int(cx + size * math.sin(yr)),
                  int(cy - size * math.cos(yr))), (0, 0, 255), thickness)
        cv2.line(img, (cx, cy),
                 (cx, int(cy - size * math.sin(pr))), (0, 255, 0), thickness)
        cv2.line(img, (cx, cy),
                 (int(cx + size * math.cos(rr)),
                  int(cy + size * math.sin(rr))), (255, 0, 0), thickness)
        return img


def EulerToMatrix(roll, yaw, pitch):  # noqa: N802 — the reference's name
    """The reference's rotation matrix R = Rx @ Ry @ Rz from degrees
    (utils.geometry.euler_to_matrix, same argument order)."""
    from .utils.geometry import euler_to_matrix

    return euler_to_matrix(roll, yaw, pitch)


def drawAxis_simo(img, headpose, tdx, tdy, size=100):  # noqa: N802
    """The reference's 3D axis overlay from headpose = (roll, yaw, pitch),
    through utils.geometry.pose_axes."""
    from .utils.geometry import pose_axes

    cv2 = _require_cv2()
    roll, yaw, pitch = headpose[0], headpose[1], headpose[2]
    axes = pose_axes(yaw, pitch, roll, tdx, tdy, size)
    o = (int(tdx), int(tdy))
    cv2.line(img, o, (int(axes["x"][0]), int(axes["x"][1])), (0, 255, 0), 3)
    cv2.line(img, o, (int(axes["y"][0]), int(axes["y"][1])), (0, 0, 255), 3)
    cv2.line(img, o, (int(axes["z"][0]), int(axes["z"][1])), (255, 0, 0), 2)
    return img


def _require_cv2():
    from .runtime.viz import _require_cv2 as req

    return req()
