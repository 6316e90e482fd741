"""Edge pipeline: TFLite artifact + native C++ postprocess, on the host.

Port of headpose_tpu/runtime/edge.py.  tools/tflite.py ships the model half
of an edge deployment; this module ships the other half — the role the
reference's host-side numpy/tf postprocess plays next to its Keras model
(blazeFaceDetectorH5.py:284-357):

  * `NativePostprocess` — ctypes bindings for native/postprocess.cpp
    (score filter + anchor decode + greedy NMS + pose lookup), the function
    of ops/detection.py::postprocess (the plain chain) and of kernel #1:
    boxes, keypoints and poses bit for bit, scores within a sigmoid ulp
    (tests/test_torch_edge.py; on the card, chip_smoke.py's edge phase).
  * `EdgeDetector` — the combined pipeline: preprocess (numpy, the exact
    reference arithmetic) → TFLite invoke → native postprocess → `Results`.
    The whole chain — `PoseServer(EdgeDetector(...))` serving included —
    runs with no torch numerics in the loop (tensorflow only for its TFLite
    interpreter, loaded when a detector is built).

    from headpose_tpu_torch.runtime.edge import EdgeDetector
    det = EdgeDetector("flagship.tflite")       # tools/tflite.py artifact
    results = det.detect_single(frame)          # (S, S, 3) uint8 BGR

The C++ library builds on first use (g++ -O3 -ffp-contract=off, no
dependencies) into build/headpose_tpu_torch/ (utils/nativelib.py).
Camera-sized frames are accepted directly: preprocessing applies the
TF-exact bicubic resize (ops/bicubic.py, the same interpolation matrices as
the torch path, as numpy/BLAS matmuls), so the edge pipeline owns the
reference's whole detectFaces contract (blazeFaceDetectorH5.py:247-269)
including the resize.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..ops.bicubic import resize_bicubic_np
from ..utils.nativelib import NativeLibrary
from .results import BatchResults, Results

__all__ = ["NativePostprocess", "EdgeDetector", "native_available"]

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _configure(lib: ctypes.CDLL) -> None:
    lib.hp_postprocess_batch.restype = ctypes.c_int
    lib.hp_postprocess_batch.argtypes = [
        _F32, _F32, _F32, _F32, _F32,                    # model outputs
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # B, A, A_front
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # grids
        # score threshold travels as DOUBLE: the logit cutoff must be
        # computed from the unrounded value exactly like
        # score_threshold_to_logit (a c_float-narrowed t shifts the f32
        # cutoff by one ulp for ~61% of thresholds — measured); the iou
        # threshold is compared against f32 IoUs with f32 semantics in
        # both backends, so c_float is the parity-correct width there
        ctypes.c_double, ctypes.c_float,                 # thresholds
        ctypes.c_int, ctypes.c_int,                      # size, max_faces
        _F32, _F32, _F32, _F32, _I32]                    # outputs


# -ffp-contract=off: FMA contraction would change the decode's f32
# roundings against the plain chain's matmul — the contract is bit-exactness
_library = NativeLibrary("postprocess",
                         os.path.join(_NATIVE_DIR, "postprocess.cpp"),
                         flags=("-ffp-contract=off",), configure=_configure)


def native_available() -> bool:
    return _library.available()


class NativePostprocess:
    """Batched detection postprocess via the C++ library.

    `anchors` is the (A, 4) normalized table (models.anchors layout); the
    front-grid anchor count is derived from the pose maps at call time
    (2/cell on the front grid, 6/cell on the back —
    blazeFaceDetectorH5.py:342-353; both shipped topologies use 16x16/8x8
    grids).  Call with raw model outputs, get per-image ragged `Results`
    (the reference contract) back.
    """

    def __init__(self, anchors: np.ndarray, *,
                 input_size: int = 128, score_threshold: float = 0.4,
                 iou_threshold: float = 0.3, max_faces: int = 100):
        lib = _library.load()
        if lib is None:
            raise RuntimeError(
                "native postprocess unavailable: g++ could not build "
                "native/postprocess.cpp on this host")
        self._lib = lib
        anchors = np.asarray(anchors)
        if anchors.ndim != 2 or anchors.shape[1] != 4:
            raise ValueError(f"anchors must be (A, 4), got {anchors.shape}")
        self.anchors = np.ascontiguousarray(anchors, np.float32)
        self.input_size = int(input_size)
        self.score_threshold = float(score_threshold)
        self.iou_threshold = float(iou_threshold)
        self.max_faces = int(max_faces)

    def __call__(self, logits: np.ndarray, loc: np.ndarray,
                 pose_front: np.ndarray, pose_back: np.ndarray
                 ) -> list[Results]:
        logits = np.ascontiguousarray(logits, np.float32)
        loc = np.ascontiguousarray(loc, np.float32)
        pose_front = np.ascontiguousarray(pose_front, np.float32)
        pose_back = np.ascontiguousarray(pose_back, np.float32)
        if logits.ndim != 2 or loc.shape != (*logits.shape, 16):
            raise ValueError(f"want logits (B, A) and loc (B, A, 16), got "
                             f"{logits.shape} / {loc.shape}")
        b, a = logits.shape
        # every dimension crossing the ctypes boundary is validated here —
        # the C++ side trusts them (a stale count would be an OOB read)
        if a != self.anchors.shape[0]:
            raise ValueError(f"logits carry {a} anchors but the table has "
                             f"{self.anchors.shape[0]}")
        for name, m in (("pose_front", pose_front), ("pose_back", pose_back)):
            if m.ndim != 4 or m.shape[0] != b or m.shape[3] != 3:
                raise ValueError(f"{name} must be ({b}, H, W, 3), "
                                 f"got {m.shape}")
        hf, wf = pose_front.shape[1:3]
        hb, wb = pose_back.shape[1:3]
        num_front = 2 * hf * wf
        f = self.max_faces
        boxes = np.empty((b, f, 4), np.float32)
        keypoints = np.empty((b, f, 6, 2), np.float32)
        scores = np.empty((b, f), np.float32)
        poses = np.empty((b, f, 3), np.float32)
        counts = np.empty((b,), np.int32)
        rc = self._lib.hp_postprocess_batch(
            logits, loc, pose_front, pose_back, self.anchors, b, a,
            num_front, hf, wf, hb, wb,
            ctypes.c_double(self.score_threshold),
            ctypes.c_float(self.iou_threshold), self.input_size, f,
            boxes, keypoints, scores, poses, counts)
        if rc != 0:
            raise ValueError(
                f"native postprocess rejected the layout: A={a}, "
                f"num_front={num_front}, grids {hf}x{wf}/{hb}x{wb} "
                "(front must be 2/cell, back 6/cell)")
        return [Results(boxes=boxes[i, :c], keypoints=keypoints[i, :c],
                        scores=scores[i, :c], poses=poses[i, :c])
                for i, c in enumerate(counts)]


class EdgeDetector:
    """TFLite artifact + native postprocess: the full detection pipeline on
    a host.  Mirrors `FaceDetector.detect_single`'s contract (ragged
    `Results`)."""

    def __init__(self, tflite_path: str, *, score_threshold: float = 0.4,
                 iou_threshold: float = 0.3, max_faces: int = 100,
                 input_size: int | None = None, channel_order: str = "bgr"):
        from ..models.anchors import (BACK_CONFIG, FRONT_CONFIG,
                                      generate_anchors)
        from ..tools.tflite import TFLiteModel

        if channel_order not in ("bgr", "rgb"):
            raise ValueError(f"channel_order must be 'bgr' or 'rgb', "
                             f"got {channel_order!r}")
        self.model = TFLiteModel(tflite_path)
        if self.model.input_names != ["image"]:
            raise ValueError(
                f"{tflite_path} is not a unified-model artifact "
                f"(inputs {self.model.input_names}; export with "
                "tools.tflite.export_unified_tflite)")
        baked = self.model.input_shape("image")[1]
        if input_size is None:
            input_size = baked  # the artifact knows its own topology
        elif input_size != baked:
            raise ValueError(f"input_size {input_size} does not match the "
                             f"artifact's baked size {baked}")
        if input_size not in (128, 256):
            raise ValueError(
                f"input_size must be 128 (front) or 256 (back) — the two "
                f"anchor-table topologies — got {input_size}")
        cfg = FRONT_CONFIG if input_size == 128 else BACK_CONFIG
        anchors = np.asarray(generate_anchors(cfg), np.float32)
        self.input_size = input_size
        self.channel_order = channel_order
        self.postprocess = NativePostprocess(
            anchors, input_size=input_size,
            score_threshold=score_threshold, iou_threshold=iou_threshold,
            max_faces=max_faces)

    def _preprocess(self, frame: np.ndarray) -> np.ndarray:
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(
                f"EdgeDetector takes (H, W, 3) frames, got {frame.shape}")
        s = self.input_size
        x = frame.astype(np.float32)
        if self.channel_order == "bgr":
            x = x[..., ::-1]
        # the exact reference preprocess arithmetic and ORDER
        # (blazeFaceDetectorH5.py:247-269, same as ops/image.py preprocess):
        # scale to [0,1], TF-exact bicubic resize (numpy twin of the torch
        # path — identity at the native size), then map to [-1,1].
        # Camera-sized frames are a first-class input here, like the
        # detector's: no upstream cv2 resize with a different kernel.
        x = x / np.float32(255.0)
        x = resize_bicubic_np(x, (s, s))
        x = (x - np.float32(0.5)) / np.float32(0.5)
        return np.ascontiguousarray(x[None])

    @property
    def frame_shape(self) -> tuple[int, int, int]:
        """The artifact's baked frame shape — PoseServer reads this to pin
        its accepted shape up front, like AOT artifacts."""
        return (self.input_size, self.input_size, 3)

    def detect_single(self, frame: np.ndarray) -> Results:
        out = self.model(image=self._preprocess(frame))
        logits = np.concatenate([out["cls_front"][:, :, 0],
                                 out["cls_back"][:, :, 0]], axis=1)
        loc = np.concatenate([out["loc_front"], out["loc_back"]], axis=1)
        return self.postprocess(logits, loc, out["pose_front"],
                                out["pose_back"])[0]

    def detect(self, frames: np.ndarray) -> BatchResults:
        """Batched detect contract (`(B, S, S, 3) -> BatchResults`, on the
        CPU), so the whole serving stack composes on a CPU-only host:
        `PoseServer(EdgeDetector("pose.tflite"))` is a detection service
        from the artifact, stdlib HTTP, and the C++ postprocess.

        Rows run as sequential batch-1 invokes: TFLite graphs are
        static-shape and the unified graph's baked SSD reshapes refuse
        `resize_tensor_input` on the batch axis, so one artifact serves one
        width.
        """
        frames = np.asarray(frames)
        if frames.ndim == 3:
            frames = frames[None]
        return BatchResults.from_ragged(
            [self.detect_single(f) for f in frames],
            max_faces=self.postprocess.max_faces)
