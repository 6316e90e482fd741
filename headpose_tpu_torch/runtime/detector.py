"""FaceDetector: the end-to-end detection + pose runtime, PyTorch edition.

Port of headpose_tpu/runtime/detector.py.  A batch of frames goes through

  preprocess (bicubic resize + normalize, two fp32 matmuls)
  → backbone + SSD heads (cuDNN convs) → pose heads over every map cell
  → postprocess: on a CUDA device the hand-written kernel
    (ops.kernels.postprocess), on the CPU its plain twin
  → BatchResults slabs, `trim()` to ragged per-image Results.

Use:
    det = flagship_detector()           # on the card; device="cpu" to ask
    batch = det.detect(images)          # (B, H, W, 3) BGR uint8 → BatchResults
    results = batch.trim()              # ragged per-image, reference contract
    res = det.detect_single(image)      # one image → Results
    batch = det.detect_fused(images)    # the network through the fused
                                        # backbone and pose-head kernels
    fast = flagship_detector(precision="fast")   # split-bf16 backbone
                                        # segments; detect runs the kernels
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from ..models.anchors import BACK_CONFIG, FRONT_CONFIG, generate_anchors
from ..models.unified import UnifiedPoseModel, UnifiedPoseNet
from ..ops.detection import MAX_FACES
from ..ops.image import preprocess
from ..ops.kernels.postprocess import postprocess_slab
from ..tools.convert import load_native, params_from_jax
from ..utils.device import resolve_device
from .fused import PRECISIONS, fused_network
from .results import BatchResults, Results

__all__ = ["FaceDetector"]


class FaceDetector:
    """Batched BlazeFace + head-pose detector.

    `model` is a `UnifiedPoseModel` spec with both pose heads and `params`
    its parameters in JAX layout (nested dicts/lists of arrays, as
    `tools.convert.load_npz` returns them).

    `device=None` means the CUDA device, and raises when there is none; pass
    `device="cpu"` for the plain PyTorch path.  On a CUDA device the
    constructor turns TF32 off for the whole process
    (`torch.backends.cuda.matmul.allow_tf32 = False` and
    `torch.backends.cudnn.allow_tf32 = False`): cuDNN runs fp32 convs in
    TF32 by default, which breaks the 0.1-degree pose parity budget.

    `score_threshold`, `iou_threshold` and `max_faces` are read on every
    call and may be changed between calls.  `channel_order` is fixed at
    construction; the input size is the backbone's, and it chooses the
    anchor table (128 front, 256 back).  Only head_eval='map' (pose heads
    over every map cell) is served.

    `precision` is one of `runtime.fused.PRECISIONS`:
      'highest'  exact fp32: `detect` runs the cuDNN network, `detect_fused`
                 the fp32 fused kernels.
      'fast'     the JAX detector's certified fast mode at its precision
                 (3-pass split-bf16, the TPU's 'high'): `detect` and
                 `detect_fused` both run `fused_network(..., "fast")`, whose
                 backbone segments take a split-bf16 pointwise
                 (`ops.kernels.backbone2.apply_fused`); everything else is
                 fp32.  On the CPU it runs the plain split-bf16 version, so
                 the CPU shows the mode's own rounding.
    'turbo' and 'max' (single-pass bf16 islands, not certified on the
    stress corpus) are not served and raise.
    """

    def __init__(self, model: UnifiedPoseModel, params: Any, *,
                 score_threshold: float = 0.4, iou_threshold: float = 0.3,
                 max_faces: int = MAX_FACES, channel_order: str = "bgr",
                 precision: str = "highest", head_eval: str = "map",
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if precision not in PRECISIONS:
            raise ValueError(f"precision={precision!r} is not served by the "
                             f"port; the served modes are {PRECISIONS}")
        if head_eval != "map":
            raise ValueError(f"head_eval={head_eval!r} is not served by the "
                             "port; only 'map' is")
        if channel_order not in ("bgr", "rgb"):
            raise ValueError(f"channel_order must be 'bgr' or 'rgb', "
                             f"got {channel_order!r}")
        if model.head88 is None or model.head96 is None:
            raise ValueError("FaceDetector needs a UnifiedPoseModel with both "
                             "pose heads")
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.net = UnifiedPoseNet(model, device=self.device).eval()
        self.net.load_state_dict(params_from_jax(model, params))
        self.score_threshold = float(score_threshold)
        self.iou_threshold = float(iou_threshold)
        self.max_faces = int(max_faces)
        self.input_size = int(model.backbone.input_size)
        self.channel_order = channel_order
        self.precision = precision
        config = BACK_CONFIG if self.input_size == 256 else FRONT_CONFIG
        self.anchors = torch.tensor(
            generate_anchors(config).astype(np.float32), device=self.device)

    @classmethod
    def from_native(cls, path: str, **kwargs) -> "FaceDetector":
        """Load a native model directory of the port (spec.json +
        params.npz, tools.convert.save_native)."""
        model, params = load_native(path)
        return cls(model, params, **kwargs)

    def detect(self, images) -> BatchResults:
        """images: (B, H, W, 3) or (H, W, 3), uint8/float 0-255, BGR by
        default; a numpy array or a tensor.  Returns the slabs on the
        detector's device without synchronising.  At precision 'fast' it is
        `detect_fused`."""
        if self.precision == "fast":
            return self.detect_fused(images)
        return self._detect(images, self.net)

    def detect_fused(self, images) -> BatchResults:
        """`detect` with the network computed through the fused backbone
        and pose-head kernels (`runtime.fused.fused_network`, at the
        detector's precision) instead of the cuDNN modules; the same
        preprocess and postprocess."""
        return self._detect(images, functools.partial(
            fused_network, self.net, precision=self.precision))

    def _detect(self, images, network) -> BatchResults:
        if isinstance(images, torch.Tensor):
            x = images
        else:
            arr = np.asarray(images)
            # torch takes neither read-only buffers (np.broadcast_to) nor
            # negative strides (a channel flip img[..., ::-1])
            if not (arr.flags.writeable and arr.flags.c_contiguous):
                arr = np.array(arr, order="C")
            x = torch.from_numpy(arr)
        if x.ndim == 3:
            x = x[None]
        if x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"images must be (B, H, W, 3) or (H, W, 3), "
                             f"got {tuple(x.shape)}")
        with torch.inference_mode():
            x = preprocess(x.to(self.device), self.input_size,
                           self.channel_order)
            out = network(x)
            slab = postprocess_slab(
                out["scores"], out["loc"], out["pose_front"], out["pose_back"],
                self.anchors, score_threshold=self.score_threshold,
                iou_threshold=self.iou_threshold,
                input_size=self.input_size, max_faces=self.max_faces)
        return BatchResults(slab)

    def detect_single(self, image) -> Results:
        return self.detect(image).trim()[0]

    def warmup(self, shape: tuple[int, ...] = (1, 480, 480, 3)) -> None:
        """Run one batch of the given shape (cuDNN picks its algorithms and
        the kernel is built on the first call)."""
        self.detect(np.zeros(shape, np.uint8))
