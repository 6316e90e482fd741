"""Feature-map dataset extraction, PyTorch edition: images → per-face
feature vectors.

Port of headpose_tpu/tools/extract_features.py.  The detector runs over the
images, and the backbone's feature vector at the best face's grid cell (the
cell the pose lookup reads) becomes a training row for each channel width:

    extract_dataset(images, poses, out_96="BIWI_custom_96.npz")

Per batch: preprocess → the network at "highest" (the cuDNN modules, fp32,
TF32 off, as `FaceDetector.detect` runs it) → the best face → the cell
gather from the 16x16x88 and 8x8x96 maps.  The best face is what JAX's
`nms_static(max_out=1)` picks: the argmax of sigmoid(logit) over the
anchors above the threshold, the lowest index on a tie.  The argmax is over
the probabilities, not the logits: fp32 sigmoid saturates to 1.0 above
about 17, so distinct logits tie there.  With no face above the threshold,
anchor 0 stands in (`found` False), as in JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.blazeface import fp32_exact
from ..models.unified import UnifiedPoseNet
from ..ops.detection import _f32, score_threshold_to_logit
from ..ops.image import preprocess
from ..runtime.detector import host_tensor
from ..tools.convert import params_from_jax
from ..utils.device import resolve_device

__all__ = ["FeatureExtractor", "ExtractionResult", "extract_dataset",
           "best_face"]

NUM_ANCHORS_FRONT = 512


@dataclasses.dataclass
class ExtractionResult:
    features88: np.ndarray  # (N, 88) feature vector at the face cell (16x16 map)
    features96: np.ndarray  # (N, 96) feature vector at the face cell (8x8 map)
    scores: np.ndarray      # (N,) detection confidence
    found: np.ndarray       # (N,) bool: a face was detected in this image


def best_face(logits: torch.Tensor, logit_threshold: float):
    """(B, 896) logits → (index (B,), probability (B,), found (B,)) of each
    image's best anchor: the argmax of sigmoid(logit) over the anchors
    above the threshold (first index on a tie); anchor 0 when none is."""
    probs = torch.sigmoid(logits)
    valid = logits > logit_threshold
    best = torch.argmax(torch.where(valid, probs, -torch.inf), dim=1)
    best = torch.where(valid.any(dim=1), best, 0)
    return best, probs.gather(1, best[:, None])[:, 0], valid.any(dim=1)


def gather_cells(best: torch.Tensor, feat88: torch.Tensor,
                 feat96: torch.Tensor):
    """The feature vectors at each best anchor's cell, as JAX's
    `anchor_cells` maps an anchor: a front anchor (2 per cell of the 16x16
    map) reads its 16x16 cell and the 8x8 cell above it (//2); a back
    anchor (6 per cell of the 8x8 map) its 8x8 cell and the 16x16 cell at
    that cell's origin corner (x2)."""
    is_front = best < NUM_ANCHORS_FRONT
    cell_f = best // 2
    rf, cf = (cell_f // 16).clamp(0, 15), (cell_f % 16).clamp(0, 15)
    cell_b = (best - NUM_ANCHORS_FRONT).clamp(min=0) // 6
    rb, cb = (cell_b // 8).clamp(0, 7), (cell_b % 8).clamp(0, 7)
    b = torch.arange(best.shape[0], device=best.device)
    f88 = torch.where(is_front[:, None], feat88[b, rf, cf],
                      feat88[b, rb * 2, cb * 2])
    f96 = torch.where(is_front[:, None], feat96[b, rf // 2, cf // 2],
                      feat96[b, rb, cb])
    return f88, f96


class FeatureExtractor:
    """Per-face backbone feature vectors from images, with a unified
    model's backbone (the flagship's by default).  `device=None` means the
    card and raises without one; pass `device="cpu"` for the CPU.

    JAX's extractor also takes `iou_threshold` and `precision`: the first
    pick of NMS does not depend on the IoU threshold, and the port
    extracts at "highest" only (the fp32 network)."""

    def __init__(self, model=None, params=None,
                 score_threshold: float = 0.4, channel_order: str = "bgr",
                 device: str | torch.device | None = None):
        if channel_order not in ("bgr", "rgb"):
            raise ValueError(f"channel_order must be 'bgr' or 'rgb', "
                             f"got {channel_order!r}")
        if model is None:
            from ..pretrained import load_flagship

            model, params = load_flagship()
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.net = UnifiedPoseNet(model, device=self.device).eval()
        self.net.load_state_dict(params_from_jax(model, params))
        self.score_threshold = float(score_threshold)
        self.channel_order = channel_order

    def extract(self, images) -> ExtractionResult:
        """images (B, H, W, 3) or (H, W, 3), uint8/float 0-255 →
        per-image best-face features."""
        x = host_tensor(images)
        if x.ndim == 3:
            x = x[None]
        with fp32_exact(), torch.inference_mode():
            x = preprocess(x.to(self.device),
                           self.net.spec.backbone.input_size,
                           self.channel_order)
            out = self.net(x, heads=False)
            best, score, found = best_face(
                out["scores"],
                _f32(score_threshold_to_logit(self.score_threshold)))
            f88, f96 = gather_cells(best, out["feat88"], out["feat96"])
            host = [t.cpu().numpy() for t in (f88, f96, score, found)]
        return ExtractionResult(*host)


def extract_dataset(images, poses, out_88: str | None = None,
                    out_96: str | None = None, batch_size: int = 64,
                    extractor: FeatureExtractor | None = None,
                    device: str | torch.device | None = None) -> np.ndarray:
    """Training datasets from labeled images.

    images: (N, H, W, 3); poses: (N, 3) [yaw, pitch, roll] degrees.  Writes
    the standard npz schema (features + poses) for each channel width,
    keeping the images where a face was found; returns that mask.  Without
    an extractor it builds the flagship's on `device`."""
    if extractor is None:
        extractor = FeatureExtractor(device=device)
    parts = [extractor.extract(np.asarray(images[s:s + batch_size]))
             for s in range(0, len(images), batch_size)]
    f88 = np.concatenate([p.features88 for p in parts])
    f96 = np.concatenate([p.features96 for p in parts])
    found = np.concatenate([p.found for p in parts])
    poses = np.asarray(poses, np.float32)
    if out_88:
        np.savez_compressed(out_88, features=f88[found].astype(np.float32),
                            poses=poses[found])
    if out_96:
        np.savez_compressed(out_96, features=f96[found].astype(np.float32),
                            poses=poses[found])
    return found
