"""Unified pose-detection model: BlazeFace backbone + grafted pose heads.

Port of headpose_tpu/models/unified.py.  Output contract:
  scores     (B, 896)        — cls_front (512) ++ cls_back (384) logits
  loc        (B, 896, 16)    — raw [sx, sy, w, h, 6x(kx, ky)] per anchor
  pose_front (B, 16, 16, 3)  — yaw/pitch/roll map over the 16x16 grid
  pose_back  (B, 8, 8, 3)    — yaw/pitch/roll map over the 8x8 grid
plus reference_outputs() reshaping to the 6-tensor signature of the
reference's unified H5.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..utils.device import resolve_device
from .blazeface import BLAZEFACE_FRONT, BlazeFace, BlazeFaceNet
from .heads import head_net

__all__ = ["UnifiedPoseModel", "UnifiedPoseNet", "join_models"]


@dataclasses.dataclass(frozen=True)
class UnifiedPoseModel:
    """BlazeFace + two pose-regression heads (the spec)."""

    backbone: BlazeFace = BLAZEFACE_FRONT
    head88: Any = None  # pose head consuming feat88 (16x16x88), any family
    head96: Any = None  # pose head consuming feat96 (8x8x96)


class UnifiedPoseNet(nn.Module):
    """The network of one `UnifiedPoseModel` spec, one forward."""

    def __init__(self, spec: UnifiedPoseModel, *,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.backbone = BlazeFaceNet(spec.backbone, device=device)
        self.head88 = (head_net(spec.head88, device=device)
                       if spec.head88 is not None else None)
        self.head96 = (head_net(spec.head96, device=device)
                       if spec.head96 is not None else None)

    def forward(self, x: torch.Tensor, heads: bool = True, *,
                dense: bool = False,
                fast_blocks: tuple[int, ...] | None = None
                ) -> dict[str, torch.Tensor]:
        """`heads=False` leaves out the pose maps: the detector's survivors
        profile runs the heads after NMS on the survivors' vectors.  `dense`
        and `fast_blocks` go to the backbone (`BlazeFaceNet.forward`); the
        pose heads run in fp32 in every case."""
        out = self.backbone(x, dense=dense, fast_blocks=fast_blocks)
        if heads and self.head88 is not None:
            out["pose_front"] = self.head88(out["feat88"])
        if heads and self.head96 is not None:
            out["pose_back"] = self.head96(out["feat96"])
        return out

    def reference_outputs(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The 6-output signature of the reference unified H5
        (cls_front, cls_back, loc_front, loc_back, pose_front, pose_back)."""
        out = self(x)
        B = x.shape[0]
        scores, loc = out["scores"], out["loc"]
        return (scores[:, :512].reshape(B, 512, 1),
                scores[:, 512:].reshape(B, 384, 1),
                loc[:, :512].reshape(B, 512, 16),
                loc[:, 512:].reshape(B, 384, 16),
                out["pose_front"], out["pose_back"])


def join_models(backbone_spec: BlazeFace, backbone_params: Any,
                head88: Any, head88_params: Any,
                head96: Any, head96_params: Any) -> tuple[UnifiedPoseModel,
                                                          Any]:
    """A detector composed with two trained pose heads (the reference's
    JoinModels.join_models): (UnifiedPoseModel spec, params in JAX layout),
    ready for `FaceDetector` or `tools.export.save_model`."""
    model = UnifiedPoseModel(backbone=backbone_spec, head88=head88,
                             head96=head96)
    return model, {"backbone": backbone_params, "head88": head88_params,
                   "head96": head96_params}
