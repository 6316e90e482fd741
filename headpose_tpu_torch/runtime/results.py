"""Detection results containers.

`BatchResults` holds the one fixed-size (B, F, 21) slab the detector's
postprocess produces, on the detector's device; its fields are views of it.
`trim()` turns it into the reference's ragged per-image `Results` (numpy)
with ONE synchronising device→host copy of the slab.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.detection import C_LOGIT, C_POSE, C_VALID, KEYPOINTS

__all__ = ["Results", "BatchResults"]


@dataclasses.dataclass(eq=False)  # eq=True's tuple-compare would call
class Results:                    # bool() on elementwise ndarray ==
    """Per-image detections, ragged (N = number of faces found).

    boxes      (N, 4)  [x1, y1, x2, y2] normalized
    keypoints  (N, 6, 2) normalized
    scores     (N,)
    poses      (N, 3)  yaw/pitch/roll in degrees
    """

    boxes: np.ndarray
    keypoints: np.ndarray
    scores: np.ndarray
    poses: np.ndarray

    def __len__(self) -> int:
        return int(self.scores.shape[0])


@dataclasses.dataclass(eq=False)
class BatchResults:
    """Batched fixed-size detections on the device, padded to max_faces:
    the finished postprocess slab (B, F, 21), [16 decoded | 3 pose | score |
    valid] (ops.detection), with its fields as views and valid (B, F) bool
    marking real rows."""

    slab: torch.Tensor

    @property
    def boxes(self) -> torch.Tensor:      # (B, F, 4)
        return self.slab[..., :4]

    @property
    def keypoints(self) -> torch.Tensor:  # (B, F, 6, 2)
        B, F = self.slab.shape[:2]
        return self.slab[..., 4:C_POSE].reshape(B, F, KEYPOINTS, 2)

    @property
    def scores(self) -> torch.Tensor:     # (B, F)
        return self.slab[..., C_LOGIT]

    @property
    def poses(self) -> torch.Tensor:      # (B, F, 3)
        return self.slab[..., C_POSE:C_LOGIT]

    @property
    def valid(self) -> torch.Tensor:      # (B, F) bool
        return self.slab[..., C_VALID] > 0.5

    @property
    def counts(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)

    def trim(self) -> list[Results]:
        """Host-side conversion to the reference's ragged per-image contract:
        the slab is copied to the host once and split there."""
        host = self.slab.cpu().numpy()
        B, F = host.shape[:2]
        keypoints = host[..., 4:C_POSE].reshape(B, F, KEYPOINTS, 2)
        valid = host[..., C_VALID] > 0.5
        return [Results(boxes=host[b, valid[b], :4],
                        keypoints=keypoints[b][valid[b]],
                        scores=host[b, valid[b], C_LOGIT],
                        poses=host[b, valid[b], C_POSE:C_LOGIT])
                for b in range(B)]
