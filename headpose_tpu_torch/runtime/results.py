"""Detection results containers.

`BatchResults` holds the one fixed-size (B, F, 21) slab the detector's
postprocess produces, on the detector's device; its fields are views of it.
`trim()` turns it into the reference's ragged per-image `Results` (numpy)
with ONE device→host copy of the slab (the span `results.copy`) and one
batch-wide split (`results.split`); `from_ragged` is its inverse, on the
CPU.  The copy is either synchronous, in `trim()`, or started earlier by
`start_download(stream)` into pinned memory on a side stream, so that
`trim()` only waits for it; `TOTALS.counts` counts the trims of each kind
(`trim.downloaded`, `trim.copied`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.detection import (C_LOGIT, C_POSE, C_VALID, KEYPOINTS,
                             MAX_FACES, SLAB)
from ..utils.profiling import TOTALS, span

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
    # (host tensor, ready event or None) once start_download() has run
    _download: tuple | None = dataclasses.field(default=None, init=False,
                                                repr=False)

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

    @classmethod
    def from_ragged(cls, results: list, max_faces: int = MAX_FACES
                    ) -> "BatchResults":
        """Inverse of trim(): ragged per-image Results -> one (B, F, 21)
        slab on the CPU.

        Lets anything that produced host-side ragged results (a remote
        PoseClient, a deserialized log) re-enter the slab pipeline
        (smoothing, tracking).  max_faces defaults to the reference's
        MAX_FACE_NUM; images with more detections than max_faces keep their
        top rows (detections are score-descending by construction).  Rows
        past an image's count are zero, as the postprocess leaves them."""
        B, F = len(results), int(max_faces)
        slab = np.zeros((B, F, SLAB), np.float32)
        for b, r in enumerate(results):
            n = min(len(r), F)
            slab[b, :n, :4] = r.boxes[:n]
            slab[b, :n, 4:C_POSE] = np.reshape(r.keypoints[:n],
                                               (n, 2 * KEYPOINTS))
            slab[b, :n, C_POSE:C_LOGIT] = r.poses[:n]
            slab[b, :n, C_LOGIT] = r.scores[:n]
            slab[b, :n, C_VALID] = 1.0
        return cls(torch.from_numpy(slab))

    def start_download(self, stream=None) -> None:
        """Start the slab's copy to the host now, for `trim()` to use.

        A CUDA slab is copied into pinned memory from PyTorch's caching host
        allocator with `non_blocking=True` on `stream` (a CUDA stream of the
        slab's device), after everything already queued on the current
        stream, so after the kernels that wrote it; the copy's `ready` event
        is recorded there.  The slab is recorded on `stream`, so that a
        batch dropped untrimmed does not hand its memory to later work while
        the copy reads it.  A CPU slab is copied at once, with no event and
        no stream."""
        slab = self.slab
        if slab.device.type != "cuda":
            self._download = (slab.to("cpu", copy=True), None)
            return
        host = torch.empty(slab.shape, dtype=slab.dtype, pin_memory=True)
        stream.wait_stream(torch.cuda.current_stream(slab.device))
        slab.record_stream(stream)
        with torch.cuda.stream(stream):
            host.copy_(slab, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        self._download = (host, ready)

    def trim(self) -> list[Results]:
        """Host-side conversion to the reference's ragged per-image contract:
        the slab is copied to the host once (or its started download waited
        for) and split there."""
        with span("results.trim"):
            with span("results.copy"):
                if self._download is None:
                    TOTALS.count("trim.copied")
                    host = self.slab.cpu().numpy()
                else:
                    TOTALS.count("trim.downloaded")
                    buffer, ready = self._download
                    if ready is not None:
                        ready.synchronize()
                    host = buffer.numpy()
            with span("results.split"):
                # One row-major gather of the valid rows for the whole batch
                # (any valid pattern, not only a prefix), each field copied
                # once into its own C-contiguous array, then a slice per
                # image: no image's arrays overlap another's or keep the slab
                # or the download's pinned buffer, which the caching host
                # allocator hands to a later batch.
                valid = host[..., C_VALID] > 0.5
                rows = host[valid]
                n = len(rows)
                boxes = rows[:, :4].copy()
                keypoints = rows[:, 4:C_POSE].reshape(n, KEYPOINTS, 2).copy()
                scores = rows[:, C_LOGIT].copy()
                poses = rows[:, C_POSE:C_LOGIT].copy()
                ends = np.count_nonzero(valid, axis=1).cumsum().tolist()
                return [Results(boxes=boxes[s:e], keypoints=keypoints[s:e],
                                scores=scores[s:e], poses=poses[s:e])
                        for s, e in zip([0] + ends, ends)]
