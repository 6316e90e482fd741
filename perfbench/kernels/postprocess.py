"""Kernel #1, the postprocess (csrc/postprocess.cu: `cta_kernel`, a CTA an
image), from the raw network outputs to the finished (B, F, 21) slab.

Bytes: its inputs read once (logits (B, A), loc (B, A, 16), both pose maps
(B, 320, 3), the anchors (A, 4)) and the slab written once.  Operations,
which depend on the data: sanitize and threshold (3), the box decode (12)
and area (5) of every anchor; per survivor its slot (16 decodes of 2, a
sigmoid of 3) and a trip of NMS: an argmax and an IoU test against each
anchor (13 at most)."""
from __future__ import annotations

from . import peaks

ANCHORS = 896
POSE_CELLS = 16 * 16 + 8 * 8
SLAB = 21


def matches(name: str) -> bool:
    return "cta_kernel" in name


def work(B: int, max_faces: int, survivors: float) -> tuple[float, int]:
    """(fp32 operations, bytes) for B frames with `survivors` faces kept
    in all."""
    nbytes = (4 * B * ANCHORS * (1 + 16) + 4 * B * POSE_CELLS * 3
              + 4 * ANCHORS * 4 + 4 * B * max_faces * SLAB)
    ops = B * ANCHORS * (3 + 12 + 5) + survivors * (16 * 2 + 3
                                                     + ANCHORS * (1 + 13))
    return ops, nbytes


def bound_s(B: int, max_faces: int, survivors: float) -> float:
    ops, nbytes = work(B, max_faces, survivors)
    return peaks.bound_s(nbytes=nbytes, fp32=ops)
