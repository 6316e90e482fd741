"""The detection postprocess on the card: wrapper of csrc/postprocess.cu.

`postprocess_slab` takes the network's raw outputs and returns the finished
(B, F, 21) slab.  A tensor on the CPU goes through the plain chain of
`ops.detection` (`prepare_postprocess` -> `nms_slab_plain` ->
`finish_postprocess`); a tensor on a CUDA device goes through the
hand-written kernel, one launch that sanitizes, decodes, selects, extracts
and takes the score's sigmoid, or the call raises.  Nothing else selects
between the two.  Both run as the op `headpose_tpu_torch::postprocess`
(ops/kernels/library.py), whose CPU implementation is the plain chain and
whose CUDA implementation is the kernel, so that an exported program holds
the same node on either device (tools/aot.py).  `postprocess_kernel` has the signature and outputs of the
plain `ops.detection.postprocess`.  Replaces the TPU kernel
headpose_tpu/ops/pallas/postprocess.py::postprocess_pallas.
"""
from __future__ import annotations

import torch

from ..detection import MAX_FACES, _check_shapes, split_slab
from . import library as lib

__all__ = ["postprocess_kernel", "postprocess_slab", "postprocess_slab_cuda",
           "LIBRARY"]

LIBRARY = lib.LIBRARIES["postprocess"]
SOURCE = LIBRARY.sources[0]


def _check(scores_logits, loc, pose_front, pose_back, anchors, input_size,
           max_faces) -> torch.Tensor:
    """The anchors as a float32 tensor beside the scores, after the checks
    both implementations share."""
    if not (isinstance(anchors, torch.Tensor)
            and anchors.device == scores_logits.device
            and anchors.dtype == torch.float32):
        anchors = torch.as_tensor(anchors, dtype=torch.float32,
                                  device=scores_logits.device)
    _check_shapes(scores_logits, loc, pose_front, pose_back, anchors)
    if max_faces < 0:
        raise ValueError(f"max_faces must be >= 0, got {max_faces}")
    return anchors


def postprocess_slab_cuda(scores_logits: torch.Tensor, loc: torch.Tensor,
                          pose_front: torch.Tensor, pose_back: torch.Tensor,
                          anchors, *, score_threshold: float = 0.4,
                          iou_threshold: float = 0.3, input_size: int = 128,
                          max_faces: int = MAX_FACES) -> torch.Tensor:
    """The kernel: what the plain chain computes, on a CUDA device, one
    launch of the op `headpose_tpu_torch::postprocess` on the current
    stream, without synchronising.  Raises on anything the kernel does not
    take, and when the launch fails."""
    dev = scores_logits.device
    if dev.type != "cuda":
        raise ValueError(f"scores_logits must be on a CUDA device, got {dev}")
    anchors = _check(scores_logits, loc, pose_front, pose_back, anchors,
                     input_size, max_faces)
    for name, t in (("scores_logits", scores_logits), ("loc", loc),
                    ("anchors", anchors)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if input_size <= 0 or input_size & (input_size - 1):
        raise ValueError(f"the kernel decodes exactly only for a power-of-two "
                         f"input_size, got {input_size}")
    return lib.postprocess(scores_logits, loc, pose_front, pose_back, anchors,
                           float(score_threshold), float(iou_threshold),
                           int(input_size), int(max_faces))


def postprocess_slab(scores_logits: torch.Tensor, loc: torch.Tensor,
                     pose_front: torch.Tensor, pose_back: torch.Tensor,
                     anchors, *, score_threshold: float = 0.4,
                     iou_threshold: float = 0.3, input_size: int = 128,
                     max_faces: int = MAX_FACES) -> torch.Tensor:
    """The finished (B, F, 21) slab (`ops.detection.split_slab` names its
    fields) through the op `headpose_tpu_torch::postprocess`: the CUDA
    kernel for tensors on a CUDA device, the plain chain for tensors on the
    CPU."""
    if scores_logits.device.type != "cpu":
        return postprocess_slab_cuda(
            scores_logits, loc, pose_front, pose_back, anchors,
            score_threshold=score_threshold, iou_threshold=iou_threshold,
            input_size=input_size, max_faces=max_faces)
    anchors = _check(scores_logits, loc, pose_front, pose_back, anchors,
                     input_size, max_faces)
    return lib.postprocess(scores_logits, loc, pose_front, pose_back, anchors,
                           float(score_threshold), float(iou_threshold),
                           int(input_size), int(max_faces))


def postprocess_kernel(scores_logits: torch.Tensor, loc: torch.Tensor,
                       pose_front: torch.Tensor, pose_back: torch.Tensor,
                       anchors, *, score_threshold: float = 0.4,
                       iou_threshold: float = 0.3, input_size: int = 128,
                       max_faces: int = MAX_FACES) -> dict[str, torch.Tensor]:
    """Drop-in for `ops.detection.postprocess`: `postprocess_slab`'s slab
    split into its fields."""
    return split_slab(postprocess_slab(
        scores_logits, loc, pose_front, pose_back, anchors,
        score_threshold=score_threshold, iou_threshold=iou_threshold,
        input_size=input_size, max_faces=max_faces))
