"""The detection postprocess on the card: wrapper of csrc/postprocess.cu.

`postprocess_slab` takes the network's raw outputs and returns the finished
(B, F, 21) slab.  A tensor on the CPU goes through the plain chain of
`ops.detection` (`prepare_postprocess` -> `nms_slab_plain` ->
`finish_postprocess`); a tensor on a CUDA device goes through the
hand-written kernel, one launch that sanitizes, decodes, selects, extracts
and takes the score's sigmoid, or the call raises.  Nothing else selects
between the two.  `postprocess_kernel` has the signature and outputs of the
plain `ops.detection.postprocess`.  Replaces the TPU kernel
headpose_tpu/ops/pallas/postprocess.py::postprocess_pallas.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..detection import (MAX_FACES, MAX_LOGIT, SLAB, _check_shapes, _f32,
                         _decode_matrix, finish_postprocess, nms_slab_plain,
                         prepare_postprocess, score_threshold_to_logit,
                         split_slab)
from ...utils.build import CudaLibrary

__all__ = ["postprocess_kernel", "postprocess_slab", "postprocess_slab_cuda",
           "LIBRARY"]

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "postprocess.cu")


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.headpose_postprocess
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_float] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("postprocess", [SOURCE], _configure)


def _image_blocks(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A (B, H, W, 3) pose map whose images are contiguous blocks, and the
    distance between them in floats (0 for a map expanded over the batch,
    as `detection.cell_index_maps` makes them)."""
    _, h, w, c = t.shape
    if t.stride()[1:] != (w * c, c, 1):
        t = t.contiguous()
    return t, t.stride(0)


def postprocess_slab_cuda(scores_logits: torch.Tensor, loc: torch.Tensor,
                          pose_front: torch.Tensor, pose_back: torch.Tensor,
                          anchors, *, score_threshold: float = 0.4,
                          iou_threshold: float = 0.3, input_size: int = 128,
                          max_faces: int = MAX_FACES) -> torch.Tensor:
    """The kernel: what the plain chain computes, on a CUDA device, one
    launch on the current stream, without synchronising.  Raises on
    anything the kernel does not take, and when the launch fails."""
    dev = scores_logits.device
    if dev.type != "cuda":
        raise ValueError(f"scores_logits must be on a CUDA device, got {dev}")
    if not (isinstance(anchors, torch.Tensor) and anchors.device == dev
            and anchors.dtype == torch.float32):
        anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    _check_shapes(scores_logits, loc, pose_front, pose_back, anchors)
    for name, t in (("scores_logits", scores_logits), ("loc", loc),
                    ("anchors", anchors)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start 16-byte "
                             "aligned")
    if max_faces < 0:
        raise ValueError(f"max_faces must be >= 0, got {max_faces}")
    if input_size <= 0 or input_size & (input_size - 1):
        raise ValueError(f"the kernel decodes exactly only for a power-of-two "
                         f"input_size, got {input_size}")
    pose_front, front_stride = _image_blocks(pose_front)
    pose_back, back_stride = _image_blocks(pose_back)
    B = scores_logits.shape[0]
    slab = torch.empty((B, max_faces, SLAB), dtype=torch.float32, device=dev)
    if B == 0 or max_faces == 0:
        return slab
    m = _decode_matrix(input_size)
    with torch.cuda.device(dev):
        err = LIBRARY.load().headpose_postprocess(
            scores_logits.data_ptr(), loc.data_ptr(), pose_front.data_ptr(),
            pose_back.data_ptr(), anchors.data_ptr(), slab.data_ptr(),
            front_stride, back_stride, B, max_faces, float(m[0, 0]),
            float(m[2, 2]), MAX_LOGIT,
            _f32(score_threshold_to_logit(score_threshold)),
            _f32(iou_threshold), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"postprocess kernel launch failed: CUDA error "
                           f"{err}")
    postprocess_kernel.launches += 1
    return slab


def postprocess_slab(scores_logits: torch.Tensor, loc: torch.Tensor,
                     pose_front: torch.Tensor, pose_back: torch.Tensor,
                     anchors, *, score_threshold: float = 0.4,
                     iou_threshold: float = 0.3, input_size: int = 128,
                     max_faces: int = MAX_FACES) -> torch.Tensor:
    """The finished (B, F, 21) slab (`ops.detection.split_slab` names its
    fields): the CUDA kernel for tensors on a CUDA device, the plain chain
    for tensors on the CPU."""
    kw = dict(score_threshold=score_threshold, iou_threshold=iou_threshold,
              input_size=input_size)
    if scores_logits.device.type != "cpu":
        return postprocess_slab_cuda(scores_logits, loc, pose_front,
                                     pose_back, anchors, max_faces=max_faces,
                                     **kw)
    logits, decoded, pf, pb, logit_thr, iou_thr = prepare_postprocess(
        scores_logits, loc, pose_front, pose_back, anchors, **kw)
    return finish_postprocess(nms_slab_plain(logits, decoded, pf, pb,
                                             logit_thr, iou_thr, max_faces))


def postprocess_kernel(scores_logits: torch.Tensor, loc: torch.Tensor,
                       pose_front: torch.Tensor, pose_back: torch.Tensor,
                       anchors, *, score_threshold: float = 0.4,
                       iou_threshold: float = 0.3, input_size: int = 128,
                       max_faces: int = MAX_FACES) -> dict[str, torch.Tensor]:
    """Drop-in for `ops.detection.postprocess`: `postprocess_slab`'s slab
    split into its fields.

    `postprocess_kernel.launches` counts the kernel's launches."""
    return split_slab(postprocess_slab(
        scores_logits, loc, pose_front, pose_back, anchors,
        score_threshold=score_threshold, iou_threshold=iou_threshold,
        input_size=input_size, max_faces=max_faces))


postprocess_kernel.launches = 0
