"""The detection postprocess on the card: wrapper of csrc/postprocess.cu.

`postprocess_kernel` has the signature and outputs of the plain
`ops.detection.postprocess` and shares its prologue (sanitize, float32
thresholds, the decode matmul) and epilogue (sigmoid of the logit times the
valid flag).  Between them, a tensor on the CPU goes through the plain
selection loop, `nms_slab_plain`; a tensor on a CUDA device goes through the
hand-written kernel, or the call raises.  Nothing else selects between the
two.  Replaces the TPU kernel headpose_tpu/ops/pallas/postprocess.py::
postprocess_pallas.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..detection import (MAX_FACES, NUM_ANCHORS, SLAB, finish_postprocess,
                         nms_slab_plain, prepare_postprocess, split_slab)
from ...utils.build import CudaLibrary

__all__ = ["postprocess_kernel", "postprocess_slab", "nms_slab_cuda",
           "LIBRARY"]

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "postprocess.cu")


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.headpose_postprocess_nms
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("postprocess", [SOURCE], _configure)


def nms_slab_cuda(logits: torch.Tensor, decoded: torch.Tensor,
                  pose_front: torch.Tensor, pose_back: torch.Tensor,
                  logit_thr: float, iou_thr: float,
                  max_faces: int) -> torch.Tensor:
    """The kernel: what `nms_slab_plain` computes, on a CUDA device.

    Launches on the current stream without synchronising.  Raises on
    anything the kernel does not take, and when the launch fails."""
    B = logits.shape[0]
    want = {"logits": (logits, (B, NUM_ANCHORS)),
            "decoded": (decoded, (B, NUM_ANCHORS, 16)),
            "pose_front": (pose_front, (B, 16, 16, 3)),
            "pose_back": (pose_back, (B, 8, 8, 3))}
    for name, (t, shape) in want.items():
        if t.device.type != "cuda" or t.device != logits.device:
            raise ValueError(f"{name} must be on the CUDA device of logits, "
                             f"got {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max_faces < 0:
        raise ValueError(f"max_faces must be >= 0, got {max_faces}")
    slab = torch.zeros((B, max_faces, SLAB), dtype=torch.float32,
                       device=logits.device)
    lib = LIBRARY.load()
    with torch.cuda.device(logits.device):
        err = lib.headpose_postprocess_nms(
            logits.data_ptr(), decoded.data_ptr(), pose_front.data_ptr(),
            pose_back.data_ptr(), slab.data_ptr(), B, max_faces, logit_thr,
            iou_thr, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"postprocess_nms kernel launch failed: CUDA "
                           f"error {err}")
    if B and max_faces:
        postprocess_kernel.launches += 1
    return slab


def postprocess_slab(scores_logits: torch.Tensor, loc: torch.Tensor,
                     pose_front: torch.Tensor, pose_back: torch.Tensor,
                     anchors, *, score_threshold: float = 0.4,
                     iou_threshold: float = 0.3, input_size: int = 128,
                     max_faces: int = MAX_FACES) -> torch.Tensor:
    """The finished (B, F, 21) slab (`ops.detection.split_slab` names its
    fields): the CUDA kernel for tensors on a CUDA device, the plain
    selection loop for tensors on the CPU."""
    logits, decoded, pf, pb, logit_thr, iou_thr = prepare_postprocess(
        scores_logits, loc, pose_front, pose_back, anchors,
        score_threshold=score_threshold, iou_threshold=iou_threshold,
        input_size=input_size)
    select = nms_slab_plain if logits.device.type == "cpu" else nms_slab_cuda
    return finish_postprocess(select(logits, decoded, pf, pb, logit_thr,
                                     iou_thr, max_faces))


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
