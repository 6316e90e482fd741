"""The port's kernel launches as `torch.library` custom ops.

Every kernel that `FaceDetector.detect` launches is one op in the
`headpose_tpu_torch::` namespace, so that a program traced by
`torch.export` (tools/aot.py) holds the launch as a node and replays it with
no model code on the import path:

  postprocess        csrc/postprocess.cu, kernel #1; on the CPU the plain
                     chain of ops.detection (prepare_postprocess ->
                     nms_slab_plain -> finish_postprocess)
  backbone_stem      csrc/backbone.cu: the fp32 stem alone
  backbone_block     csrc/backbone.cu: one fp32 block alone
  backbone2_segment  csrc/backbone2.cu, kernel #3: one segment of the
                     split-bf16 backbone (its block_kernel and chain_kernel
                     launches)
  dense_block        csrc/dense_bf16.cu: one island block alone
  dense_chain        csrc/dense_bf16.cu: a chain of island blocks, one
                     launch; returns (last map, inner tap map or an empty
                     tensor)
  mlp_head           csrc/head_mlp.cu, kernel #4
  se_transformer     csrc/se_attention.cu, kernel #5

An op takes tensors, ints, floats and lists of ints only: the packs and the
plans as the wrappers in this package (postprocess.py, backbone2.py,
dense_bf16.py, head_mlp.py, se_attention.py) compute them on the host.  The
wrappers check the inputs, pack the weights and plan the launches; the op
launches on the current stream, raises when a launch fails and counts its
launches in `LAUNCHES`, so a replayed program counts as `detect` does.  Each
op has a fake implementation (its output shapes) for tracing.  Only
`postprocess` runs on the CPU; the others are registered for CUDA alone.

This module imports torch, numpy, `utils.build` and `ops.detection`, and
nothing else of the package: loading an exported program needs no model
code.  Nothing is built at import time: each library is compiled with nvcc
on its first launch (utils.build).
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from ...utils.build import NVCC_FLAGS, NVCC_FLAGS_FMA, CudaLibrary
from ..detection import (MAX_LOGIT, SLAB, _decode_matrix, _f32,
                         finish_postprocess, nms_slab_plain,
                         prepare_postprocess, score_threshold_to_logit)

__all__ = ["NAMESPACE", "LIBRARIES", "LAUNCHES", "Counted", "library"]

NAMESPACE = "headpose_tpu_torch"
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")

_P, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)


def _declare(**entries):
    """configure(lib) declaring each entry point's argtypes; restype int."""
    def configure(lib: ctypes.CDLL) -> None:
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return configure


# name -> the library; the ops look theirs up here at each launch, so a tool
# may put a variant build in its place (tools/kernel_phases.py)
LIBRARIES = {lib.name: lib for lib in (
    CudaLibrary("postprocess", [os.path.join(CSRC, "postprocess.cu")],
                _declare(headpose_postprocess=[_P] * 6 + [_LL] * 2 + [_I] * 2
                         + [_F] * 5 + [_P]), NVCC_FLAGS),
    CudaLibrary("backbone", [os.path.join(CSRC, "backbone.cu")],
                _declare(headpose_backbone_forward=[_P] * 5 + [_I] * 4
                         + [_P] * 4 + [_I, _P],
                         headpose_backbone_stem=[_P] * 4 + [_I] * 3 + [_P],
                         headpose_backbone_block=[_P] * 6 + [_I] * 5 + [_P]),
                NVCC_FLAGS_FMA),
    CudaLibrary("backbone2", [os.path.join(CSRC, "backbone2.cu")],
                _declare(headpose_backbone2_segment=[_P] * 7 + [_I] * 3
                         + [_P] * 3 + [_I, _P],
                         headpose_backbone2_groups=[_P] * 2 + [_I] * 3 + [_P]),
                NVCC_FLAGS_FMA),
    CudaLibrary("dense_bf16", [os.path.join(CSRC, "dense_bf16.cu")],
                _declare(headpose_dense_bf16_block=[_P] * 4 + [_I] * 5 + [_P],
                         headpose_dense_bf16_chain=[_P] * 5 + [_I] * 3
                         + [_P] * 2 + [_I, _P],
                         headpose_dense_bf16_block_plan=[_I] * 5 + [_P],
                         headpose_dense_bf16_chain_plan=[_P] * 2 + [_I] * 2
                         + [_P]),
                NVCC_FLAGS),
    CudaLibrary("head_mlp", [os.path.join(CSRC, "head_mlp.cu")],
                _declare(headpose_mlp_head=[_P] * 3 + [_I] + [_P] * 2),
                NVCC_FLAGS_FMA),
    CudaLibrary("se_attention", [os.path.join(CSRC, "se_attention.cu")],
                _declare(headpose_se_transformer=[_P] * 5 + [_I] * 2
                         + [_P] * 3),
                NVCC_FLAGS_FMA),
)}

# launches counted by the ops' CUDA implementations; "apply_fused" counts
# the split-bf16 backbone calls (its first segment's launch)
LAUNCHES = dict.fromkeys(("postprocess", "backbone2_segment", "apply_fused",
                          "dense_block", "dense_chain", "mlp_head",
                          "se_transformer"), 0)


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name` (built with nvcc on first use)."""
    return LIBRARIES[name].load()


class Counted:
    """A kernel's wrapper function whose `launches` attribute reads and sets
    the count its op keeps in `LAUNCHES[key]`."""

    def __init__(self, fn, key: str):
        functools.update_wrapper(self, fn)
        self._key = key

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        return LAUNCHES[self._key]

    @launches.setter
    def launches(self, n: int) -> None:
        LAUNCHES[self._key] = n


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{'unsupported shape' if err < 0 else 'CUDA error'}"
                           f" ({err})")


def _aligned(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: an operand does not start 16-byte "
                             "aligned (the kernels stage rows with 16-byte "
                             "copies)")


@functools.lru_cache(maxsize=256)
def _c_ints(values: tuple[int, ...]) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _ints(values) -> ctypes.Array:
    """A host int array for a kernel's C entry point (cached by value)."""
    return _c_ints(tuple(int(v) for v in values))


def _op(name: str, device_types=None):
    return torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=(),
                                   device_types=device_types)


# ---------------------------------------------------------------- kernel #1
def _image_blocks(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A (B, H, W, 3) pose map whose images are contiguous blocks, and the
    distance between them in floats (0 for a map expanded over the batch,
    as `detection.cell_index_maps` makes them)."""
    _, h, w, c = t.shape
    if t.stride()[1:] != (w * c, c, 1):
        t = t.contiguous()
    return t, t.stride(0)


@_op("postprocess", "cpu")
def postprocess(scores: torch.Tensor, loc: torch.Tensor,
                pose_front: torch.Tensor, pose_back: torch.Tensor,
                anchors: torch.Tensor, score_threshold: float,
                iou_threshold: float, input_size: int,
                max_faces: int) -> torch.Tensor:
    """The finished (B, max_faces, 21) slab of the network's raw outputs:
    on the CPU the plain chain, on a CUDA device kernel #1."""
    logits, decoded, pf, pb, logit_thr, iou_thr = prepare_postprocess(
        scores, loc, pose_front, pose_back, anchors,
        score_threshold=score_threshold, iou_threshold=iou_threshold,
        input_size=input_size)
    return finish_postprocess(nms_slab_plain(logits, decoded, pf, pb,
                                             logit_thr, iou_thr, max_faces))


@postprocess.register_kernel("cuda")
def _(scores, loc, pose_front, pose_back, anchors, score_threshold,
      iou_threshold, input_size, max_faces):
    B = scores.shape[0]
    slab = scores.new_empty((B, max_faces, SLAB))
    if B == 0 or max_faces == 0:
        return slab
    _aligned("postprocess", scores, loc, anchors)
    pose_front, front_stride = _image_blocks(pose_front)
    pose_back, back_stride = _image_blocks(pose_back)
    m = _decode_matrix(input_size)
    with torch.cuda.device(scores.device):
        err = library("postprocess").headpose_postprocess(
            scores.data_ptr(), loc.data_ptr(), pose_front.data_ptr(),
            pose_back.data_ptr(), anchors.data_ptr(), slab.data_ptr(),
            front_stride, back_stride, B, max_faces, float(m[0, 0]),
            float(m[2, 2]), MAX_LOGIT,
            _f32(score_threshold_to_logit(score_threshold)),
            _f32(iou_threshold), _stream())
    _check(err, "postprocess kernel")
    LAUNCHES["postprocess"] += 1
    return slab


@postprocess.register_fake
def _(scores, loc, pose_front, pose_back, anchors, score_threshold,
      iou_threshold, input_size, max_faces):
    return scores.new_empty((scores.shape[0], max_faces, SLAB))


# --------------------------------------------------- fp32 stem and block
@_op("backbone_stem", "cuda")
def backbone_stem(x: torch.Tensor, weights: torch.Tensor, w_offset: int,
                  b_offset: int, channels: int) -> torch.Tensor:
    """relu(stem(x)) in fp32: x (B, S, S, 3) -> (B, S/2, S/2, channels);
    the stem's kernel and bias start at `w_offset` and `b_offset` floats in
    `weights` (the fp32 backbone pack)."""
    B, s = x.shape[0], x.shape[1]
    out = x.new_empty((B, s // 2, s // 2, channels))
    _aligned("stem", x)
    w = weights.data_ptr()
    with torch.cuda.device(x.device):
        err = library("backbone").headpose_backbone_stem(
            x.data_ptr(), w + 4 * w_offset, w + 4 * b_offset, out.data_ptr(),
            B, s, channels, _stream())
    _check(err, "stem kernel")
    return out


@backbone_stem.register_fake
def _(x, weights, w_offset, b_offset, channels):
    return x.new_empty((x.shape[0], x.shape[1] // 2, x.shape[1] // 2,
                        channels))


@_op("backbone_block", "cuda")
def backbone_block(x: torch.Tensor, weights: torch.Tensor,
                   offsets: list[int], cout: int,
                   stride: int) -> torch.Tensor:
    """One BlazeBlock in fp32: x (B, H, H, Cin) -> (B, H/stride, H/stride,
    cout); its dw, dw bias, pw and pw bias start at `offsets` (floats) in
    `weights`."""
    B, h, cin = x.shape[0], x.shape[1], x.shape[3]
    out = x.new_empty((B, h // stride, h // stride, cout))
    _aligned("block", x)
    w = weights.data_ptr()
    with torch.cuda.device(x.device):
        err = library("backbone").headpose_backbone_block(
            x.data_ptr(), *[w + 4 * o for o in offsets], out.data_ptr(), B,
            h, cin, cout, stride, _stream())
    _check(err, "block kernel")
    return out


@backbone_block.register_fake
def _(x, weights, offsets, cout, stride):
    h = x.shape[1] // stride
    return x.new_empty((x.shape[0], h, h, cout))


# ---------------------------------------------------------------- kernel #3
def _sides(h: int, strides) -> list[int]:
    out = []
    for s in strides:
        h //= s
        out.append(h)
    return out


@_op("backbone2_segment", "cuda")
def backbone2_segment(x: torch.Tensor, f32: torch.Tensor,
                      f32_offsets: list[int], bf16: torch.Tensor,
                      bf16_offsets: list[int], channels: list[int],
                      strides: list[int], opens: bool) -> torch.Tensor:
    """One segment of the split-bf16 backbone over x (B, H, H, Cin): blocks
    of `channels` (their outputs) and `strides`, with each block's dw, dw
    bias and pw bias at `f32_offsets` (3 a block) in the fp32 pack and its
    w_hi, w_lo at `bf16_offsets` (2 a block) in the bf16 pack.  `opens`:
    the first segment of an `apply_fused` call, which counts the call."""
    B, h, cin = x.shape[0], x.shape[1], x.shape[3]
    sizes = _sides(h, strides)
    out = x.new_empty((B, sizes[-1], sizes[-1], channels[-1]))
    scratch = B * max([1] + [s * s * c for s, c in zip(sizes[:-1],
                                                       channels[:-1])])
    if B == 0:
        return out
    buf_a, buf_b = x.new_empty(scratch), x.new_empty(scratch)
    _aligned("segment", x)
    with torch.cuda.device(x.device):
        err = library("backbone2").headpose_backbone2_segment(
            x.data_ptr(), f32.data_ptr(), _ints(f32_offsets),
            bf16.data_ptr(), _ints(bf16_offsets), _ints(channels),
            _ints(strides), len(channels), h, cin, buf_a.data_ptr(),
            buf_b.data_ptr(), out.data_ptr(), B, _stream())
    _check(err, "segment kernel")
    LAUNCHES["backbone2_segment"] += 1
    LAUNCHES["apply_fused"] += bool(opens)
    return out


@backbone2_segment.register_fake
def _(x, f32, f32_offsets, bf16, bf16_offsets, channels, strides, opens):
    h = _sides(x.shape[1], strides)[-1]
    return x.new_empty((x.shape[0], h, h, channels[-1]))


# ------------------------------------------------------------ island kernels
@_op("dense_block", "cuda")
def dense_block(x: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor,
                k_offset: int, b_offset: int, cout: int,
                stride: int) -> torch.Tensor:
    """One island block over x (B, H, H, Cin): its composed bf16 kernel at
    `k_offset` elements in `kernels`, its fp32 bias at `b_offset` in
    `biases` -> (B, H/stride, H/stride, cout)."""
    B, h, cin = x.shape[0], x.shape[1], x.shape[3]
    out = x.new_empty((B, h // stride, h // stride, cout))
    if B == 0:
        return out
    _aligned("island block", x)
    with torch.cuda.device(x.device):
        err = library("dense_bf16").headpose_dense_bf16_block(
            x.data_ptr(), kernels.data_ptr() + 2 * k_offset,
            biases.data_ptr() + 4 * b_offset, out.data_ptr(), B, h, cin,
            cout, stride, _stream())
    _check(err, "island block kernel")
    LAUNCHES["dense_block"] += 1
    return out


@dense_block.register_fake
def _(x, kernels, biases, k_offset, b_offset, cout, stride):
    h = x.shape[1] // stride
    return x.new_empty((x.shape[0], h, h, cout))


def _chain_shapes(x, channels, strides, tap):
    sides = _sides(x.shape[1], strides)
    out = (x.shape[0], sides[-1], sides[-1], channels[-1])
    tap_shape = ((x.shape[0], sides[tap], sides[tap], channels[tap + 1])
                 if tap >= 0 else (0,))
    return out, tap_shape


@_op("dense_chain", "cuda")
def dense_chain(x: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor,
                k_offsets: list[int], b_offsets: list[int],
                channels: list[int], strides: list[int],
                tap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A chain of island blocks over x (B, H, H, channels[0]) in one launch:
    blocks of `channels` (n + 1) and `strides` (n), their kernels at
    `k_offsets` and biases at `b_offsets`.  Returns (the last map, the map
    of block `tap` of the chain when tap >= 0, else an empty tensor)."""
    out_shape, tap_shape = _chain_shapes(x, channels, strides, tap)
    out, tap_out = x.new_empty(out_shape), x.new_empty(tap_shape)
    if x.shape[0] == 0:
        return out, tap_out
    _aligned("island chain", x)
    k, b = kernels.data_ptr(), biases.data_ptr()
    n = len(strides)
    w_ptrs = (ctypes.c_void_p * n)(*[k + 2 * o for o in k_offsets])
    b_ptrs = (ctypes.c_void_p * n)(*[b + 4 * o for o in b_offsets])
    with torch.cuda.device(x.device):
        err = library("dense_bf16").headpose_dense_bf16_chain(
            x.data_ptr(), w_ptrs, b_ptrs, _ints(channels), _ints(strides),
            n, x.shape[1], tap, out.data_ptr(),
            tap_out.data_ptr() if tap >= 0 else None, x.shape[0], _stream())
    _check(err, "island chain kernel")
    LAUNCHES["dense_chain"] += 1
    return out, tap_out


@dense_chain.register_fake
def _(x, kernels, biases, k_offsets, b_offsets, channels, strides, tap):
    out_shape, tap_shape = _chain_shapes(x, channels, strides, tap)
    return x.new_empty(out_shape), x.new_empty(tap_shape)


# ---------------------------------------------------------------- kernel #4
@_op("mlp_head", "cuda")
def mlp_head(x: torch.Tensor, weights: torch.Tensor, table: list[int],
             out_features: int) -> torch.Tensor:
    """An MLP pose head over rows x (N, C) -> (N, out_features): `weights`
    the head's pack, `table` its launch table (csrc/head_mlp.cu)."""
    out = x.new_empty((x.shape[0], out_features))
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        err = library("head_mlp").headpose_mlp_head(
            x.data_ptr(), weights.data_ptr(), out.data_ptr(), x.shape[0],
            _ints(table), _stream())
    _check(err, "mlp_head kernel")
    LAUNCHES["mlp_head"] += 1
    return out


@mlp_head.register_fake
def _(x, weights, table, out_features):
    return x.new_empty((x.shape[0], out_features))


# ---------------------------------------------------------------- kernel #5
@_op("se_transformer", "cuda")
def se_transformer(x: torch.Tensor, weights: torch.Tensor, dims: list[int],
                   offsets: list[int]) -> torch.Tensor:
    """The SE-Transformer head over maps x (B, H, W, C) -> (B, H, W, out):
    `dims` = (C, C / reduction, heads, key_dim, ff_dim, hidden, out),
    `offsets` each leaf's start in the pack `weights`.  Three launches (the
    gates; K/V; attention and the tail), one for 1x1 maps; counted once."""
    B, hs, ws, c = x.shape
    T = hs * ws
    hd = dims[2] * dims[3]
    out = x.new_empty((B, hs, ws, dims[6]))
    if B * T == 0:
        return out
    _aligned("se_transformer", x)
    gate = x.new_empty((B, c) if T > 1 else (0,))
    kv = x.new_empty((B * T, 2 * hd) if T > 1 else (0,))
    with torch.cuda.device(x.device):
        err = library("se_attention").headpose_se_transformer(
            x.data_ptr(), weights.data_ptr(), gate.data_ptr(), kv.data_ptr(),
            out.data_ptr(), B, T, _ints(dims), _ints(offsets), _stream())
    _check(err, "se_transformer kernel")
    LAUNCHES["se_transformer"] += 1
    return out


@se_transformer.register_fake
def _(x, weights, dims, offsets):
    return x.new_empty((*x.shape[:3], dims[6]))
