"""Detection postprocess in plain PyTorch: the twin of the CUDA kernel.

Port of headpose_tpu/ops/detection.py.  The reference postprocess is

  * score filter in logit space:  logit > log(t / (1-t));
  * decode:  cx = sx/S + ax, cy = sy/S + ay, w,h /= S; keypoints likewise
    offset by the anchor center — affine in loc, so one (16, 16) matmul;
  * greedy NMS by descending score, IoU > threshold suppresses, the lowest
    index wins a tie (tf.image.non_max_suppression);
  * pose lookup: anchor → grid cell of its feature map; front anchors map
    2-per-cell on the 16x16 map, back anchors 6-per-cell on 8x8.

The single-image building blocks of JAX's module are here too, as plain
tensor functions: `decode_boxes`, `decode_keypoints`, `pairwise_iou`,
`nms_static`, `anchor_cells` and `gather_poses`.

The postprocess is a chain of three steps, which `ops.kernels.postprocess` computes on
the card in one kernel launch:

  prepare_postprocess  sanitize, thresholds rounded to float32 once, decode;
  nms_slab_plain       greedy selection + extraction into a (B, F, 21) slab
                       [16 decoded | 3 pose | logit | valid] — a plain loop
                       over the batch;
  finish_postprocess   in place, the logit channel becomes the score;
  split_slab           the finished slab → {boxes, keypoints, scores, poses,
                       valid}, views of the slab but for valid.

`postprocess` chains them and is the plain reference the tests and
`chip_smoke.py` hold the kernel to, bit for bit.

The survivors head profile (`FaceDetector(head_eval="survivors")`) feeds
the postprocess `cell_index_maps` in place of the pose maps: both the plain
loop and the kernel copy pose values, so each survivor's pose channel 0
comes back as its flat cell index, and `gather_survivor_features` takes the
survivors' feature vectors from the two maps.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["MAX_FACES", "MAX_LOGIT", "KEYPOINTS", "NUM_ANCHORS",
           "NUM_ANCHORS_FRONT", "SLAB", "score_threshold_to_logit",
           "sanitize_model_outputs", "decode_boxes", "decode_keypoints",
           "pairwise_iou", "nms_static", "anchor_cells", "gather_poses",
           "prepare_postprocess", "nms_slab_plain",
           "finish_postprocess", "split_slab", "postprocess",
           "cell_index_maps", "gather_survivor_features"]

MAX_FACES = 100          # the reference's MAX_FACE_NUM
KEYPOINTS = 6
NUM_ANCHORS = 896        # 16x16x2 + 8x8x6
NUM_ANCHORS_FRONT = 512  # 16x16 grid * 2 anchors/cell
FRONT_GRID, BACK_GRID = 16, 8
# slab channels: 16 decoded values, 3 pose angles, the logit (the score once
# finished), the valid flag
C_POSE, C_LOGIT, C_VALID, SLAB = 16, 19, 20, 21


def _f32(x: float) -> float:
    """A Python float rounded to the nearest float32, so that comparisons
    against float32 tensors cannot depend on how a backend casts scalars."""
    return float(np.float32(x))


def score_threshold_to_logit(score_threshold: float) -> float:
    """Probability threshold → logit threshold (sigmoid is monotone, so
    `prob > t` == `logit > logit(t)`), endpoints pinned explicitly.

    The `<= 0` endpoint replicates the reference's STRICT `prob > 0`
    filter: f32 sigmoid underflows to exactly 0 once e^-x overflows (x below
    ~-88.72), and the reference drops those anchors, so 'keep everything'
    must not keep them either (-inf here would)."""
    if score_threshold <= 0.0:
        return -float(np.log(np.finfo(np.float32).max))
    if score_threshold >= 1.0:
        return float(np.inf)
    return float(np.log(score_threshold / (1.0 - score_threshold)))


# the largest finite logit the postprocess keeps: float32(log(FLT_MAX)),
# whose float32 sigmoid is 1.0
MAX_LOGIT = _f32(np.log(np.finfo(np.float32).max))


def sanitize_model_outputs(scores_logits: torch.Tensor, loc: torch.Tensor):
    """Clamp non-finite backbone outputs before any selection arithmetic:

      * +inf logits → the largest finite logit (sigmoid == 1.0 exactly in
        f32, still selected first);
      * nan logits → -inf (fails every threshold, like the reference's
        False comparison on nan);
      * non-finite loc entries → 0 (the anchor decodes to its center box)."""
    lg = torch.where(torch.isnan(scores_logits), -torch.inf,
                     torch.clamp(scores_logits, max=MAX_LOGIT))
    lc = torch.where(torch.isfinite(loc), loc, 0.0)
    return lg, lc


def decode_boxes(loc: torch.Tensor, anchors: torch.Tensor,
                 input_size: int) -> torch.Tensor:
    """loc (..., A, 16) raw offsets + anchors (A, 4) → (..., A, 4) corner
    boxes [x1, y1, x2, y2] normalized to [0, 1]."""
    cx = loc[..., 0] / input_size + anchors[:, 0]
    cy = loc[..., 1] / input_size + anchors[:, 1]
    w = loc[..., 2] / input_size
    h = loc[..., 3] / input_size
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5, cy + h * 0.5], dim=-1)


def decode_keypoints(loc: torch.Tensor, anchors: torch.Tensor,
                     input_size: int) -> torch.Tensor:
    """loc (..., A, 16) → (..., A, 6, 2) keypoints normalized to [0, 1]."""
    kp = loc[..., 4:16].reshape(*loc.shape[:-1], KEYPOINTS, 2)
    return kp / input_size + anchors[:, None, :2]


def pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(K, 4) corner boxes → (K, K) IoU matrix."""
    area = (torch.clamp(boxes[:, 2] - boxes[:, 0], min=0.0)
            * torch.clamp(boxes[:, 3] - boxes[:, 1], min=0.0))
    x1 = torch.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = torch.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = torch.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = torch.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0.0, inter / union, 0.0)


def nms_static(boxes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, max_out: int = MAX_FACES,
               iou_threshold: float = 0.3):
    """Greedy NMS of one image with a fixed output size: boxes (A, 4),
    scores (A,), valid (A,) bool → (sel (max_out,) int32 score-descending,
    keep (max_out,) bool, a dense prefix).  tf.image.non_max_suppression
    over every valid candidate: argmax the remaining scores (the lowest
    index wins a tie; nan never wins), emit it, suppress IoU > threshold.
    The IoU arithmetic keeps the reference's order exactly: kernel #1
    (csrc/postprocess.cu) is held to this function bit for bit."""
    remaining = torch.where(valid, scores, -torch.inf)
    remaining = torch.where(torch.isnan(remaining), -torch.inf, remaining)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    idx = torch.arange(boxes.shape[0], device=boxes.device)
    sel = torch.zeros(max_out, dtype=torch.int32, device=boxes.device)
    count = 0
    while count < max_out and float(remaining.max()) > -np.inf:
        i = int(torch.argmax(remaining))
        inter = (torch.clamp(torch.minimum(x2, x2[i])
                             - torch.maximum(x1, x1[i]), min=0.0)
                 * torch.clamp(torch.minimum(y2, y2[i])
                               - torch.maximum(y1, y1[i]), min=0.0))
        union = area + area[i] - inter
        iou = torch.where(union > 0.0, inter / union, 0.0)
        remaining = torch.where((iou > iou_threshold) | (idx == i),
                                -torch.inf, remaining)
        sel[count] = i
        count += 1
    return sel, torch.arange(max_out, device=boxes.device) < count


def anchor_cells(sel_idx):
    """Anchor indices → (is_front, r16, c16, r8, c8) grid coordinates, as
    tensors of the index's shape.

    Front anchors (index < 512): 2 per cell on the 16x16 map; back anchors:
    6 per cell on the 8x8 map.  Rows/cols come back clipped into range, so
    padded or sentinel indices index safely.  The kernel
    (csrc/postprocess.cu) does the same arithmetic."""
    idx = torch.as_tensor(sel_idx)
    is_front = idx < NUM_ANCHORS_FRONT
    cell_f = idx // 2
    cell_b = torch.clamp(idx - NUM_ANCHORS_FRONT, min=0) // 6
    return (is_front,
            torch.clamp(cell_f // FRONT_GRID, 0, FRONT_GRID - 1),
            torch.clamp(cell_f % FRONT_GRID, 0, FRONT_GRID - 1),
            torch.clamp(cell_b // BACK_GRID, 0, BACK_GRID - 1),
            torch.clamp(cell_b % BACK_GRID, 0, BACK_GRID - 1))


def gather_poses(sel_idx, pose_front: torch.Tensor,
                 pose_back: torch.Tensor) -> torch.Tensor:
    """Anchor indices (K,) → (K, 3) yaw/pitch/roll from one image's pose
    maps, (16, 16, 3) and (8, 8, 3)."""
    is_front, rf, cf, rb, cb = anchor_cells(sel_idx)
    return torch.where(is_front[:, None], pose_front[rf, cf],
                       pose_back[rb, cb])


@functools.lru_cache(maxsize=None)
def _decode_matrix(input_size: int) -> np.ndarray:
    """(16, 16) matrix M such that `loc @ M + bias(anchors)` decodes raw SSD
    offsets into [x1, y1, x2, y2, kx1, ky1, ..., kx6, ky6] (all normalized).
    Every column has at most two non-zero entries, both powers of two times
    1/input_size, so the products are exact and the matmul rounds once, in
    any summation order."""
    s = 1.0 / input_size
    m = np.zeros((16, 16), np.float32)
    m[0, 0] = m[0, 2] = s          # cx appears in x1 and x2
    m[1, 1] = m[1, 3] = s          # cy in y1, y2
    m[2, 0], m[2, 2] = -0.5 * s, 0.5 * s   # w: -w/2 in x1, +w/2 in x2
    m[3, 1], m[3, 3] = -0.5 * s, 0.5 * s   # h
    for k in range(KEYPOINTS):
        m[4 + 2 * k, 4 + 2 * k] = s        # kx_k
        m[5 + 2 * k, 5 + 2 * k] = s        # ky_k
    m.flags.writeable = False
    return m


@functools.lru_cache(maxsize=16)
def _decode_matrix_on(input_size: int, device: torch.device) -> torch.Tensor:
    # cached per device: a host→device copy per call would synchronise
    return torch.tensor(_decode_matrix(input_size), device=device)


def _decode_bias(anchors: torch.Tensor) -> torch.Tensor:
    """(A, 16) anchor-center bias matching `_decode_matrix`'s output layout:
    every output column is offset by the anchor's cx or cy."""
    ax, ay = anchors[:, 0], anchors[:, 1]
    return torch.stack([ax, ay] * 8, dim=-1)


def _check_shapes(scores_logits, loc, pose_front, pose_back, anchors):
    B = scores_logits.shape[0]
    want = {"scores_logits": (scores_logits, (B, NUM_ANCHORS)),
            "loc": (loc, (B, NUM_ANCHORS, 16)),
            "pose_front": (pose_front, (B, FRONT_GRID, FRONT_GRID, 3)),
            "pose_back": (pose_back, (B, BACK_GRID, BACK_GRID, 3)),
            "anchors": (anchors, (NUM_ANCHORS, 4))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != scores_logits.device:
            raise ValueError(f"{name} is on {t.device}, scores_logits on "
                             f"{scores_logits.device}")


def prepare_postprocess(scores_logits, loc, pose_front, pose_back, anchors, *,
                        score_threshold: float, iou_threshold: float,
                        input_size: int):
    """The prologue of the plain chain (the kernel does the same inside).

    Returns (logits (B, A), decoded (B, A, 16), pose_front, pose_back,
    logit_thr, iou_thr): sanitized logits, decoded boxes + keypoints, the
    pose maps made contiguous, and both thresholds rounded to float32."""
    anchors = torch.as_tensor(anchors, dtype=torch.float32,
                              device=scores_logits.device)
    _check_shapes(scores_logits, loc, pose_front, pose_back, anchors)
    logits, loc = sanitize_model_outputs(scores_logits, loc)
    decoded = (torch.matmul(loc, _decode_matrix_on(input_size, loc.device))
               + _decode_bias(anchors))
    return (logits.contiguous(), decoded.contiguous(),
            pose_front.contiguous(), pose_back.contiguous(),
            _f32(score_threshold_to_logit(score_threshold)),
            _f32(iou_threshold))


def nms_slab_plain(logits: torch.Tensor, decoded: torch.Tensor,
                   pose_front: torch.Tensor, pose_back: torch.Tensor,
                   logit_thr: float, iou_thr: float,
                   max_faces: int) -> torch.Tensor:
    """Greedy selection NMS + survivor extraction, one image at a time:
    `nms_static` over the anchors whose logit passes `logit_thr`, then each
    survivor's decoded row, its pose (`gather_poses`) and its logit go into
    slot t, score-descending.  The trip count is the number of survivors.
    Slots past the count stay zero."""
    B = logits.shape[0]
    slab = torch.zeros((B, max_faces, SLAB), dtype=torch.float32,
                       device=logits.device)
    for b in range(B):
        sel, keep = nms_static(decoded[b], logits[b], logits[b] > logit_thr,
                               max_faces, iou_thr)
        sel = sel[keep].long()
        n = sel.shape[0]
        slab[b, :n, :C_POSE] = decoded[b, sel]
        slab[b, :n, C_POSE:C_LOGIT] = gather_poses(sel, pose_front[b],
                                                   pose_back[b])
        slab[b, :n, C_LOGIT] = logits[b, sel]
        slab[b, :n, C_VALID] = 1.0
    return slab


def finish_postprocess(slab: torch.Tensor) -> torch.Tensor:
    """The epilogue of the plain chain (the kernel does the same inside),
    in place on the (B, F, 21) slab: the logit channel becomes
    sigmoid(logit) * valid."""
    slab[..., C_LOGIT] = torch.sigmoid(slab[..., C_LOGIT]) * slab[..., C_VALID]
    return slab


def split_slab(slab: torch.Tensor) -> dict[str, torch.Tensor]:
    """A finished (B, F, 21) slab → dict of (B, F, ...) results; every field
    but the bool `valid` is a view of the slab."""
    B, F = slab.shape[:2]
    return {"boxes": slab[..., :4],
            "keypoints": slab[..., 4:C_POSE].reshape(B, F, KEYPOINTS, 2),
            "scores": slab[..., C_LOGIT],
            "poses": slab[..., C_POSE:C_LOGIT],
            "valid": slab[..., C_VALID] > 0.5}


def postprocess(scores_logits: torch.Tensor, loc: torch.Tensor,
                pose_front: torch.Tensor, pose_back: torch.Tensor,
                anchors, *, score_threshold: float = 0.4,
                iou_threshold: float = 0.3, input_size: int = 128,
                max_faces: int = MAX_FACES) -> dict[str, torch.Tensor]:
    """Batched plain postprocess: (B, 896) logits, (B, 896, 16) loc,
    (B, 16, 16, 3) / (B, 8, 8, 3) pose maps, (896, 4) anchors → dict of
    fixed-size slabs {boxes (B,F,4), keypoints (B,F,6,2), scores (B,F),
    poses (B,F,3), valid (B,F)}, F = max_faces, score-descending."""
    logits, decoded, pf, pb, logit_thr, iou_thr = prepare_postprocess(
        scores_logits, loc, pose_front, pose_back, anchors,
        score_threshold=score_threshold, iou_threshold=iou_threshold,
        input_size=input_size)
    return split_slab(finish_postprocess(nms_slab_plain(
        logits, decoded, pf, pb, logit_thr, iou_thr, max_faces)))


def cell_index_maps(feat_front: torch.Tensor, feat_back: torch.Tensor):
    """Pose-map-shaped tensors whose channel 0 holds the flat cell index:
    front cells first, back cells offset by the front count (the layout of
    the postprocess's pose table).  The indices are small integers, exact
    in float32.  An invalid slot of the slab carries 0, a real index:
    decode only under the `valid` mask."""
    B, hf, wf = feat_front.shape[:3]
    hb, wb = feat_back.shape[1:3]
    nf = hf * wf
    mf = torch.zeros((hf, wf, 3), dtype=torch.float32,
                     device=feat_front.device)
    mf[..., 0] = torch.arange(nf, dtype=torch.float32,
                              device=mf.device).reshape(hf, wf)
    mb = torch.zeros((hb, wb, 3), dtype=torch.float32, device=mf.device)
    mb[..., 0] = nf + torch.arange(hb * wb, dtype=torch.float32,
                                   device=mf.device).reshape(hb, wb)
    return mf.expand(B, hf, wf, 3), mb.expand(B, hb, wb, 3)


def gather_survivor_features(cells: torch.Tensor, valid: torch.Tensor,
                             feat_front: torch.Tensor,
                             feat_back: torch.Tensor):
    """Flat cell indices (B, F) and the valid mask → the feature vector at
    each survivor's cell: (vec_front (B, F, C88), vec_back (B, F, C96),
    is_front (B, F)).  Rows of the other map, and invalid slots, are zero.
    An index gather: each row is copied exactly."""
    B, hf, wf, cf = feat_front.shape
    hb, wb, cb = feat_back.shape[1:]
    nf, nb = hf * wf, hb * wb
    is_front = cells < nf
    base = torch.arange(B, device=cells.device)[:, None]
    rows_f = (base * nf + cells.clamp(0, nf - 1)).reshape(-1)
    rows_b = (base * nb + (cells - nf).clamp(0, nb - 1)).reshape(-1)
    vec_front = feat_front.reshape(B * nf, cf)[rows_f].reshape(B, -1, cf)
    vec_back = feat_back.reshape(B * nb, cb)[rows_b].reshape(B, -1, cb)
    vec_front = torch.where((valid & is_front)[..., None], vec_front, 0.0)
    vec_back = torch.where((valid & ~is_front)[..., None], vec_back, 0.0)
    return vec_front, vec_back, is_front
