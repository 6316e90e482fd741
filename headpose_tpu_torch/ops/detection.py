"""Detection postprocess in plain PyTorch: the twin of the CUDA kernel.

Port of headpose_tpu/ops/detection.py.  The reference postprocess is

  * score filter in logit space:  logit > log(t / (1-t));
  * decode:  cx = sx/S + ax, cy = sy/S + ay, w,h /= S; keypoints likewise
    offset by the anchor center — affine in loc, so one (16, 16) matmul;
  * greedy NMS by descending score, IoU > threshold suppresses, the lowest
    index wins a tie (tf.image.non_max_suppression);
  * pose lookup: anchor → grid cell of its feature map; front anchors map
    2-per-cell on the 16x16 map, back anchors 6-per-cell on 8x8.

It is split in three so that the twin and the kernel share every step
except the selection itself:

  prepare_postprocess  sanitize, thresholds rounded to float32 once, decode;
  nms_slab_plain       greedy selection + extraction into a (B, F, 21) slab
                       [16 decoded | 3 pose | logit | valid] — a plain loop
                       over the batch; `ops.kernels.postprocess` holds the
                       CUDA kernel that computes the same slab;
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

__all__ = ["MAX_FACES", "KEYPOINTS", "NUM_ANCHORS", "NUM_ANCHORS_FRONT",
           "SLAB", "score_threshold_to_logit", "sanitize_model_outputs",
           "anchor_cells", "prepare_postprocess", "nms_slab_plain",
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


def sanitize_model_outputs(scores_logits: torch.Tensor, loc: torch.Tensor):
    """Clamp non-finite backbone outputs before any selection arithmetic:

      * +inf logits → the largest finite logit (sigmoid == 1.0 exactly in
        f32, still selected first);
      * nan logits → -inf (fails every threshold, like the reference's
        False comparison on nan);
      * non-finite loc entries → 0 (the anchor decodes to its center box)."""
    big = _f32(np.log(np.finfo(np.float32).max))
    lg = torch.where(torch.isnan(scores_logits), -torch.inf,
                     torch.clamp(scores_logits, max=big))
    lc = torch.where(torch.isfinite(loc), loc, 0.0)
    return lg, lc


def anchor_cells(index: int) -> tuple[bool, int, int]:
    """Anchor index → (is_front, row, col) of its pose-map cell.

    Front anchors (index < 512): 2 per cell on the 16x16 map; back anchors:
    6 per cell on the 8x8 map.  Rows/cols are clipped into range.  The
    kernel (csrc/postprocess.cu) does the same arithmetic."""
    if index < NUM_ANCHORS_FRONT:
        cell = index // 2
        return (True, min(cell // FRONT_GRID, FRONT_GRID - 1),
                min(cell % FRONT_GRID, FRONT_GRID - 1))
    cell = max(index - NUM_ANCHORS_FRONT, 0) // 6
    return (False, min(cell // BACK_GRID, BACK_GRID - 1),
            min(cell % BACK_GRID, BACK_GRID - 1))


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
    """The prologue shared by the twin and the kernel.

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
    """Greedy selection NMS + survivor extraction, one image at a time.

    Per image: argmax the remaining scores (the lowest index wins a tie),
    emit that anchor into slot t, suppress every anchor with IoU > iou_thr
    against it; stop when nothing remains or the slab is full.  The trip
    count is the number of survivors.  Slots past the count stay zero.
    The IoU arithmetic keeps the reference's order exactly."""
    B, A = logits.shape
    slab = torch.zeros((B, max_faces, SLAB), dtype=torch.float32,
                       device=logits.device)
    idx = torch.arange(A, device=logits.device)
    for b in range(B):
        remaining = torch.where(logits[b] > logit_thr, logits[b], -torch.inf)
        x1, y1, x2, y2 = decoded[b, :, 0], decoded[b, :, 1], \
            decoded[b, :, 2], decoded[b, :, 3]
        area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
        for t in range(max_faces):
            i = int(torch.argmax(remaining))       # first maximal index
            best = float(remaining[i])
            if best == -np.inf:
                break
            ix1 = torch.maximum(x1, x1[i])
            iy1 = torch.maximum(y1, y1[i])
            ix2 = torch.minimum(x2, x2[i])
            iy2 = torch.minimum(y2, y2[i])
            inter = (torch.clamp(ix2 - ix1, min=0.0)
                     * torch.clamp(iy2 - iy1, min=0.0))
            union = area + area[i] - inter
            iou = torch.where(union > 0.0, inter / union, 0.0)
            remaining = torch.where((iou > iou_thr) | (idx == i), -torch.inf,
                                    remaining)
            is_front, r, c = anchor_cells(i)
            pose = pose_front if is_front else pose_back
            slab[b, t, :C_POSE] = decoded[b, i]
            slab[b, t, C_POSE:C_LOGIT] = pose[b, r, c]
            slab[b, t, C_LOGIT] = best
            slab[b, t, C_VALID] = 1.0
    return slab


def finish_postprocess(slab: torch.Tensor) -> torch.Tensor:
    """The epilogue shared by the twin and the kernel, in place on the
    (B, F, 21) slab: the logit channel becomes sigmoid(logit) * valid."""
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
