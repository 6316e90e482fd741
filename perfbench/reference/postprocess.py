"""SSD anchors, decode, greedy NMS and the pose lookup, plain NumPy.

The reference's postprocess (MediaPipe's BlazeFace with the pose maps
grafted on): anchors whose score passes the threshold are decoded
(centre offsets / input size + the anchor's centre; w, h / input size),
greedy NMS by descending score suppresses IoU > threshold, the lowest index
winning a tie (tf.image.non_max_suppression), at most `max_faces` kept;
each kept face takes the pose at its anchor's cell (front anchors 2 a cell
on the 16x16 map, back anchors 6 a cell on the 8x8 map).  All float32.
"""
from __future__ import annotations

import math

import numpy as np


def anchors(opts: dict) -> np.ndarray:
    """(A, 4) [cx, cy, w, h] of MediaPipe's SSD anchor options (layers of
    equal stride merged; `fixed_anchor_size` gives w = h = 1)."""
    strides = opts["strides"]
    n = len(strides)

    rows, layer = [], 0
    while layer < n:
        per_cell, same = 0, layer
        while same < n and strides[same] == strides[layer]:
            per_cell += len(opts["aspect_ratios"]) + (
                1 if opts["interpolated_scale_aspect_ratio"] > 0 else 0)
            same += 1
        fm = math.ceil(opts["input_size"] / strides[layer])
        ys, xs = np.meshgrid(np.arange(fm), np.arange(fm), indexing="ij")
        cx = np.repeat((xs.reshape(-1) + opts["anchor_offset"]) / fm, per_cell)
        cy = np.repeat((ys.reshape(-1) + opts["anchor_offset"]) / fm, per_cell)
        if not opts["fixed_anchor_size"]:
            raise ValueError("only fixed-size anchors are described here")
        rows.append(np.stack([cx, cy, np.ones_like(cx), np.ones_like(cy)], 1))
        layer = same
    return np.concatenate(rows)


def _area(b: np.ndarray) -> np.ndarray:
    return (np.maximum(b[..., 2] - b[..., 0], 0)
            * np.maximum(b[..., 3] - b[..., 1], 0))


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one corner box with each of `boxes`."""
    ix = np.maximum(np.minimum(box[2], boxes[:, 2])
                    - np.maximum(box[0], boxes[:, 0]), 0)
    iy = np.maximum(np.minimum(box[3], boxes[:, 3])
                    - np.maximum(box[1], boxes[:, 1]), 0)
    inter = ix * iy
    union = _area(box) + _area(boxes) - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0)


def postprocess(out: dict, anchor_table: np.ndarray, input_size: int, *,
                score_threshold: float, iou_threshold: float,
                max_faces: int) -> list[dict]:
    """The network's outputs (NumPy float32, a batch) → per image a dict
    of boxes (N, 4), keypoints (N, 6, 2), scores (N,), poses (N, 3),
    score-descending."""
    logit_thr = np.float32(math.log(score_threshold / (1 - score_threshold)))
    s = np.float32(input_size)
    ax = anchor_table[:, 0].astype(np.float32)
    ay = anchor_table[:, 1].astype(np.float32)
    results = []
    for b in range(out["scores"].shape[0]):
        logit = out["scores"][b]
        loc = out["loc"][b]
        cand = np.nonzero(logit > logit_thr)[0]
        cx = loc[cand, 0] / s + ax[cand]
        cy = loc[cand, 1] / s + ay[cand]
        w, h = loc[cand, 2] / s, loc[cand, 3] / s
        boxes = np.stack([cx - w * 0.5, cy - h * 0.5,
                          cx + w * 0.5, cy + h * 0.5], 1).astype(np.float32)
        order = np.lexsort((cand, -logit[cand]))   # score down, index up
        alive = np.ones(len(cand), bool)
        keep = []
        for o in order:
            if not alive[o]:
                continue
            keep.append(o)
            if len(keep) == max_faces:
                break
            alive &= ~(_iou(boxes[o], boxes) > iou_threshold)
        keep = np.asarray(keep, np.int64)
        idx = cand[keep]
        kp = (loc[idx, 4:16].reshape(-1, 6, 2) / s
              + np.stack([ax[idx], ay[idx]], 1)[:, None, :])
        results.append({
            "boxes": boxes[keep].reshape(-1, 4),
            "keypoints": kp.astype(np.float32).reshape(-1, 6, 2),
            "scores": (1.0 / (1.0 + np.exp(-logit[idx].astype(np.float64)))
                       ).astype(np.float32),
            "poses": _poses(idx, out["pose_front"][b], out["pose_back"][b],
                            len(anchor_table)),
            "logits": logit[idx]})
    return results


def _poses(idx, pose_front, pose_back, n_anchors):
    """The pose at each anchor's cell: front anchors 2 a cell, row-major on
    the front map; the back anchors, the rest, evenly a cell of the back
    map."""
    gf, gb = pose_front.shape[0], pose_back.shape[0]
    n_anchors_front = 2 * gf * gf
    per_back = (n_anchors - n_anchors_front) // (gb * gb)
    out = np.zeros((len(idx), 3), np.float32)
    for n, i in enumerate(idx):
        if i < n_anchors_front:
            c = i // 2
            out[n] = pose_front[c // gf, c % gf]
        else:
            c = (i - n_anchors_front) // per_back
            out[n] = pose_back[c // gb, c % gb]
    return out
