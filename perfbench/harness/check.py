"""The comparison that decides `correct`: the program's trimmed answers for
a seed-drawn sample of the window's batches against the plain reference on
the same frames.

Per frame, the program's faces and the reference's are paired in score
order by IoU > 0.5.  A face on one side alone is explained when the two
sides may rightly differ on it: its score lies within `score_margin` of the
threshold, or its IoU with a higher-scored face of its own side lies
within `iou_margin` of the NMS threshold, or an explained face of the other
side, scored higher, overlaps it past the NMS threshold less the margin
(the face that would have suppressed it).  The numbers compared, each
against its limit (perfbench/limits/<workload>.json):

  missing_frames  frames of a sampled batch with no answer (0);
  unexplained     faces on one side alone that nothing explains;
  pose_gap_deg    the largest yaw/pitch/roll gap of a pair, degrees;
  box_gap         the largest box or keypoint gap of a pair (normalised);
  score_gap       the largest score gap of a pair.
"""
from __future__ import annotations

import numpy as np

COMPARED = ("missing_frames", "unexplained", "pose_gap_deg", "box_gap",
            "score_gap")


def _worst(a: float, b: float) -> float:
    """The larger of two readings, NaN if either is (Python's max would
    drop a NaN that comes second)."""
    return a if (np.isnan(a) or a >= b) else b


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)

    def area(x):
        return (np.maximum(x[:, 2] - x[:, 0], 0)
                * np.maximum(x[:, 3] - x[:, 1], 0))

    ix = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]), 0)
    iy = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]), 0)
    inter = ix * iy
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0)


def _explained(side, other, lone, lone_other, explained_other, cfg, m):
    """Which of `side`'s lone faces (indices `lone`) are explained."""
    out = set()
    own = iou_matrix(side["boxes"], side["boxes"])
    cross = iou_matrix(side["boxes"], other["boxes"])
    for i in lone:
        s = float(side["scores"][i])
        if abs(s - cfg["score_threshold"]) <= m["score_margin"]:
            out.add(i)
        elif any(abs(own[i, j] - cfg["iou_threshold"]) <= m["iou_margin"]
                 for j in range(len(side["scores"]))
                 if side["scores"][j] >= s and j != i):
            out.add(i)
        elif any(cross[i, j] > cfg["iou_threshold"] - m["iou_margin"]
                 and other["scores"][j] >= s
                 for j in lone_other if j in explained_other):
            out.add(i)
    return out


def compare_frame(got, want: dict, cfg: dict, margins: dict) -> dict:
    """One frame: `got` the program's Results, `want` the reference's."""
    g = {"boxes": np.asarray(got.boxes), "scores": np.asarray(got.scores),
         "keypoints": np.asarray(got.keypoints),
         "poses": np.asarray(got.poses)}
    iou = iou_matrix(g["boxes"], want["boxes"])
    pairs, used = [], set()
    for j in range(len(want["scores"])):       # reference in score order
        best, bi = 0.5, None
        for i in range(len(g["scores"])):
            if i not in used and iou[i, j] > best:
                best, bi = iou[i, j], i
        if bi is not None:
            used.add(bi)
            pairs.append((bi, j))
    lone_g = [i for i in range(len(g["scores"])) if i not in used]
    paired_w = {j for _, j in pairs}
    lone_w = [j for j in range(len(want["scores"])) if j not in paired_w]
    ex_g, ex_w = set(), set()
    for _ in range(3):                      # explanations lean on each other
        ex_g = _explained(g, want, lone_g, lone_w, ex_w, cfg, margins)
        ex_w = _explained(want, g, lone_w, lone_g, ex_g, cfg, margins)
    gi = [i for i, _ in pairs]
    wj = [j for _, j in pairs]

    def gap(key):
        if not pairs:
            return 0.0
        return float(np.abs(g[key][gi].astype(np.float64)
                            - want[key][wj].astype(np.float64)).max())

    return {"unexplained": len(lone_g) - len(ex_g) + len(lone_w) - len(ex_w),
            "explained": len(ex_g) + len(ex_w), "pairs": len(pairs),
            "pose_gap_deg": gap("poses"),
            "box_gap": _worst(gap("boxes"), gap("keypoints")),
            "score_gap": gap("scores")}


def compare(got_batches: list, want_batches: list, cfg: dict,
            margins: dict) -> dict:
    """Sampled batches: `got_batches` the program's lists of Results (None
    or short where answers are missing), `want_batches` the reference's."""
    total = {"missing_frames": 0, "unexplained": 0, "explained": 0,
             "pairs": 0, "frames": 0, "pose_gap_deg": 0.0, "box_gap": 0.0,
             "score_gap": 0.0}
    for got, want in zip(got_batches, want_batches):
        got = got or []
        total["missing_frames"] += max(len(want) - len(got), 0)
        for g, w in zip(got, want):
            r = compare_frame(g, w, cfg, margins)
            total["frames"] += 1
            for k in ("unexplained", "explained", "pairs"):
                total[k] += r[k]
            for k in ("pose_gap_deg", "box_gap", "score_gap"):
                total[k] = _worst(total[k], r[k])
    return total


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [reading, limit]}) over the compared numbers; a
    reading that is not a number (NaN) fails."""
    shown = {k: [readings[k], limits[k]] for k in COMPARED}
    ok = all(np.isfinite(v) and v <= lim for v, lim in shown.values())
    return bool(ok and readings["frames"] > 0), shown
