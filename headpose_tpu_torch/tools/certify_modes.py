"""Certify the port's serving precision modes on the card.

The port's counterpart of scripts/certify_modes.py and the per-mode part of
scripts/certify_stress.py.  It runs a detector (the flagship by default) in
each precision string it serves ("highest", "high", "fast", "turbo", "max",
"default") over

  * tests/golden/parity_corpus.npz (112 images, 451 reference detections
    captured from the reference pipeline at threshold 0.4): detection-set
    agreement (an image agrees when its detection count matches and every
    reference detection is matched by one of ours at box IoU > 0.5), and
    the distributions (p50 / p90 / p99 / max) of the pose error (degrees,
    the largest of |yaw|, |pitch|, |roll| differences per matched
    detection), the box error and the score error;
  * tests/golden/stress_corpus.npz (108 boundary-stress images): the same
    per axis (threshold, nms, saturation, overflow), and on the overflow
    axis whether our first detections reproduce the reference's at the
    100-face cap, position by position (order).

The report records both corpora's sha256, the card (`nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` and the device name)
and the torch and CUDA versions.  These are accuracy figures measured on
the card; JAX's own, measured on a TPU, are in docs/certification.json.

    python -m headpose_tpu_torch.tools.certify_modes \\
        [--out docs/certification_torch.json] [--model NAME] [MODE ...]

It needs a CUDA device (the detectors run on the card); chip_smoke.py uses
`certify_parity` and `certify_stress` for its gates.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
PARITY = os.path.join(REPO, "tests", "golden", "parity_corpus.npz")
STRESS = os.path.join(REPO, "tests", "golden", "stress_corpus.npz")
MODES = ("highest", "high", "fast", "turbo", "max", "default")
AXES = ("threshold", "nms", "saturation", "overflow")
IOU_MATCH = 0.5

__all__ = ["MODES", "AXES", "box_iou", "match_image", "dist",
           "certify_parity", "certify_stress", "certify", "card", "main"]


def box_iou(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
    ub = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
    return inter / (ua + ub - inter) if ua + ub - inter > 0 else 0.0


def match_image(ref: dict, ours) -> tuple[list, bool]:
    """Greedy one-to-one match of the reference detections to ours (a
    `Results`) by IoU > IOU_MATCH: (pairs [(ri, oi)], fully matched)."""
    used, pairs = set(), []
    for ri in range(len(ref["scores"])):
        best, best_iou = None, IOU_MATCH
        for oi in range(len(ours.scores)):
            if oi in used:
                continue
            iou = box_iou(ref["boxes"][ri], ours.boxes[oi])
            if iou > best_iou:
                best, best_iou = oi, iou
        if best is not None:
            used.add(best)
            pairs.append((ri, best))
    full = len(pairs) == len(ref["scores"]) == len(ours.scores)
    return pairs, full


def dist(errs) -> dict:
    errs = np.asarray(errs, np.float64)
    if errs.size == 0:
        return {"n": 0}
    return {"n": int(errs.size), "p50": float(np.percentile(errs, 50)),
            "p90": float(np.percentile(errs, 90)),
            "p99": float(np.percentile(errs, 99)), "max": float(errs.max())}


def _errors(data, per, idxs) -> dict:
    """Set agreement and error distributions of images `idxs`."""
    agree, pose, box, score = 0, [], [], []
    for i in idxs:
        c = int(data["counts"][i])
        ref = {k: data[k][i, :c] for k in ("boxes", "scores", "poses")}
        pairs, full = match_image(ref, per[i])
        agree += full
        for ri, oi in pairs:
            pose.append(np.abs(ref["poses"][ri] - per[i].poses[oi]).max())
            box.append(np.abs(ref["boxes"][ri] - per[i].boxes[oi]).max())
            score.append(abs(float(ref["scores"][ri])
                             - float(per[i].scores[oi])))
    n = len(idxs)
    return {"images": n, "set_agreement": agree / n, "agree_images": agree,
            "pose_deg": dist(pose), "box_norm": dist(box),
            "score": dist(score)}


def certify_parity(detect, data) -> dict:
    """`detect` (a detector's detect) over the parity corpus `data` (the
    npz as a dict): set agreement and error distributions."""
    per = detect(data["imgs"]).trim()
    report = _errors(data, per, range(len(per)))
    report["reference_detections"] = int(data["counts"].sum())
    return report


def _order_exact(ref_boxes, ref_scores, ours, c, score_tol=1e-3) -> bool:
    """Does `ours` emit the reference's first c detections at the same
    positions (box IoU > 0.5, |score delta| < score_tol)?"""
    if len(ours.scores) < c:
        return False
    return all(box_iou(ref_boxes[i], ours.boxes[i]) > IOU_MATCH
               and abs(float(ref_scores[i]) - float(ours.scores[i]))
               < score_tol for i in range(c))


def certify_stress(detect, data) -> dict:
    """`detect` over the stress corpus `data`: per axis set agreement and
    error distributions, and the overflow axis's truncation order at the
    100-face cap."""
    per = detect(data["imgs"]).trim()
    report = {axis: _errors(data, per, np.where(data["axis"] == axis)[0])
              for axis in AXES}
    ov = np.where(data["axis"] == "overflow")[0]
    report["overflow_order"] = {
        "images": int(len(ov)),
        "order_exact": int(sum(_order_exact(
            data["boxes"][i], data["scores"][i], per[i],
            int(data["counts"][i])) for i in ov)),
        "capped_images": int((data["counts"][ov] == 100).sum())}
    return report


def card() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def certify(factory, modes=MODES) -> dict:
    """The certificate of `factory(mode)` (a FaceDetector) in each mode."""
    import torch

    parity, stress = dict(np.load(PARITY)), dict(np.load(STRESS))
    report = {
        "corpus": os.path.relpath(PARITY, REPO),
        "corpus_sha256": _sha(PARITY),
        "images": int(len(parity["imgs"])),
        "reference_detections": int(parity["counts"].sum()),
        "device": {"nvidia_smi": card(),
                   "name": torch.cuda.get_device_name(0)},
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "modes": {},
        "stress": {"corpus": os.path.relpath(STRESS, REPO),
                   "corpus_sha256": _sha(STRESS),
                   "images": int(len(stress["imgs"])),
                   "axes": {a: int((stress["axis"] == a).sum())
                            for a in AXES},
                   "modes": {}},
    }
    for mode in modes:
        det = factory(mode)
        report["modes"][mode] = certify_parity(det.detect, parity)
        report["stress"]["modes"][mode] = certify_stress(det.detect, stress)
        p = report["modes"][mode]
        s = report["stress"]["modes"][mode]
        print(f"{mode:>8}: set agreement {p['agree_images']}/{p['images']}, "
              f"pose deg p99 {p['pose_deg'].get('p99', 0):.4g} max "
              f"{p['pose_deg'].get('max', 0):.4g}; stress "
              + ", ".join(f"{a} {s[a]['agree_images']}/{s[a]['images']}"
                          for a in AXES)
              + f", order {s['overflow_order']['order_exact']}/"
                f"{s['overflow_order']['images']}", file=sys.stderr,
              flush=True)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("modes", nargs="*", metavar="MODE",
                   help=f"modes to certify (default: all of "
                   f"{', '.join(MODES)})")
    p.add_argument("--out", default=os.path.join(
        REPO, "docs", "certification_torch.json"))
    p.add_argument("--model", default=None,
                   help="a pretrained name or model directory (default: "
                        "the flagship)")
    args = p.parse_args(argv)
    bad = sorted(set(args.modes) - set(MODES))
    if bad:
        p.error(f"unknown modes {bad}; the modes are {MODES}")
    from ..pretrained import FLAGSHIP, resolve_model_path
    from ..runtime.detector import FaceDetector

    path = resolve_model_path(args.model or FLAGSHIP)
    report = certify(lambda mode: FaceDetector.from_native(
        path, precision=mode), tuple(args.modes) or MODES)
    report["model"] = args.model or FLAGSHIP
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
