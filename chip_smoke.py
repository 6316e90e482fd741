#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (headpose_tpu_torch) on one GPU.

Usage, from the root of the repository:  python3 chip_smoke.py

It drives the port's main path, FaceDetector.detect, on the card and exits
non-zero on any failure (no phase catches its own failure).  It imports
torch, numpy and the port: never jax, nor the headpose_tpu package.  Every
line it prints is one JSON object, except the nvidia-smi line:

  device   the card (name, power limit), torch and CUDA versions;
  kernels  per kernel: builds it from csrc/ with nvcc, holds it against its
           plain PyTorch twin on the card, bit for bit, over fuzz cases;
           times it (CUDA events) at the main path's shapes;
  parity   flagship_detector() on the 112 parity-corpus images against the
           reference detections (set agreement 1.0, pose p99 and max
           < 0.1 deg) and on e2e_production.npz; the kernel's launch count
           is reset just before these detect calls and must grow;
  stress   the 108-image stress corpus per axis (set agreement 1.0, pose
           max < 0.1 deg), the reference's truncation order at the 100-face
           cap, and its uncapped >100-survivor sets at max_faces=256;
  best     best_detector() on 8 corpus images: the flagship's detections;
  timing   detect wall time at B=1 and B=128 (host clock around a
           synchronised call) and the per-stage split at B=128;
  then the {"kernels": [...]} summary, the nvidia-smi line, and last
  {"ok": true, "device": {...}}.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PARITY_BUDGET_DEG = 0.1
IOU_MATCH = 0.5
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------ fuzz inputs
def fuzz_inputs(b, seed, loc_std=8.0, bias=0.0, quantize=False,
                nonfinite=False):
    """The fuzz inputs of the repository's postprocess tests (numpy, from a
    seed): random logits/loc/pose maps, optionally exact score ties and
    NaN / +-inf logits and non-finite loc."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(0.0, 2.0, (b, 896)) + bias).astype(np.float32)
    if quantize:
        logits = np.round(logits).astype(np.float32)
    loc = rng.normal(0.0, loc_std, (b, 896, 16)).astype(np.float32)
    pf = rng.normal(0, 0.5, (b, 16, 16, 3)).astype(np.float32)
    pb = rng.normal(0, 0.5, (b, 8, 8, 3)).astype(np.float32)
    if nonfinite:
        logits[0, 5] = np.nan
        logits[-1, 7] = -np.inf
        logits[0, 700] = np.inf
        loc[0, 3, :] = np.nan
        loc[-1, 11, 2] = np.inf
    return logits, loc, pf, pb


FUZZ = [
    dict(name="random_b128", b=128, thr=0.4, iou=0.3, mf=100, seed=1),
    dict(name="odd_batch", b=3, thr=0.4, iou=0.3, mf=100, seed=3),
    dict(name="all_empty", b=3, thr=0.99, iou=0.3, mf=16, seed=5, bias=-8.0),
    dict(name="threshold_0", b=1, thr=0.0, iou=0.3, mf=100, seed=6),
    dict(name="threshold_1", b=3, thr=1.0, iou=0.3, mf=16, seed=2),
    dict(name="heavy_nms", b=3, thr=0.4, iou=0.01, mf=32, seed=8),
    dict(name="all_admitted_b128", b=128, thr=0.0, iou=0.01, mf=100,
         seed=99),
    dict(name="clusters_b128", b=128, thr=0.4, iou=0.3, mf=16, seed=9,
         loc_std=0.5),
    dict(name="ties_b128", b=128, thr=0.4, iou=0.3, mf=32, seed=11,
         quantize=True),
    dict(name="ties_clustered", b=3, thr=0.0, iou=0.01, mf=100, seed=12,
         quantize=True, loc_std=0.5),
    dict(name="nonfinite", b=3, thr=0.4, iou=0.3, mf=16, seed=13,
         nonfinite=True),
    dict(name="nonfinite_slab256", b=1, thr=0.0, iou=0.3, mf=256, seed=14,
         nonfinite=True),
]


def max_abs_err(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max())
               if a[k].numel() else 0.0 for k in FIELDS)


def assert_bitwise(got: dict, want: dict, what: str) -> None:
    for k in FIELDS:
        if got[k].shape != want[k].shape or not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: field {k} differs from the twin "
                                 f"(max abs err {max_abs_err(got, want)})")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events, warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phases
def phase_kernels(dev, anchors, main_inputs):
    """postprocess_nms: the kernel against its twin on the card."""
    from headpose_tpu_torch.ops import detection as det
    from headpose_tpu_torch.ops.kernels import postprocess as kern

    t0 = time.perf_counter()
    kern.LIBRARY.load()                    # nvcc from csrc/ (first use)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in kern.LIBRARY.build_log.splitlines()
             if "registers" in ln or "smem" in ln]

    cases = []
    for case in FUZZ:
        case = dict(case)
        name, thr, iou, mf = (case.pop(k) for k in ("name", "thr", "iou",
                                                    "mf"))
        arrays = fuzz_inputs(**case)
        cuda_in = [torch.from_numpy(x).to(dev) for x in arrays]
        kw = dict(score_threshold=thr, iou_threshold=iou, max_faces=mf)
        got = kern.postprocess_kernel(*cuda_in, anchors, **kw)
        want = det.postprocess(*cuda_in, anchors, **kw)
        torch.cuda.synchronize()
        assert_bitwise(got, want, name)
        cases.append({"case": name, "b": case["b"], "max_faces": mf,
                      "survivors": int(want["valid"].sum()),
                      "max_abs_err": max_abs_err(got, want)})

    # the main path's own inputs: flagship outputs for 128 corpus frames
    kw = dict(score_threshold=0.4, iou_threshold=0.3, max_faces=100)
    got = kern.postprocess_kernel(*main_inputs, anchors, **kw)
    want = det.postprocess(*main_inputs, anchors, **kw)
    torch.cuda.synchronize()
    assert_bitwise(got, want, "main_path_b128")
    # the CPU twin (held to JAX bit for bit by the CPU tests): scores may
    # differ by an ulp of sigmoid between the two devices
    cpu = det.postprocess(*(t.cpu() for t in main_inputs), anchors.cpu(),
                          **kw)
    for k in FIELDS:
        g, w = got[k].cpu(), cpu[k]
        if k == "scores":
            if float((g - w).abs().max()) > 1e-6:
                raise AssertionError("main_path_b128: scores vs CPU twin")
        elif not torch.equal(g, w):
            raise AssertionError(f"main_path_b128: {k} differs from the "
                                 "CPU twin")
    survivors = int(want["valid"].sum())
    cases.append({"case": "main_path_b128", "b": 128, "max_faces": 100,
                  "survivors": survivors,
                  "max_abs_err": max_abs_err(got, want)})

    # timing at the main path's shapes: B=128, F=100
    B, F = 128, 100
    ms = cuda_ms(lambda: kern.postprocess_kernel(*main_inputs, anchors, **kw),
                 200)
    plain_ms = cuda_ms(lambda: det.postprocess(*main_inputs, anchors, **kw),
                       3)
    prep = det.prepare_postprocess(*main_inputs, anchors, score_threshold=0.4,
                                   iou_threshold=0.3, input_size=128)
    kernel_only_ms = cuda_ms(lambda: kern.nms_slab_cuda(*prep, F), 200)
    # the worst case: all 896 anchors admitted, suppression defeated, so
    # every image runs the full 100 trips
    worst = [torch.from_numpy(x).to(dev) for x in fuzz_inputs(B, 99)]
    wprep = det.prepare_postprocess(*worst, anchors, score_threshold=0.0,
                                    iou_threshold=0.01, input_size=128)
    worst_ms = cuda_ms(lambda: kern.nms_slab_cuda(*wprep, F), 50)
    bytes_moved = (B * 896 * 4 + B * 896 * 16 * 4 + B * 320 * 3 * 4
                   + 896 * 4 * 4                     # inputs, read once
                   + B * F * (4 + 12 + 1 + 3) * 4 + B * F)   # outputs
    operations = (2 * B * 896 * 16 * 16              # decode matmul
                  + survivors * 896 * 13)            # IoU + suppress per trip
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = operations / H100_FP32_FLOPS * 1e3
    entry = {
        "name": "postprocess_nms", "route": "cuda",
        "source": "headpose_tpu_torch/csrc/postprocess.cu",
        "replaces": "headpose_tpu/ops/pallas/postprocess.py:67",
        "launches": None,                     # filled by the parity phase
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": 0.0,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,      # no PyTorch call computes greedy NMS
        "kernel_only_ms": kernel_only_ms,
        "kernel_only_worst_case_ms": worst_ms,
        "bytes": bytes_moved, "operations": operations,
        "shape": {"B": B, "F": F, "survivors": survivors},
        "build_s": build_s, "ptxas": ptxas,
    }
    emit({"phase": "kernels", "kernel": "postprocess_nms", "cases": cases,
          "ms": ms, "plain_ms": plain_ms, "kernel_only_ms": kernel_only_ms,
          "kernel_only_worst_case_ms": worst_ms,
          "bound_ms": entry["bound_ms"], "build_s": build_s,
          "ptxas": ptxas})
    return entry


def box_iou(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
    ub = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
    return inter / (ua + ub - inter) if ua + ub - inter > 0 else 0.0


def match_image(ref, ours):
    """Greedy one-to-one match of reference detections to ours by IoU > 0.5
    (the rule of the repository's certification scripts)."""
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
    full = (len(pairs) == len(ref["scores"])
            and len(ours.scores) == len(ref["scores"]))
    return pairs, full


def dist(errs) -> dict:
    errs = np.asarray(errs, np.float64)
    return {"n": int(len(errs)), "p50": float(np.percentile(errs, 50)),
            "p99": float(np.percentile(errs, 99)), "max": float(errs.max())}


def phase_parity(flagship, corpus, production):
    from headpose_tpu_torch.ops.kernels import postprocess_kernel

    postprocess_kernel.launches = 0          # the main path's window opens
    per = flagship.detect(corpus["imgs"]).trim()
    res = flagship.detect_single(production["img"])
    launches = postprocess_kernel.launches   # ... and closes
    if launches < 2:
        raise AssertionError(f"detect did not launch the kernel ({launches})")

    agree, pose, box, score = 0, [], [], []
    for i, ours in enumerate(per):
        c = int(corpus["counts"][i])
        ref = {k: corpus[k][i, :c] for k in ("boxes", "scores", "poses")}
        pairs, full = match_image(ref, ours)
        agree += full
        for ri, oi in pairs:
            pose.append(np.abs(ref["poses"][ri] - ours.poses[oi]).max())
            box.append(np.abs(ref["boxes"][ri] - ours.boxes[oi]).max())
            score.append(abs(float(ref["scores"][ri]) - float(ours.scores[oi])))
    n = len(per)
    report = {"phase": "parity", "images": n,
              "reference_detections": int(corpus["counts"].sum()),
              "set_agreement": agree / n, "pose_deg": dist(pose),
              "box_norm": dist(box), "score": dist(score)}
    if agree != n:
        raise AssertionError(f"detection sets differ on {n - agree} images")
    if not (report["pose_deg"]["p99"] < PARITY_BUDGET_DEG
            and report["pose_deg"]["max"] < PARITY_BUDGET_DEG):
        raise AssertionError(f"pose error over budget: {report['pose_deg']}")

    # e2e_production.npz at the tolerances of tests/test_detection.py:280-282
    if len(res) != len(production["scores"]):
        raise AssertionError("e2e_production: detection count differs")
    for k, tol in (("scores", 1e-4), ("boxes", 1e-4), ("poses", 5e-4)):
        err = float(np.abs(getattr(res, k) - production[k]).max())
        report[f"e2e_production_{k}_err"] = err
        if not err <= tol:
            raise AssertionError(f"e2e_production: {k} err {err} > {tol}")
    report["e2e_production_detections"] = len(res)
    report["launches"] = launches
    emit(report)
    return launches


def order_exact(ref_boxes, ref_scores, ours, c, score_tol=1e-3) -> bool:
    """Does `ours` emit the reference's first c detections at the same
    positions (box IoU > 0.5, |score delta| < tol)?"""
    if len(ours.scores) < c:
        return False
    return all(box_iou(ref_boxes[i], ours.boxes[i]) > IOU_MATCH
               and abs(float(ref_scores[i]) - float(ours.scores[i])) < score_tol
               for i in range(c))


def phase_stress(flagship, stress):
    """The boundary-stress corpus: threshold-straddling scores, IoU~0.3 NMS
    clusters, 20-48-face saturation, and >100-survivor overflow — its
    truncation order at the 100-face cap, and its uncapped survivor sets at
    max_faces=256."""
    per = flagship.detect(stress["imgs"]).trim()
    report = {"phase": "stress", "images": len(per)}
    for axis in ("threshold", "nms", "saturation", "overflow"):
        idxs = np.where(stress["axis"] == axis)[0]
        agree, pose = 0, []
        for i in idxs:
            c = int(stress["counts"][i])
            ref = {k: stress[k][i, :c] for k in ("boxes", "scores", "poses")}
            pairs, full = match_image(ref, per[i])
            agree += full
            pose += [np.abs(ref["poses"][r] - per[i].poses[o]).max()
                     for r, o in pairs]
        report[axis] = {"images": len(idxs), "set_agreement": agree / len(idxs),
                        "pose_deg": dist(pose)}
        if agree != len(idxs) or not max(pose) < PARITY_BUDGET_DEG:
            raise AssertionError(f"stress/{axis}: {report[axis]}")
    ov = np.where(stress["axis"] == "overflow")[0]
    order = sum(order_exact(stress["boxes"][i], stress["scores"][i], per[i],
                            int(stress["counts"][i])) for i in ov)
    report["overflow_order_exact"] = f"{order}/{len(ov)}"
    if order != len(ov):
        raise AssertionError(f"stress: truncation order {order}/{len(ov)}")

    saved = flagship.max_faces
    flagship.max_faces = 256
    try:
        unc = flagship.detect(stress["imgs"][stress["ov_idx"]]).trim()
    finally:
        flagship.max_faces = saved
    agree = count = order = 0
    for j, ours in enumerate(unc):
        c = int(stress["ov_counts"][j])
        ref = {"boxes": stress["ov_boxes"][j, :c],
               "scores": stress["ov_scores"][j, :c]}
        agree += match_image(ref, ours)[1]
        count += len(ours) == c
        order += order_exact(ref["boxes"], ref["scores"], ours, c)
    n = len(unc)
    report["uncapped_256"] = {"images": n, "set_agreement": agree / n,
                              "count_match": count, "order_exact": order,
                              "max_survivors": int(stress["ov_counts"].max())}
    if not agree == count == order == n:
        raise AssertionError(f"stress uncapped: {report['uncapped_256']}")
    emit(report)


def phase_best(flagship, corpus):
    from headpose_tpu_torch.pretrained import best_detector

    best = best_detector()
    imgs = corpus["imgs"][:8]
    a, b = best.detect(imgs), flagship.detect(imgs)
    if not torch.equal(a.valid, b.valid):
        raise AssertionError("best_detector: detection sets differ")
    m = b.valid
    box_err = float((a.boxes - b.boxes)[m].abs().max())
    score_err = float((a.scores - b.scores)[m].abs().max())
    if box_err > 1e-6 or score_err > 1e-6:
        raise AssertionError(f"best_detector: boxes {box_err} / scores "
                             f"{score_err} differ from the flagship's")
    emit({"phase": "best", "images": 8, "detections": int(m.sum()),
          "box_err": box_err, "score_err": score_err,
          "pose_diff_max_deg": float((a.poses - b.poses)[m].abs().max())})


def phase_timing(flagship, corpus, card):
    from headpose_tpu_torch.ops.image import preprocess
    from headpose_tpu_torch.ops.kernels import postprocess_kernel

    imgs128 = np.concatenate([corpus["imgs"], corpus["imgs"][:16]])
    out = {"phase": "timing", "card": card, "frames": "128x128 uint8 BGR"}
    for B, reps in ((1, 50), (128, 20)):
        x = imgs128[:B]
        flagship.detect(x)
        torch.cuda.synchronize()
        walls, trims = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            batch = flagship.detect(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            batch.trim()
            t2 = time.perf_counter()
            walls.append((t1 - t0) * 1e3)
            trims.append((t2 - t0) * 1e3)
        med = statistics.median(walls)
        out[f"b{B}"] = {"reps": reps, "detect_ms_median": med,
                        "detect_ms_min": min(walls),
                        "detect_ms_max": max(walls),
                        "frames_per_s": B / med * 1e3,
                        "detect_trim_ms_median": statistics.median(trims)}

    # where the time goes at B=128: CUDA events between the stages
    dev = flagship.device
    x = torch.from_numpy(imgs128).to(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split = {"preprocess": [], "network": [], "postprocess": []}
    with torch.inference_mode():
        for _ in range(20):
            ev[0].record()
            p = preprocess(x, 128, "bgr")
            ev[1].record()
            o = flagship.net(p)
            ev[2].record()
            postprocess_kernel(o["scores"], o["loc"], o["pose_front"],
                               o["pose_back"], flagship.anchors)
            ev[3].record()
            torch.cuda.synchronize()
            for i, k in enumerate(split):
                split[k].append(ev[i].elapsed_time(ev[i + 1]))
    out["b128_stage_ms_median"] = {k: statistics.median(v)
                                   for k, v in split.items()}
    emit(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from headpose_tpu_torch.pretrained import flagship_detector

    card = nvidia_smi()
    dev = torch.device("cuda")
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})

    corpus = dict(np.load(os.path.join(GOLDEN, "parity_corpus.npz")))
    production = dict(np.load(os.path.join(GOLDEN, "e2e_production.npz")))
    flagship = flagship_detector()            # TF32 off from here on

    # the main path's own postprocess inputs: 128 corpus frames
    imgs128 = np.concatenate([corpus["imgs"], corpus["imgs"][:16]])
    from headpose_tpu_torch.ops.image import preprocess
    with torch.inference_mode():
        o = flagship.net(preprocess(torch.from_numpy(imgs128).to(dev)))
    main_inputs = [o["scores"], o["loc"], o["pose_front"], o["pose_back"]]

    entry = phase_kernels(dev, flagship.anchors, main_inputs)
    entry["launches"] = phase_parity(flagship, corpus, production)
    phase_stress(flagship,
                 dict(np.load(os.path.join(GOLDEN, "stress_corpus.npz"))))
    phase_best(flagship, corpus)
    phase_timing(flagship, corpus, card)

    emit({"kernels": [entry]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
