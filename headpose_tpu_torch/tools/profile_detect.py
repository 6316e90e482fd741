"""Where the time of FaceDetector.detect (or detect_fused) goes on the card.

Usage:  python -m headpose_tpu_torch.tools.profile_detect [--batch 128]
            [--fused] [--precision highest|fast] [--model NAME]

Runs a shipped model's detect (the flagship unless --model names another,
e.g. unified-best, served at its head_eval="auto" profile; with --fused,
detect_fused: the network through the fused backbone and pose-head kernels;
with --precision fast, the detector's "fast" mode, whose detect runs the
split-bf16 segment backbone through the same kernels) on parity-corpus
frames under
torch.profiler and prints one JSON object: the wall time of the profiled
window, the device's busy time (the union of its kernel intervals) and idle
share, the kernels that take the most device time, grouped by name, and the
last call's device kernels in launch order with their times; then the
postprocess alone (`ops.kernels.postprocess.postprocess_slab` on the
network's outputs for the same frames): its CUDA kernels per call and their
device time.  Needs a CUDA device; it fails without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch


def _busy_us(events) -> float:
    """Length of the union of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--fused", action="store_true",
                        help="profile detect_fused instead of detect")
    parser.add_argument("--precision", default="highest",
                        choices=("highest", "fast"),
                        help="the detector's precision")
    parser.add_argument("--model", default=None,
                        help="a shipped model's name (default: the flagship)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_detect: no CUDA device is available")
    from torch.profiler import ProfilerActivity, profile

    from ..pretrained import FLAGSHIP, PRETRAINED_DIR
    from ..runtime.detector import FaceDetector

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    imgs = np.load(os.path.join(repo, "tests", "golden",
                                "parity_corpus.npz"))["imgs"]
    imgs = np.resize(imgs, (args.batch, *imgs.shape[1:]))
    model = args.model or FLAGSHIP
    det = FaceDetector.from_native(os.path.join(PRETRAINED_DIR, model),
                                   precision=args.precision)
    detect = det.detect_fused if args.fused else det.detect
    for _ in range(3):
        detect(imgs).trim()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            detect(imgs).trim()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels)
    by_name: dict[str, list] = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.end - e.time_range.start
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    kernels.sort(key=lambda e: e.time_range.start)
    last_call = kernels[-(len(kernels) // args.iters):]
    post = _postprocess_launches(det, imgs, args.iters)
    print(json.dumps({
        "path": "detect_fused" if args.fused else "detect",
        "model": model, "head_eval": det.head_eval,
        "precision": args.precision,
        "batch": args.batch, "iters": args.iters,
        "card": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "wall_ms_per_detect": wall_us / args.iters / 1e3,
        "device_busy_ms_per_detect": busy / args.iters / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernels_per_detect": len(kernels) / args.iters,
        "top_kernels": [{"name": n[:120], "ms_per_detect": t / args.iters / 1e3,
                         "calls_per_detect": c / args.iters}
                        for n, (t, c) in top],
        "last_call": [{"name": e.name[:80],
                       "us": e.time_range.end - e.time_range.start}
                      for e in last_call],
        "postprocess": post}))


def _postprocess_launches(det, imgs, iters: int) -> dict:
    """The CUDA kernels one postprocess call launches, and their device ms,
    on the network's outputs for `imgs` (torch.profiler over `iters` warm
    calls)."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops.image import preprocess
    from ..ops.kernels.postprocess import postprocess_slab

    with torch.inference_mode():
        out = det.net(preprocess(torch.from_numpy(imgs).to(det.device),
                                 det.input_size, det.channel_order))

        def call():
            return postprocess_slab(
                out["scores"], out["loc"], out["pose_front"],
                out["pose_back"], det.anchors,
                score_threshold=det.score_threshold,
                iou_threshold=det.iou_threshold, input_size=det.input_size,
                max_faces=det.max_faces)

        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernels_per_call": len(kernels) / iters,
            "device_ms_per_call": sum(e.time_range.end - e.time_range.start
                                      for e in kernels) / iters / 1e3,
            "kernels": sorted({e.name[:80] for e in kernels})}


if __name__ == "__main__":
    main()
