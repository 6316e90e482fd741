"""Where a kernel's time goes: each variant is a scratch copy of its CUDA
source with one phase disabled (a loop bound set to 0, a call removed),
built beside the real library and timed on the card.  The variants compute
wrong results; only their device times are read.

    python -m headpose_tpu_torch.tools.kernel_phases backbone
    python -m headpose_tpu_torch.tools.kernel_phases se
    git show 80a87fd:headpose_tpu_torch/csrc/backbone.cu > build/bb_v1.cu
    python -m headpose_tpu_torch.tools.kernel_phases backbone-v1 \\
        --source build/bb_v1.cu

`backbone` and `backbone-v1` (the kernel's first design, one thread per
staged float and per depthwise output) time backbone_forward over 128 random
128x128 frames with the flagship's weights, `se` se_transformer_forward
over 128 random 16x16x88 maps with a seeded SETransformerHead(88).  One
JSON line per variant: the device ms of one call (the sum of its kernels,
torch.profiler over 10 warm calls) and each launch's ms in order; the card
(nvidia-smi) first.  A phase's share is full minus the variant without it;
phases overlap, so the shares need not sum to the whole.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from ..ops.kernels import backbone as kbb
from ..ops.kernels import se_attention as kse
from ..utils.build import BUILD_DIR, NVCC_FLAGS_FMA, CudaLibrary

# per source: variant -> [(text in the source, its replacement)]
VARIANTS = {
    "backbone": {
        "full": [],
        "no_staging": [("for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)",
                        "for (int i = 4 * threadIdx.x; i < 0; i += 4 * kThreads)")],
        "no_depthwise": [("i < n_dw; i += kThreads) {", "i < 0; i += kThreads) {")],
        "no_pointwise": [("i < n_pw; i += kThreads) {", "i < 0; i += kThreads) {"),
                         ("i < n_items; i += kThreads) {", "i < 0; i += kThreads) {")],
    },
    "backbone-v1": {
        "full": [],
        "no_staging": [("i < n_in;", "i < 0;")],
        "no_depthwise": [("i < n_pix * Cin;", "i < 0;")],
        "no_pointwise": [("tile * kPix < n_pix;", "tile * kPix < 0;")],
    },
    "se": {
        "full": [],
        "no_attention": [("    attention<D, H>(xs, px, kv, ring, L, d, row0, rows, img0, n_img);", "")],
        "one_pass_dense": [("        mma_tf32(lo[j], al, bh);\n        mma_tf32(lo[j], ah, bl);\n", "")],
    },
}


def device_ms(fn, reps: int = 10) -> tuple[float, list[float]]:
    """(device ms of one fn(), each launch's ms in order), torch.profiler
    over reps warm calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    per = [(e.time_range.end - e.time_range.start) / 1e3 for e in ev]
    n = len(per) // reps
    last = per[len(per) - n:]
    return sum(per) / reps, last


def _workload(kernel: str, dev: torch.device):
    rng = np.random.default_rng(0)
    if kernel.startswith("backbone"):
        from ..pretrained import flagship_detector

        net = flagship_detector(device=dev).net.backbone
        x = torch.from_numpy(rng.uniform(-1, 1, (128, 128, 128, 3)).astype(
            np.float32)).to(dev)
        return kbb, lambda: kbb.backbone_forward_cuda(net, x)
    from ..models.heads import SETransformerHead, SETransformerHeadNet

    net = SETransformerHeadNet(SETransformerHead(88), device=dev)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.1, tuple(p.shape)).astype(
                np.float32)))
    x = torch.from_numpy(rng.normal(0, 1, (128, 16, 16, 88)).astype(
        np.float32)).to(dev)
    return kse, lambda: kse.se_transformer_forward_cuda(net, x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(VARIANTS))
    ap.add_argument("--source", help="the CUDA source to vary (default: "
                    "this tree's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: no CUDA device is available")
    dev = torch.device("cuda")
    mod, call = _workload(args.kernel, dev)
    src = open(args.source or mod.SOURCE).read()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    scratch = os.path.join(BUILD_DIR, "phases")
    os.makedirs(scratch, exist_ok=True)
    real = mod.LIBRARY
    try:
        for name, subs in VARIANTS[args.kernel].items():
            varied = src
            for old, new in subs:
                if old not in varied:
                    raise SystemExit(f"{args.kernel}/{name}: {old!r} is not "
                                     "in the source")
                varied = varied.replace(old, new)
            path = os.path.join(scratch, f"{args.kernel}-{name}.cu")
            with open(path, "w") as f:
                f.write(varied)
            mod.LIBRARY = CudaLibrary(f"{args.kernel}-{name}", [path],
                                      real._configure, NVCC_FLAGS_FMA)
            with torch.inference_mode():
                ms, grids = device_ms(call)
            print(json.dumps({"kernel": args.kernel, "variant": name,
                              "device_ms": ms, "grid_ms": grids}), flush=True)
    finally:
        mod.LIBRARY = real
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
