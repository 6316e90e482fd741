"""Where a kernel's time goes: each variant is a scratch copy of its CUDA
source with one phase disabled (a loop bound set to 0, a call removed),
built beside the real library and timed on the card.  The variants compute
wrong results; only their device times are read.

    python -m headpose_tpu_torch.tools.kernel_phases backbone
    python -m headpose_tpu_torch.tools.kernel_phases backbone2
    python -m headpose_tpu_torch.tools.kernel_phases backbone2 --batch 1
    python -m headpose_tpu_torch.tools.kernel_phases se
    python -m headpose_tpu_torch.tools.kernel_phases head --model best
    python -m headpose_tpu_torch.tools.kernel_phases matmul --size 4096 \\
        --tile wide_n
    git show 80a87fd:headpose_tpu_torch/csrc/backbone.cu > build/bb_v1.cu
    python -m headpose_tpu_torch.tools.kernel_phases backbone-v1 \\
        --source build/bb_v1.cu

`backbone` and `backbone-v1` (the kernel's first design, one thread per
staged float and per depthwise output) time backbone_forward over `--batch`
(default 128) random 128x128 frames with the flagship's weights,
`backbone2` the split-bf16 segments of apply_fused (run_segment over each
segment's own input; the stem and block 11 run once, outside the timing)
for the same frames, `se` se_transformer_forward over `--batch` random
16x16x88 maps with a seeded SETransformerHead(88), `head` the two MLP
heads of a shipped model (`--model flagship` or `best`, the latter
unified-best-distilled's) through mlp_head_forward over the rows of
`--batch` maps (B*256 rows of 88, B*64 of 96, N(0, 1)), `matmul` the
probe's GEMM (csrc/tiled_matmul.cu) at one tile of its TILES (`--tile`,
default wide_n) on tools/probe_matmul.py's seed-0 operands of `--size`
(M = N = K, default 4096).  In `backbone2` each
phase is disabled in both of csrc/backbone2.cu's kernels (block_kernel and
chain_kernel), and the variant `one_launch_per_block` runs every block
through block_kernel (no chain_kernel launch; its results stay right);
in `head`, `four_ctas_per_sm` caps the kernel at 64 registers a thread;
in `matmul`, `no_epilogue` drops the staging and the TMA stores of C,
`no_mma` the wgmma instructions (the TMA ring runs alone) and `no_loads`
the TMA copies (the producer still arrives on each stage's full barrier,
and the consumers multiply whatever the ring holds), and the variant
`direct_store` writes C straight from the registers with the ring as deep
as the budget allows.
One JSON line per variant: the device ms of one call (the sum of its
kernels, torch.profiler over 10 warm calls), each launch's ms in order,
and the ms of one call between two CUDA events (median of 50 warm calls:
launch gaps and host work count); the card (nvidia-smi) first.  A phase's
share is full minus the variant without it; phases overlap, so the shares
need not sum to the whole.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from ..ops.kernels import backbone as kbb
from ..ops.kernels import backbone2 as kb2
from ..ops.kernels import head_mlp as khead
from ..ops.kernels import se_attention as kse
from ..ops.kernels import tiled_matmul as ktm
from ..ops.kernels import library as klib
from ..utils.build import BUILD_DIR, CudaLibrary

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
    "backbone2": {
        "full": [],
        "no_staging": [
            ("i < n; i += 4 * kThreads)", "i < 0; i += 4 * kThreads)"),
            ("i < l.in_rows * row_f; i += kThreads)",
             "i < 0; i += kThreads)"),
            ("i < n_pix * c4n; i += kChainThreads)\n        cp_async16",
             "i < 0; i += kChainThreads)\n        cp_async16")],
        "no_depthwise": [("i < n_dw; i += kThreads) {", "i < 0; i += kThreads) {"),
                         ("i < n_dw; i += kChainThreads) {",
                          "i < 0; i += kChainThreads) {")],
        "no_pointwise": [("mt * 16 < n_pix; mt += kWarps) {",
                          "mt * 16 < 0; mt += kWarps) {"),
                         ("u < mts * ngs; u += kChainWarps) {",
                          "u < 0; u += kChainWarps) {")],
        # not a phase: block_kernel without its cap of 128 registers, so
        # that one CTA fits on an SM (its results stay right)
        "one_cta_per_sm": [("__launch_bounds__(kThreads, 2)\nblock_kernel",
                            "__launch_bounds__(kThreads)\nblock_kernel")],
        # not a phase: no run of small-map blocks chained into one launch
        "one_launch_per_block": [("chain_fits(channels, i, last + 1, H, ci))",
                                  "false)")],
    },
    "se": {
        "full": [],
        "no_attention": [("    attention<D, H>(xs, px, kv, ring, L, d, row0, rows, img0, n_img);", "")],
        "one_pass_dense": [("        mma_tf32(lo[j], al, bh);\n        mma_tf32(lo[j], ah, bl);\n", "")],
    },
    "matmul": {
        "full": [],
        "no_epilogue": [("for (int h = 0; h < 2; ++h) {",
                         "for (int h = 0; h < 0; ++h) {"),
                        ("for (int box = lo; box < lo + per; ++box)",
                         "for (int box = lo; box < lo; ++box)")],
        "no_mma": [("wgmma<T::kWN>(acc[i], da, db, s > 0 || kk > 0);", ";")],
        "no_loads": [("mbar_expect(&full[stage], T::kStageBytes);",
                      "mbar_arrive(&full[stage]);"),
                     ("for (int j = 0; j < BK / 32; ++j)\n            tma_load",
                      "for (int j = 0; j < 0; ++j)\n            tma_load"),
                     ("for (int j = 0; j < BN / 64; ++j)\n            tma_load",
                      "for (int j = 0; j < 0; ++j)\n            tma_load")],
        # not a phase: C stored straight from the registers (float2 a
        # thread, no staging, no TMA store) and the ring as deep as the
        # whole budget allows, as the kernel's first wgmma version did (its
        # results stay right)
        "direct_store": [
            ("const __grid_constant__ CUtensorMap map_c, int m,",
             "const __grid_constant__ CUtensorMap map_c, float* c, int m,"),
            ("map_a, map_b, map_c, m, n, k, stages, passes, group);",
             "map_a, map_b, map_c, c, m, n, k, stages, passes, group);"),
            ("unsigned char* ring = staged + T::kCBytes / passes;",
             "unsigned char* ring = staged;"),
            ("  const long smem = kSmemAlign + T::kCBytes / passes +",
             "  stages = (kSmemLimit - kSmemAlign) / (T::kStageBytes + 16);\n"
             "  if (stages > kMaxStages) stages = kMaxStages;\n"
             "  const long smem = kSmemAlign +"),
            ("cs + (box - lo) * T::kCBox + r * 128 + (q ^ (r % 8)) * 16 +\n"
             "                  8 * (lane % 2)) =",
             "c + static_cast<size_t>(tm * BM + row0 + 64 * i + r) * n +\n"
             "                  tn * BN + col0 + 8 * j + 2 * (lane % 4)) ="),
            ("for (int box = lo; box < lo + per; ++box)",
             "for (int box = lo; box < lo; ++box)")],
    },
    "head": {
        "full": [],
        "no_products": [("step(w, k0 + kk, kk);", ";")],
        "no_weight_staging": [("i < rows * q; i += kThreads) {", "i < 0; i += kThreads) {")],
        "no_activation": [("if (act == kLinear) return;", "return;")],
        "no_row_staging": [("if (i < total && r < rows)", "if (false)")],
        # not a phase: every pass narrow (4 x 4 sums a thread), no wide
        # pass of 4 x 8 (its results stay right)
        "narrow_passes_only": [("const int wide = np / kWide;",
                                "const int wide = 0;")],
        # not a phase: at most 64 registers a thread, four CTAs an SM where
        # the shared memory allows (its results stay right)
        "four_ctas_per_sm": [("__launch_bounds__(kThreads, 2)",
                              "__launch_bounds__(kThreads, 4)")],
    },
}


def device_ms(fn, reps: int = 20) -> tuple[float, list[float]]:
    """(device ms of one fn(), each launch's ms in order), torch.profiler
    over reps warm calls; only calls whose launches it recorded whole count
    (it drops events now and then)."""
    from torch.profiler import ProfilerActivity, profile

    def launches(prof):
        return sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = launches(prof)
    n = round(len(ev) / reps)            # launches a call
    if n == 0:
        raise RuntimeError(f"the profiler recorded {len(ev)} launches of "
                           f"{reps} calls")
    calls = [ev[i:i + n] for i in range(len(ev) - n, -1, -n)]
    names = [e.name for e in calls[0]]
    whole = [c for c in calls if [e.name for e in c] == names]
    per = [sum(c[i].time_range.end - c[i].time_range.start for c in whole)
           / len(whole) / 1e3 for i in range(n)]
    return sum(per), per


def event_ms(fn, reps: int = 50) -> float:
    """Median ms of one warm fn() between two CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _workload(kernel: str, dev: torch.device, batch: int, model: str,
              size: int = 4096, tile: str = "wide_n"):
    rng = np.random.default_rng(0)
    if kernel == "matmul":
        from ..tools.probe_matmul import operands

        a, b = operands(size, dev)
        return ktm, lambda: ktm.tiled_matmul_cuda(a, b, ktm.TILES[tile])
    if kernel == "head":
        from ..pretrained import best_detector, flagship_detector

        net = (best_detector if model == "best" else flagship_detector)(
            device=dev).net
        heads = (net.head88, net.head96)
        rows = [torch.from_numpy(rng.normal(0, 1, (batch * n, c)).astype(
            np.float32)).to(dev) for n, c in ((256, 88), (64, 96))]
        return khead, lambda: [khead.mlp_head_forward_cuda(h, x)
                               for h, x in zip(heads, rows)]
    if kernel.startswith("backbone"):
        from ..pretrained import flagship_detector

        net = flagship_detector(device=dev).net.backbone
        x = torch.from_numpy(rng.uniform(-1, 1, (batch, 128, 128, 3)).astype(
            np.float32)).to(dev)
        if kernel == "backbone2":      # the inputs once, with the real library
            pack = kb2.pack_backbone(net)
            inputs = kb2.segment_inputs(net, x, pack)
            return kb2, lambda: [kb2.run_segment_cuda(net, y, seg, pack)
                                 for seg, y in inputs.items()]
        return kbb, lambda: kbb.backbone_forward_cuda(net, x)
    from ..models.heads import SETransformerHead, SETransformerHeadNet

    net = SETransformerHeadNet(SETransformerHead(88), device=dev)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.1, tuple(p.shape)).astype(
                np.float32)))
    x = torch.from_numpy(rng.normal(0, 1, (batch, 16, 16, 88)).astype(
        np.float32)).to(dev)
    return kse, lambda: kse.se_transformer_forward_cuda(net, x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(VARIANTS))
    ap.add_argument("--source", help="the CUDA source to vary (default: "
                    "this tree's)")
    ap.add_argument("--batch", type=int, default=128,
                    help="frames (maps for `se`) per call (default 128)")
    ap.add_argument("--model", choices=("flagship", "best"),
                    default="flagship", help="the heads of `head`")
    ap.add_argument("--size", type=int, default=4096,
                    help="M = N = K of `matmul` (default 4096)")
    ap.add_argument("--tile", choices=sorted(ktm.TILES), default="wide_n",
                    help="the tile of `matmul` (default wide_n)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: no CUDA device is available")
    dev = torch.device("cuda")
    mod, call = _workload(args.kernel, dev, args.batch, args.model,
                          args.size, args.tile)
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
            klib.LIBRARIES[real.name] = CudaLibrary(
                f"{args.kernel}-{name}", [path], real._configure, real.flags)
            with torch.inference_mode():
                ms, grids = device_ms(call)
                wall = event_ms(call)
            model = ({"model": args.model} if args.kernel == "head" else
                     {"size": args.size, "tile": args.tile}
                     if args.kernel == "matmul" else {})
            print(json.dumps({"kernel": args.kernel, "variant": name,
                              "batch": args.batch, **model, "device_ms": ms,
                              "event_ms": wall, "grid_ms": grids}),
                  flush=True)
    finally:
        klib.LIBRARIES[real.name] = real
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
