"""Speed-of-light accounting of the served network on the card.

The port's counterpart of scripts/flops_accounting.py.  `per_frame_flops`
counts the tensor-core work of one frame through the dense-composed network
(every 3x3 block as one dense conv, as the JAX script counts it) from a
BlazeFace spec: the stem, the 16 blocks, the SSD heads' 1x1s,
the flagship's pose heads' 1x1s and the decode GEMM.  `account` relates it
to the network stage's measured device ms at a batch and to measured GEMM
rates: GFLOP a dispatch, the effective TFLOP/s, and its share of each rate.
"fast" (3-pass split-bf16) counts every pass as tensor-core work, "max"
(single-pass bf16) one.  The table is the dense-composed work the JAX
script counts: the port's "max" network runs its blocks so (the island
kernels, csrc/dense_bf16.cu), but its "fast" network keeps each block's
depthwise in fp32 and runs only the pointwise split-bf16 (csrc/
backbone2.cu), so for "fast" the effective rate is a dense-equivalent
figure, not the work its kernels do.

It holds no measured constant.  The JAX script's MEASURED_MS,
POSTPROCESS_MS and chip_gemm_rates_tflops are TPU figures and carry over
nowhere; here the network ms and the GEMM rates are arguments (chip_smoke.py
passes the turbo phase's B=128 network medians and the matmul probe's
cuBLAS rates of the same run).  No postprocess share is subtracted: the
port times the network stage (runtime/fused.py::fused_network) directly.

    python -m headpose_tpu_torch.tools.flops_accounting \\
        [--network-ms fast=MS max=MS] [--probe REPORT.json ...] [--out PATH]

--network-ms takes the B=128 network stage's ms; --probe the reports that
tools/probe_matmul.py wrote on the card, whose cuBLAS rates are the GEMM
rates.  Without --network-ms it prints the per-frame table alone.  Pure
host arithmetic: it needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..models.blazeface import BLAZEFACE_FRONT, BlazeFace

__all__ = ["BATCH", "PASSES", "conv_flops", "per_frame_flops", "account",
           "main"]

BATCH = 128
PASSES = {"fast": 3, "max": 1}   # tensor-core passes of each product


def conv_flops(cells: int, taps: int, cin: int, cout: int) -> int:
    """MACs * 2 of one dense conv over `cells` output positions."""
    return 2 * cells * taps * cin * cout


def per_frame_flops(spec: BlazeFace) -> dict:
    """The tensor-core FLOPs of one frame, by layer, with the JAX script's
    keys."""
    out = {}
    size = spec.input_size // 2           # the stem is stride 2
    out["stem 5x5/2"] = conv_flops(size * size, 25, 3, spec.stem_features)
    cin = spec.stem_features
    for i, cout in enumerate(spec.block_channels):
        if i in spec.downsample_blocks:
            size //= 2
        out[f"block{i} dense3x3 {cin}->{cout} @{size}"] = conv_flops(
            size * size, 9, cin, cout)
        cin = cout
    c88 = spec.block_channels[spec.tap88_block]
    c96 = spec.block_channels[-1]
    g88 = spec.input_size // 8            # 16x16 for a 128 input
    g96 = spec.input_size // 16
    out["ssd heads 1x1"] = (
        conv_flops(g88 * g88, 1, c88, spec.cls_channels[0]
                   + spec.loc_channels[0])
        + conv_flops(g96 * g96, 1, c96, spec.cls_channels[1]
                     + spec.loc_channels[1]))
    # the flagship's pose heads (stoqa9pt: 88 -> 64 softsign -> 3 on the
    # 16x16 map; hrchr82r: 96 -> 32 -> 16 tanh -> 3 on the 8x8 map), 1x1
    # conv chains over every cell
    out["pose heads 1x1"] = (
        conv_flops(g88 * g88, 1, 88, 64) + conv_flops(g88 * g88, 1, 64, 3)
        + conv_flops(g96 * g96, 1, 96, 32)
        + conv_flops(g96 * g96, 1, 32, 16) + conv_flops(g96 * g96, 1, 16, 3))
    out["decode GEMM (896,16)@(16,16)"] = 2 * 896 * 16 * 16
    return out


def account(spec: BlazeFace, network_ms: dict, gemm_rates: dict,
            batch: int = BATCH) -> dict:
    """GFLOP a dispatch of `batch` frames and the effective TFLOP/s of each
    mode of `network_ms` ({"fast": ms, "max": ms}: the network stage's
    device ms at that batch), beside each rate of `gemm_rates` ({label:
    TFLOP/s}, e.g. the probe's cuBLAS rate by size)."""
    table = per_frame_flops(spec)
    total = sum(table.values())
    modes = []
    for mode, ms in network_ms.items():
        if mode not in PASSES:
            raise ValueError(f"mode must be one of {sorted(PASSES)}, got "
                             f"{mode!r}")
        flops = total * PASSES[mode] * batch
        eff = flops / (float(ms) * 1e-3) / 1e12
        modes.append({"mode": mode, "passes": PASSES[mode],
                      "network_ms": float(ms),
                      "gflops_per_dispatch": flops / 1e9,
                      "effective_tflops": eff,
                      "share_of_gemm_rate": {k: eff / float(v)
                                             for k, v in gemm_rates.items()}})
    return {"batch": batch, "per_frame_flops": table,
            "total_1pass_mflops_per_frame": total / 1e6, "modes": modes,
            "gemm_rates_tflops": {k: float(v) for k, v in gemm_rates.items()},
            "note": "network_ms is the network stage's device time at this "
                    "batch; the dense-composed table, each bf16 pass counted "
                    "as tensor-core work (for 'fast' a dense-equivalent "
                    "figure: its depthwise runs in fp32, undensed)"}


def _pairs(items) -> dict:
    out = {}
    for item in items or ():
        key, _, value = item.partition("=")
        if not value:
            raise SystemExit(f"expected KEY=VALUE, got {item!r}")
        out[key] = float(value)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--network-ms", nargs="*", default=(),
                        help="MODE=MS of the B=128 network stage, for "
                             "modes 'fast' and 'max'")
    parser.add_argument("--probe", nargs="*", default=(),
                        help="reports of tools/probe_matmul.py from the card; "
                             "their cuBLAS rates are the GEMM rates")
    parser.add_argument("--out", default=None,
                        help="also write the JSON document to this path")
    args = parser.parse_args(argv)
    rates = {}
    for path in args.probe:
        with open(path) as f:
            report = json.load(f)
        if "tflops" not in report["library"]:
            raise SystemExit(f"{path} is not a report from the card")
        rates[f"cublas {report['shape'][0]}^3"] = report["library"]["tflops"]
    doc = account(BLAZEFACE_FRONT, _pairs(args.network_ms), rates)
    text = json.dumps(doc, indent=1)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
