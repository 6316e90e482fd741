"""Measure the hand-written tiled bf16 GEMM against cuBLAS on the card.

The port's counterpart of scripts/probe_mosaic_matmul.py, which measures
the Pallas tiled-accumulator GEMM against XLA's jnp.dot on a TPU (its
figures, docs/mosaic_matmul_probe.json, are the TPU's and not the port's).
This one runs ops/kernels/tiled_matmul.py::tiled_matmul (csrc/
tiled_matmul.cu) at the five tiles of its TILES, the JAX probe's five
block-shape roles, on the JAX probe's operands: np.random.default_rng(0)
normals, (M, K) then (K, N), rounded to bf16, M = N = K = 2048 unless a
multiple of 2048 is given.  `want` is the plain float32 product of the bf16
values (TF32 off).  Each tile reports rel_err = max|got - want| / max|want|
(the JAX probe's formula), the same against the plain version at its tile,
ms a call and TFLOP/s, and the plain version's ms; the report holds the
bound, the larger of 2 M N K / 989 TFLOP/s (bf16 dense, the H100 data
sheet) and the bytes (A and B read once, C written once) / 3.35 TB/s, and
the yardstick, one cuBLAS call on the same operands:
torch.mm(a, b, out_dtype=torch.float32) where this torch has it, else
torch.mm with a bf16 result (the report names the call).

Timing: one warm-up, then CUDA events around `iters` back-to-back launches
on the unchanged operands, max(4, 30 * 2048^3 / N^3) of them as the JAX
probe counts.  The JAX probe chains each call's output into the next call's
operand only because its runtime could elide repeated dispatches with
unchanged inputs.  CUDA elides no launch, and an eager float32 perturbation
pass between calls would add a large fraction of the GEMM's own time at
2048^3, so none is made.  A sleep kernel ahead of the start event holds the
card while the host enqueues the launches: the events time the card's
back-to-back GEMMs, not the host's launch rate.

    python -m headpose_tpu_torch.tools.probe_matmul [N] [--device cpu] \\
        [--out PATH] [--sweep]

Without --device it runs on the card, and raises when there is none.
`--device cpu` is the counterpart of the JAX probe's `interpret` mode: the
plain version at 512^3, two iterations, for plumbing; its times are the
CPU's and are reported as `cpu_ms`.  It prints one JSON report, with the
card's name and power limit as nvidia-smi gives them, and writes it only to
--out.  chip_smoke.py runs `probe` at 2048^3 and 4096^3.

`--sweep` (the card only) prints instead the kernel's launch plans tried at
N^3 (`sweep`): every tile at each count of C's staging passes (1, 2, 4) and
group width (4, 8, 16 tile-rows), ms and TFLOP/s each, beside the plan
ops/kernels/tiled_matmul.py::plan picks; the operands, the timing and the
error are the probe's.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core.single_pass import fp32_exact
from ..ops.kernels import tiled_matmul as ktm
from ..ops.kernels.tiled_matmul import TILES, tiled_matmul, tiled_matmul_plain
from ..utils.device import resolve_device

__all__ = ["SIZE", "CPU_SIZE", "TPU_TILES", "BF16_FLOPS", "BYTES_PER_S",
           "operands", "iterations", "bound", "rel_err", "library_call",
           "probe", "sweep", "main"]

SIZE = 2048                 # the JAX probe's default M = N = K
CPU_SIZE, CPU_ITERS = 512, 2
BF16_FLOPS = 989e12         # H100 SXM, bf16 dense on the tensor cores
BYTES_PER_S = 3.35e12       # H100 SXM, HBM3
SLEEP_CYCLES = 20_000_000   # about 10 ms of a held card ahead of a window

# each tile's role in the JAX probe's sweep (scripts/probe_mosaic_matmul.py
# :137-138), by its TPU block shape
TPU_TILES = {"square": (512, 512, 512), "wide_n": (512, 1024, 512),
             "narrow_m": (256, 1024, 512), "large": (1024, 1024, 512),
             "deep_k": (512, 512, 2048)}


def operands(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX probe's operands at M = N = K = n: default_rng(0) normals,
    (n, n) then (n, n), rounded to bf16, on `device`."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(n, n))
    b = rng.normal(size=(n, n))
    return (torch.from_numpy(a).to(torch.bfloat16).to(device),
            torch.from_numpy(b).to(torch.bfloat16).to(device))


def iterations(n: int) -> int:
    """The JAX probe's iteration count at size n."""
    return max(4, 30 * SIZE ** 3 // n ** 3)


def bound(n: int) -> dict:
    """The least time the card could take for one n^3 product: the larger
    of its operations over the bf16 peak and its bytes over HBM's rate."""
    ops_ms = 2 * n ** 3 / BF16_FLOPS * 1e3
    nbytes = 2 * n * n * 2 + n * n * 4
    bytes_ms = nbytes / BYTES_PER_S * 1e3
    return {"ms": max(ops_ms, bytes_ms), "operations_ms": ops_ms,
            "bytes_ms": bytes_ms, "bytes": nbytes,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|, the JAX probe's formula."""
    return float((got.float() - want).abs().max()
                 / max(1e-9, float(want.abs().max())))


def library_call(a: torch.Tensor, b: torch.Tensor):
    """(fn, name): one PyTorch call of a @ b on the same bf16 operands,
    with a float32 result where this torch and device have it."""
    try:
        torch.mm(a[:16, :16], b[:16, :16], out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda: torch.mm(a, b),
                "torch.mm(a, b) (bf16 result: no out_dtype here)")
    return (lambda: torch.mm(a, b, out_dtype=torch.float32),
            "torch.mm(a, b, out_dtype=torch.float32)")


def _ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms of fn() over iters back-to-back calls after one warm-up:
    CUDA events on the card (behind a sleep kernel), the host clock on the
    CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def _card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"type": "cpu"}
    from .certify_modes import card

    return {"type": "cuda", "name": torch.cuda.get_device_name(device),
            "nvidia_smi": card(), "torch": torch.__version__,
            "cuda": torch.version.cuda}


@torch.no_grad()
def probe(n: int = SIZE, iters: int | None = None, device=None) -> dict:
    """The report of one size: every tile of TILES and the library call on
    the n^3 operands.  Each tile's output is held against `want` (`rel_err`)
    and against `tiled_matmul_plain` at that tile (`rel_err_vs_plain`,
    `max_abs_err_vs_plain`: the same output, no extra launch), and the plain
    version is timed once.  On the card each tile launches its kernel
    2 + iters times."""
    device = resolve_device(device)
    iters = iterations(n) if iters is None else int(iters)
    key = "ms" if device.type == "cuda" else "cpu_ms"
    rate = "tflops" if device.type == "cuda" else "cpu_tflops"
    flops = 2 * n ** 3
    a, b = operands(n, device)
    with fp32_exact():
        want = a.float() @ b.float()
    report = {"shape": [n, n, n], "dtype": "bf16 in, f32 out",
              "iters": iters, "device": _card(device), "bound": bound(n),
              "tiles": {}}
    for name, tile in TILES.items():
        got = tiled_matmul(a, b, tile)
        row = {"tile": list(tile), "tpu_tile": list(TPU_TILES[name]),
               "rel_err": rel_err(got, want)}
        ref = tiled_matmul_plain(a, b, tile)
        row["rel_err_vs_plain"] = rel_err(got, ref)
        row["max_abs_err_vs_plain"] = float((got - ref).abs().max())
        del got, ref
        row[f"plain_{key}"] = _ms(lambda: tiled_matmul_plain(a, b, tile), 1,
                                  device)
        row[key] = _ms(lambda: tiled_matmul(a, b, tile), iters, device)
        row[rate] = flops / (row[key] * 1e-3) / 1e12
        report["tiles"][name] = row
    fn, call = library_call(a, b)
    lib_ms = _ms(fn, iters, device)
    report["library"] = {"call": call, "rel_err": rel_err(fn(), want),
                         key: lib_ms, rate: flops / (lib_ms * 1e-3) / 1e12}
    return report


@torch.no_grad()
def sweep(n: int = SIZE) -> dict:
    """The kernel's launch plans at n^3 on the card: for every tile, each
    count of C's staging passes (1, 2, 4) and group width (4, 8, 16), the
    plan's stages, ms a call (over max(20, iterations(n)) calls), TFLOP/s
    and rel_err against the plain float32 product; `plan` is the plan the
    wrapper picks."""
    device = resolve_device(None)
    iters = max(20, iterations(n))
    a, b = operands(n, device)
    with fp32_exact():
        want = a.float() @ b.float()
    sms = ktm._sms(device)
    out = {"shape": [n, n, n], "iters": iters, "device": _card(device),
           "tiles": {}}
    for name, tile in TILES.items():
        rows = []
        for passes in (1, 2, 4):
            for group in (4, 8, 16):
                plan = ktm.plan(n, n, n, tile, sms, passes, group)
                if plan["stages"] < 2:
                    continue
                err = rel_err(ktm._launch(a, b, tile, plan), want)
                ms = _ms(lambda: ktm._launch(a, b, tile, plan), iters,
                         device)
                rows.append({"passes": passes, "group": plan["group"],
                             "stages": plan["stages"], "ms": ms,
                             "tflops": 2 * n ** 3 / (ms * 1e-3) / 1e12,
                             "rel_err": err})
        out["tiles"][name] = {"plan": ktm.plan(n, n, n, tile, sms),
                              "tried": rows}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("size", nargs="?", type=int, default=None,
                        help="M = N = K, a multiple of 2048 (default 2048; "
                             "512 with --device cpu)")
    parser.add_argument("--device", default=None,
                        help="'cpu' for the plain version (default: the "
                             "card, which must be present)")
    parser.add_argument("--out", default=None,
                        help="also write the JSON report to this path")
    parser.add_argument("--sweep", action="store_true",
                        help="report the kernel's launch plans tried at "
                             "N^3 instead (the card only)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cpu":
        n, iters = args.size or CPU_SIZE, CPU_ITERS
    else:
        n = args.size or SIZE
        if n % SIZE:
            raise SystemExit(f"size {n} must be a multiple of {SIZE}")
        iters = iterations(n)
    if args.sweep and device.type != "cuda":
        raise SystemExit("--sweep times the kernel: the card only")
    report = sweep(n) if args.sweep else probe(n, iters, device)
    text = json.dumps(report, indent=1)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
