"""The tiled bf16 GEMM on the card: wrapper of csrc/tiled_matmul.cu.

`tiled_matmul(a, b, tile)` is the counterpart of the TPU kernel
scripts/probe_mosaic_matmul.py::make_pallas_matmul: a (M, K) bf16 @ b (K, N)
bf16 -> (M, N) float32, the sum float32, over output tiles of tile =
(bm, bn, bk) with K walked in steps of bk.  A tensor on the CPU goes
through `tiled_matmul_plain`; a tensor on a CUDA device goes through the
hand-written kernel, or the call raises.  Nothing else selects between the
two.  The kernel takes the five tiles of `TILES`; the plain version any
tile that divides the shapes.  Where the JAX grid (M/bm, N/bn, K/bk) would
silently drop a ragged edge, both raise.

The kernel's launch plan is computed here (`plan`) and passed to it as
ints: the stages of its TMA ring, the passes in which it stages C for its
TMA stores, its persistent grid and the group width of its tile order
(`tile_order`, the kernel's map from a CTA's t-th tile to a tile-row and
tile-col).  The launch is the op `headpose_tpu_torch::tiled_matmul`
(ops/kernels/library.py), which counts it.
"""
from __future__ import annotations

import functools

import torch

from ...core.single_pass import fp32_exact
from . import library as lib

__all__ = ["TILES", "tiled_matmul", "tiled_matmul_plain",
           "tiled_matmul_cuda", "LIBRARY", "stage_bytes", "staged_bytes",
           "plan", "tile_order"]

LIBRARY = lib.LIBRARIES["tiled_matmul"]
SOURCE = LIBRARY.sources[0]

# The kernel's template instances: the JAX probe's five block shapes
# (scripts/probe_mosaic_matmul.py:137-138) at bm/4, bn/4 and bk/16, the
# large one halved again (csrc/tiled_matmul.cu says why).
TILES = {"square": (128, 128, 32), "wide_n": (128, 256, 32),
         "narrow_m": (64, 256, 32), "large": (256, 128, 32),
         "deep_k": (128, 128, 128)}

# csrc/tiled_matmul.cu's limits: the dynamic shared memory a CTA may use on
# the H100, the slack that aligns the ring to 1024 bytes, and its stages
SMEM_LIMIT = 232_448
SMEM_ALIGN = 1024
MAX_STAGES = 16
MIN_STAGES = 6          # the ring depth a plan gives up staging room for
                        # (probe_matmul --sweep: wide-N and large 5-7 %
                        # faster at 6 stages in 2 passes than at 4 in 1)
BARRIER_BYTES = 16      # a stage's full and empty mbarriers
C_BOX_BYTES = 64 * 32 * 4   # one staged box of C: 64 rows x 32 floats
GROUP_ROWS = 8          # tile-rows of the tile order's groups


def stage_bytes(tile) -> int:
    """Bytes of one stage of the kernel's ring: A's bm x bk and B's bk x bn
    bf16 slices."""
    bm, bn, bk = (int(v) for v in tile)
    return 2 * bk * (bm + bn)


def staged_bytes(tile, passes: int = 1) -> int:
    """Bytes of the kernel's float32 C tile staged in shared memory for its
    TMA stores, a pass's share of it when it is written in `passes`."""
    bm, bn, _ = (int(v) for v in tile)
    return 4 * bm * bn // passes


def plan(m: int, n: int, k: int, tile, sms: int, passes: int | None = None,
         group: int | None = None) -> dict:
    """The kernel's launch plan for an (m, k) @ (k, n) product at `tile` on
    a card of `sms` SMs: C staged in the fewest passes (1, 2 or 4) that
    leave MIN_STAGES ring stages, or else the most stages; as many stages as
    fit SMEM_LIMIT beside it (at most MAX_STAGES); one persistent CTA an SM
    or a tile, whichever is fewer; GROUP_ROWS tile-rows a group (fewer when
    the grid has fewer).  `passes` and `group` given are taken as they are
    (tools/probe_matmul.py's plan sweep)."""
    bm, bn, _ = (int(v) for v in tile)
    per = stage_bytes(tile) + BARRIER_BYTES

    def stages_at(p):
        return min(MAX_STAGES,
                   (SMEM_LIMIT - SMEM_ALIGN - staged_bytes(tile, p)) // per)

    if passes is None:
        fits = [p for p in (1, 2, 4) if stages_at(p) >= MIN_STAGES]
        passes = fits[0] if fits else max((1, 2, 4), key=stages_at)
    stages = stages_at(passes)
    tiles_m, tiles_n = m // bm, n // bn
    return {"stages": stages, "passes": passes,
            "smem": SMEM_ALIGN + staged_bytes(tile, passes) + stages * per,
            "tiles": tiles_m * tiles_n,
            "grid": min(int(sms), tiles_m * tiles_n),
            "group": min(GROUP_ROWS if group is None else group, tiles_m)}


def tile_order(t: int, tiles_m: int, tiles_n: int,
               group: int) -> tuple[int, int]:
    """The kernel's tile t -> (tile-row, tile-col): `group` tile-rows at a
    time, column by column within a group (csrc/tiled_matmul.cu states the
    same formula)."""
    per = group * tiles_n
    g, r = divmod(t, per)
    rows = min(group, tiles_m - g * group)
    return g * group + r % rows, r // rows


def _check(a: torch.Tensor, b: torch.Tensor, tile) -> tuple[int, int, int]:
    """(M, N, K) of a valid call; raises on anything else."""
    bm, bn, bk = (int(v) for v in tile)
    if min(bm, bn, bk) < 1:
        raise ValueError(f"tile must be three positive ints, got {tile}")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"a and b must be 2-D, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"a and b must be bfloat16, got {a.dtype} and "
                         f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"a is (M, {k}) but b is ({k2}, N)")
    if m % bm or n % bn or k % bk:
        raise ValueError(f"(M, N, K) = ({m}, {n}, {k}) must be multiples of "
                         f"the tile ({bm}, {bn}, {bk}): the JAX grid would "
                         "silently drop the remainder")
    return m, n, k


@torch.no_grad()
def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                       tile) -> torch.Tensor:
    """What the TPU kernel computes, in plain torch: K walked in steps of
    bk, each step's product taken in float32 from the bf16 values (every
    product exact) and added into a float32 accumulator, as `acc_ref`
    does (TF32 off for the products on a CUDA device)."""
    m, n, k = _check(a, b, tile)
    bk = int(tile[2])
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    with fp32_exact():
        for k0 in range(0, k, bk):
            acc += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return acc


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(a: torch.Tensor, b: torch.Tensor, tile, p: dict) -> torch.Tensor:
    """One launch of the kernel at `tile` with the launch plan `p` on
    checked CUDA operands; raises when it fails."""
    return lib.tiled_matmul(a, b, list(tile), [p["stages"], p["passes"],
                                               p["grid"], p["group"]])


@torch.no_grad()
def tiled_matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                      tile) -> torch.Tensor:
    """The kernel: what `tiled_matmul_plain` computes, on a CUDA device, in
    one launch on the current stream without synchronising.  Raises on
    anything the kernel does not take, and when the launch fails."""
    m, n, k = _check(a, b, tile)
    if a.device.type != "cuda":
        raise ValueError(f"a and b must be on a CUDA device, got {a.device}")
    tile = tuple(int(v) for v in tile)
    if tile not in TILES.values():
        raise ValueError(f"the kernel takes the tiles {sorted(TILES.values())}"
                         f", got {tile}")
    return _launch(a, b, tile, plan(m, n, k, tile, _sms(a.device)))


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, tile) -> torch.Tensor:
    """a (M, K) bf16 @ b (K, N) bf16 -> (M, N) float32 over output tiles of
    tile = (bm, bn, bk): the CUDA kernel for tensors on a CUDA device, the
    plain version for tensors on the CPU."""
    if a.device.type == "cpu":
        return tiled_matmul_plain(a, b, tile)
    return tiled_matmul_cuda(a, b, tile)
