"""The matmul probe's port against the JAX probe on the CPU.

scripts/probe_mosaic_matmul.py::make_pallas_matmul (the Pallas tiled-
accumulator GEMM, in interpret mode at 512^3, as the script's own
`interpret` argument runs it) against ops/kernels/tiled_matmul.py::
tiled_matmul_plain at the same (bm, bn, bk), on the same seed-0 bf16
operands, within 1e-6 of max |want| (both sum exact float32 products in
float32, K step by K step); the wrapper's refusals; tools/probe_matmul.py
at --device cpu; tools/flops_accounting.py against
scripts/flops_accounting.py's table.  The kernel itself runs on the card
only (tests/test_torch_gpu.py::test_tiled_matmul_kernel_matches_plain,
chip_smoke.py).
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headpose_tpu_torch.models import BLAZEFACE_FRONT
from headpose_tpu_torch.ops.kernels import library
from headpose_tpu_torch.ops.kernels import tiled_matmul as ktm
from headpose_tpu_torch.tools import flops_accounting, probe_matmul

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 512
TOL_FRAC = 1e-6


def _script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX probe at 512^3 (its interpret size) with its operands and
    XLA's float32 product of them."""
    mod = _script("probe_mosaic_matmul")
    mod.set_size(N, 2)
    rng = np.random.default_rng(0)                  # the script's :122-126
    a = jnp.asarray(rng.normal(size=(N, N)), jnp.bfloat16)
    b = jnp.asarray(rng.normal(size=(N, N)), jnp.bfloat16)
    want = np.asarray(jnp.dot(a, b, preferred_element_type=jnp.float32))
    return mod, a, b, want


def _torch(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def test_operands_are_the_jax_probes(jax_probe):
    _, a, b, _ = jax_probe
    ta, tb = probe_matmul.operands(N, "cpu")
    assert torch.equal(ta, _torch(a)) and torch.equal(tb, _torch(b))


@pytest.mark.parametrize("block", [(256, 256, 128), (128, 512, 256),
                                   (512, 512, 512)])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(jax_probe, block):
    mod, a, b, want = jax_probe
    got_jax = np.asarray(jax.jit(mod.make_pallas_matmul(*block,
                                                        interpret=True))(a, b))
    got = ktm.tiled_matmul_plain(_torch(a), _torch(b), block).numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - got_jax).max()) <= TOL_FRAC * scale
    assert float(np.abs(got - want).max()) <= TOL_FRAC * scale


@pytest.mark.parametrize("tile", sorted(ktm.TILES))
def test_wrapper_on_the_cpu_is_the_plain_version(tile):
    a, b = probe_matmul.operands(N, "cpu")
    before = library.launches()["tiled_matmul"]
    got = ktm.tiled_matmul(a, b, ktm.TILES[tile])
    assert torch.equal(got, ktm.tiled_matmul_plain(a, b, ktm.TILES[tile]))
    assert got.dtype == torch.float32 and got.shape == (N, N)
    assert library.launches()["tiled_matmul"] == before   # none on the CPU


def _bad(case):
    a, b = probe_matmul.operands(256, "cpu")
    if case == "float32_operand":
        return a.float(), b, "bfloat16"
    if case == "m_not_a_multiple":
        return a[:200], b, "multiples"
    if case == "k_not_a_multiple":
        return a[:, :240].contiguous(), b[:240], "multiples"
    if case == "not_contiguous":
        return a.t(), b, "contiguous"
    if case == "one_dimensional":
        return a[0], b, "2-D"
    return a, b[:128], "b is"                          # inner sizes differ


@pytest.mark.parametrize("case", ["float32_operand", "m_not_a_multiple",
                                  "k_not_a_multiple", "not_contiguous",
                                  "one_dimensional", "inner_mismatch"])
def test_wrapper_raises_on_what_it_does_not_take(case):
    a, b, match = _bad(case)
    with pytest.raises(ValueError, match=match):
        ktm.tiled_matmul(a, b, (64, 128, 32))


def test_cuda_path_refuses_cpu_tensors():
    a, b = probe_matmul.operands(256, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ktm.tiled_matmul_cuda(a, b, ktm.TILES["square"])


def test_tiles_and_kernel_table():
    assert ktm.TILES == {"square": (128, 128, 32), "wide_n": (128, 256, 32),
                         "narrow_m": (64, 256, 32), "large": (256, 128, 32),
                         "deep_k": (128, 128, 128)}
    # the JAX probe's block shapes, each role at bm/4, bn/4, bk/16 (the
    # large one's N halved again)
    for name, (bm, bn, bk) in ktm.TILES.items():
        tm, tn, tk = probe_matmul.TPU_TILES[name]
        assert (tm // bm, tk // bk) == (4, 16)
        assert tn // bn == (8 if name == "large" else 4)
    assert "tiled_matmul" in library.launches()
    assert 2048 % max(t[0] for t in ktm.TILES.values()) == 0


def test_probe_cli_on_the_cpu(tmp_path, capsys):
    official = os.path.join(REPO, "docs", "mosaic_matmul_probe.json")
    stamp = os.stat(official).st_mtime_ns
    out = tmp_path / "probe.json"
    assert probe_matmul.main(["--device", "cpu", "--out", str(out)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report == json.loads(out.read_text())
    assert report["shape"] == [N, N, N] and report["iters"] == 2
    assert report["device"] == {"type": "cpu"}
    assert set(report["tiles"]) == set(ktm.TILES)
    for row in report["tiles"].values():
        assert row["rel_err"] <= TOL_FRAC
        assert row["rel_err_vs_plain"] == 0.0           # the plain version
        assert row["cpu_ms"] > 0 and "ms" not in row    # no device metric
    assert report["library"]["call"].startswith("torch.mm")
    assert os.stat(official).st_mtime_ns == stamp


def test_probe_iterations_and_bound():
    assert [probe_matmul.iterations(n) for n in (2048, 4096, 8192)] == [
        30, 4, 4]
    b = probe_matmul.bound(2048)
    assert b["bytes"] == 2048 * 2048 * 8 and b["bound_by"] == "operations"
    assert abs(b["ms"] - 2 * 2048 ** 3 / 989e12 * 1e3) < 1e-12
    assert round(probe_matmul.bound(4096)["ms"], 3) == 0.139
    assert round(probe_matmul.bound(8192)["ms"], 3) == 1.112


def test_probe_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_matmul.main([])


def test_plan_sweep_refuses_the_cpu():
    with pytest.raises(SystemExit, match="card only"):
        probe_matmul.main(["--device", "cpu", "--sweep"])


def test_probe_on_the_card_refuses_a_size_the_tiles_do_not_divide(
        monkeypatch):
    monkeypatch.setattr(probe_matmul, "resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(SystemExit, match="multiple of 2048"):
        probe_matmul.main(["3000"])


@pytest.fixture(scope="module")
def jax_accounting(tmp_path_factory):
    mod = _script("flops_accounting")
    mod.OUT = str(tmp_path_factory.mktemp("sol") / "sol_accounting.json")
    mod.main()
    with open(mod.OUT) as f:
        return json.load(f)


def test_per_frame_flops_is_the_jax_scripts_table(jax_accounting):
    assert flops_accounting.per_frame_flops(BLAZEFACE_FRONT) == \
        jax_accounting["per_frame_flops"]


def test_account_is_the_jax_arithmetic_without_a_postprocess(
        jax_accounting):
    """The JAX script's rows with its own forward ms given as the network
    ms: the same GFLOP a dispatch and TFLOP/s (it rounds to 0.1)."""
    rows = {r["mode"].split()[0]: r for r in jax_accounting["modes"]}
    doc = flops_accounting.account(
        BLAZEFACE_FRONT, {m: r["forward_ms"] for m, r in rows.items()},
        {"2048^3": 500.0})
    assert round(doc["total_1pass_mflops_per_frame"], 1) == \
        jax_accounting["total_1pass_mflops_per_frame"]
    for got in doc["modes"]:
        want = rows[got["mode"]]
        assert round(got["gflops_per_dispatch"], 1) == \
            want["gflops_per_dispatch"]
        assert round(got["effective_tflops"], 1) == want["effective_tflops"]
        assert got["share_of_gemm_rate"]["2048^3"] == pytest.approx(
            got["effective_tflops"] / 500.0)
    assert [m["passes"] for m in doc["modes"]] == [3, 1]


def test_account_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        flops_accounting.account(BLAZEFACE_FRONT, {"turbo": 1.0}, {})


def test_accounting_cli_reads_probe_reports(tmp_path, capsys):
    report = tmp_path / "probe.json"
    report.write_text(json.dumps({"shape": [4096] * 3,
                                  "library": {"tflops": 640.0}}))
    assert flops_accounting.main(["--network-ms", "fast=1.0", "max=0.5",
                                  "--probe", str(report)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["gemm_rates_tflops"] == {"cublas 4096^3": 640.0}
    fast, mx = doc["modes"]
    assert fast["gflops_per_dispatch"] == pytest.approx(
        3 * 128 * doc["total_1pass_mflops_per_frame"] / 1e3)
    assert mx["effective_tflops"] == pytest.approx(
        mx["gflops_per_dispatch"] / 0.5)
    cpu = tmp_path / "cpu.json"
    cpu.write_text(json.dumps({"shape": [512] * 3,
                               "library": {"cpu_tflops": 0.1}}))
    with pytest.raises(SystemExit, match="not a report from the card"):
        flops_accounting.main(["--probe", str(cpu)])


# ------------------------------------------- the kernel's launch plan (CPU)
STAGE_KB = {"square": 16, "wide_n": 24, "narrow_m": 20, "large": 24,
            "deep_k": 64}


@pytest.mark.parametrize("tile", sorted(ktm.TILES))
def test_launch_plan_fits_shared_memory(tile):
    """A pass's share of the staged C tile and the ring's stages and their
    barriers fit the 232,448 bytes a CTA may use, at least 3 stages (2 for
    deep-K's 64 KB ones), as many as fit; C in the fewest passes that leave
    MIN_STAGES, else in those that leave the most, each pass whole boxes of
    a consumer's half (64 x 32 floats)."""
    t = ktm.TILES[tile]
    assert ktm.stage_bytes(t) == STAGE_KB[tile] * 1024
    p = ktm.plan(4096, 4096, 4096, t, 132)
    per = ktm.stage_bytes(t) + ktm.BARRIER_BYTES
    assert ktm.staged_bytes(t) == 4 * t[0] * t[1]
    assert p["smem"] == ktm.SMEM_ALIGN + ktm.staged_bytes(t, p["passes"]) + \
        p["stages"] * per
    assert p["smem"] <= ktm.SMEM_LIMIT == 232_448
    assert p["stages"] >= (2 if tile == "deep_k" else 3)
    assert p["stages"] <= ktm.MAX_STAGES
    assert p["stages"] == ktm.MAX_STAGES or p["smem"] + per > ktm.SMEM_LIMIT
    boxes = ktm.staged_bytes(t) // 2 // ktm.C_BOX_BYTES
    assert boxes % p["passes"] == 0
    fewer = [ktm.plan(4096, 4096, 4096, t, 132, passes=q)["stages"]
             for q in (1, 2, 4) if q < p["passes"]]
    assert all(s < min(ktm.MIN_STAGES, p["stages"]) for s in fewer)
    assert (tile, p["passes"], p["stages"]) in {
        ("square", 1, 10), ("wide_n", 2, 6), ("narrow_m", 1, 8),
        ("large", 2, 6), ("deep_k", 2, 3)}


@pytest.mark.parametrize("tile", sorted(ktm.TILES))
def test_launch_plan_grid_is_one_cta_an_sm_or_a_tile(tile):
    bm, bn, _ = ktm.TILES[tile]
    p = ktm.plan(4096, 4096, 4096, ktm.TILES[tile], 132)
    assert p["tiles"] == (4096 // bm) * (4096 // bn) > 132
    assert p["grid"] == 132
    p = ktm.plan(768, 1280, 384, ktm.TILES[tile], 132)
    assert p["tiles"] == (768 // bm) * (1280 // bn) < 132
    assert p["grid"] == p["tiles"]
    assert p["group"] == min(ktm.GROUP_ROWS, 768 // bm)


@pytest.mark.parametrize("tiles_m, tiles_n", [(16, 16), (32, 8), (8, 16),
                                              (3, 5), (1, 1)])
@pytest.mark.parametrize("group", [1, 3, 8])
def test_tile_order_is_a_bijection(tiles_m, tiles_n, group):
    """Every tile once, whether or not the group width divides the
    tile-rows; within a group the tile-row varies fastest."""
    group = min(group, tiles_m)
    seen = [ktm.tile_order(t, tiles_m, tiles_n, group)
            for t in range(tiles_m * tiles_n)]
    assert sorted(seen) == [(i, j) for i in range(tiles_m)
                            for j in range(tiles_n)]
    rows = min(group, tiles_m)
    assert seen[:rows] == [(i, 0) for i in range(rows)]


def test_kernel_source_states_the_tile_order_and_uses_wgmma():
    """csrc/tiled_matmul.cu states tile_order's formula and is built from
    wgmma fed by TMA through mbarriers, with no mma.sync left."""
    with open(ktm.SOURCE) as f:
        src = f.read()
    assert "tile-row = g * G + r % rows,   tile-col = r / rows" in src
    assert "tm = g * group + r % rows;" in src and "tn = r / rows;" in src
    for needed in ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16",
                   "cp.async.bulk.tensor.2d.shared::cluster.global",
                   "cp.async.bulk.tensor.2d.global.shared::cta",
                   "mbarrier.try_wait.parity",
                   "setmaxnreg.dec", "setmaxnreg.inc",
                   "__launch_bounds__(kThreads, 1)", "cuTensorMapEncodeTiled"):
        assert needed in src, needed
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for gone in ("mma.sync", "ldmatrix", "cp.async.cg"):
        assert gone not in code, gone


def test_entry_point_takes_the_plan():
    """headpose_tiled_matmul's ctypes signature: three pointers, M, N, K,
    the tile and the plan (stages, passes, grid, group) as ints, the
    stream."""
    import ctypes

    class Fake:
        headpose_tiled_matmul = type("Fn", (), {})()

    lib = Fake()
    ktm.LIBRARY._configure(lib)
    fn = lib.headpose_tiled_matmul
    assert fn.argtypes == [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
