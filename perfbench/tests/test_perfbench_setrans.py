"""The SE-Transformer cell (`setrans.fast-b1024-128px`): kernel #5's counts
against chip_smoke.py's, its bound and kernel names, the model's FLOPs,
the two readers it adds, and a run of the harness on the CPU at a tiny
size: sound, it is correct; with an answer altered, an answer given for
another frame, or the control's precision in the program's place, it is
not, under the cell's limits."""
import importlib.util
import json
import os
import time

import pytest
import torch

from perfbench.harness import cells, check, control, metrics, trace
from perfbench.kernels import model, peaks, se_transformer
from perfbench.runners import stream

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKLOAD = "setrans.fast-b1024-128px"
SEED = 2**31 + 2525


def _spec(name="setrans.fast"):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        return json.load(f)["spec"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B", [128, 1024])
def test_work_is_chip_smokes_se_work(B):
    """Operations (three tensor-core passes; fp32) and bytes of both heads
    at the cell's shapes are chip_smoke.py's `se_work` of the same heads."""
    from headpose_tpu_torch.models.heads import SETransformerHead

    smoke = _chip_smoke()
    want = [smoke.se_work(SETransformerHead(88), B, 256),
            smoke.se_work(SETransformerHead(96), B, 64)]
    assert se_transformer.work(_spec(), B) == tuple(
        sum(w[k] for w in want) for k in ("tc", "fp32", "bytes"))


def test_bound_is_the_tensor_core_work_at_the_bf16_peak():
    """At B=1024: 145.7 GFLOP in three passes over 989 TFLOP/s, 0.147 ms,
    above the bytes' (121.8 MB, 0.036 ms) and the fp32 work's; heads of
    another kind count nothing."""
    tc, f32, nbytes = se_transformer.work(_spec(), 1024)
    assert tc / 1e9 == pytest.approx(145.72, abs=0.01)
    assert nbytes / 1e6 == pytest.approx(121.77, abs=0.01)
    assert se_transformer.bound_s(_spec(), 1024) == tc / peaks.BF16_FLOPS
    assert tc / peaks.BF16_FLOPS > max(nbytes / peaks.BYTES_PER_S,
                                       f32 / peaks.FP32_FLOPS)
    assert se_transformer.work(_spec("flagship.fast"), 1024) == (0, 0, 0)


def test_kernel_names():
    for name in ("void (anonymous namespace)::gate_kernel(float const*, "
                 "float const*, float*, (anonymous namespace)::Dims)",
                 "(anonymous namespace)::kv_kernel(float const*)",
                 "void (anonymous namespace)::attend_kernel<16, 4>(float "
                 "const*)"):
        assert se_transformer.matches(name)
    for name in ("void (anonymous namespace)::mlp_head_kernel<64>(float "
                 "const*)", "(anonymous namespace)::chain_kernel(float "
                 "const*)", "void (anonymous namespace)::block_kernel<4, 1>",
                 "(anonymous namespace)::cta_kernel(Params)",
                 "void at::native::vectorized_elementwise_kernel<4>"):
        assert not se_transformer.matches(name)


def test_model_flops_count_the_heads_by_kind():
    """The flagship's network with its two MLP heads replaced by the
    SE-Transformer heads over every cell: 40.0 + 7.4 MFLOP a frame."""
    flagship = _spec("flagship.fast")
    mlp = 2 * (256 * (88 * 64 + 64 * 3) + 64 * (96 * 32 + 32 * 16 + 16 * 3))
    assert model.network_flops(_spec()) == (
        model.network_flops(flagship) - mlp + 40_044_256 + 7_391_488)


def _ctx(kernels, host, batches=2, rows=1024):
    tr = trace.Trace(kernels=kernels, copies=[], host=host, start_us=1000.0,
                     end_us=9000.0)
    return metrics.Context(
        config={"spec": _spec()}, traffic={}, chips=1, trace=tr,
        batches=batches, rows=rows, survivors=0.0, frames_per_s=0.0,
        busy_s=0.0, frame_hw=(128, 128), spans={})


def test_roofline_reader():
    """The bound a batch over the device time of the three grids a
    batch; None where no grid of kernel #5 ran."""
    read = metrics.reader("se_transformer_roofline")
    grids = [("void (anonymous namespace)::attend_kernel<16, 4>(float)",
              2000.0, 3000.0),
             ("(anonymous namespace)::kv_kernel(float)", 3000.0, 3500.0),
             ("(anonymous namespace)::gate_kernel(float)", 3500.0, 4000.0),
             ("void (anonymous namespace)::mlp_head_kernel<64>()", 4000.0,
              8000.0)]
    # 2000 µs of kernel #5 over 2 batches: 1 ms a batch
    want = 100.0 * se_transformer.bound_s(_spec(), 1024) / 1e-3
    assert read(_ctx(grids, [])) == pytest.approx(want)
    assert 0 < want < 100
    assert read(_ctx(grids[3:], [])) is None


def test_heads_span_reader():
    read = metrics.reader("detect.heads_host_ms")
    span = "headpose.detect.heads"
    host = [(span, 1500.0, 2100.0), (span, 5000.0, 6400.0),
            (span, 100.0, 900.0), (span, 8500.0, 9500.0),
            ("headpose.detect.network", 1400.0, 2200.0)]
    assert read(_ctx([], host)) == pytest.approx(1.0)
    assert read(_ctx([], host[2:])) is None


def _cell():
    cell = cells.from_files(WORKLOAD)
    cell.traffic.update(dict(batch=4, ring=2, warmup_batches=1,
                             check_batches=2))
    return cell


def _correct(out, cell):
    return check.verdict(out["readings"], cell.limits["limits"])[0]


def _run(cell):
    return stream.run(cell, SEED, 0.3, False, time.perf_counter(),
                      device="cpu")


@pytest.fixture
def patched(monkeypatch):
    """Wrap the program's pipeline: `patched(f)` makes every slab f(slab)."""
    from headpose_tpu_torch.runtime.detector import FaceDetector

    orig = FaceDetector._pipeline

    def install(fault):
        monkeypatch.setattr(FaceDetector, "_pipeline",
                            lambda self, *a, **k: fault(orig(self, *a, **k)))
    return install


def test_sound_run_is_correct():
    cell = _cell()
    out = _run(cell)
    assert out["readings"]["pairs"] > 0
    assert _correct(out, cell)


@pytest.mark.parametrize("channel,delta", [(16, 0.05), (0, 0.01)])
def test_altered_answer(patched, channel, delta):
    """A pose output moved by 0.05 (the seeded heads' poses are of order
    1), or a box edge by 1 % of the frame."""
    def fault(slab):
        slab[..., channel] += delta
        return slab

    patched(fault)
    cell = _cell()
    assert not _correct(_run(cell), cell)


def test_answer_for_another_frame(patched):
    patched(lambda slab: torch.roll(slab, 1, dims=0))
    cell = _cell()
    assert not _correct(_run(cell), cell)


def test_control_fails():
    """The single-pass bf16 "default" in the program's place."""
    cell = _cell()
    cell.traffic["batch"] = 16
    out, = control.runs(cell, [(SEED, True)], 0.3, device="cpu")
    assert out["readings"]["pairs"] > 0
    assert not _correct(out, cell)
