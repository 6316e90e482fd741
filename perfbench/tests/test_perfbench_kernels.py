"""The kernel and model counts of perfbench/kernels/ reproduce the bounds
of the port's kernel table (PERF.md §6, B=128, NVIDIA H100 peaks): #3
68.5 MB, 13.59 GFLOP on the tensor cores and 1.23 GFLOP fp32 → 0.0204 ms
(the back model 216 MB, 15.8, 1.54 → 0.0646 ms); #4 446 MFLOP, 15.2 MB →
0.0067 ms; #1 0.0028 ms."""
import copy
import json
import os

import pytest

from perfbench.kernels import backbone2, head_mlp, model, peaks, postprocess

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _spec(name):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        return json.load(f)["spec"]


@pytest.mark.parametrize("config,mb,tc_gf,f32_gf,ms", [
    ("flagship.fast", 68.5, 13.59, 1.23, 0.0204),
    ("back256.fast", 216.4, 15.82, 1.54, 0.0646)])
def test_backbone2_bound(config, mb, tc_gf, f32_gf, ms):
    spec = _spec(config)
    tc, f32, nbytes = backbone2.work(spec["backbone"], 128)
    assert nbytes / 1e6 == pytest.approx(mb, abs=0.05)
    assert tc / 1e9 == pytest.approx(tc_gf, abs=0.005)
    assert f32 / 1e9 == pytest.approx(f32_gf, abs=0.005)
    assert backbone2.bound_s(spec, 128) * 1e3 == pytest.approx(ms, abs=5e-5)


def test_backbone2_segments():
    assert backbone2.segments(_spec("flagship.fast")["backbone"]) == (
        (0, 2), (3, 5), (6, 10), (12, 15))
    assert backbone2.segments(_spec("back256.fast")["backbone"]) == (
        (0, 2), (3, 5), (6, 11), (12, 16))


def test_head_mlp_bound():
    ops, nbytes = head_mlp.work(_spec("flagship.fast"), 128)
    assert ops / 1e6 == pytest.approx(446.4, abs=0.05)
    assert nbytes / 1e6 == pytest.approx(15.2, abs=0.05)
    assert head_mlp.bound_s(_spec("flagship.fast"), 128) * 1e3 == \
        pytest.approx(0.0067, abs=5e-5)


def test_flagship_counts_by_head_kind():
    """The model's FLOPs a frame, with each head's by its kind's `flops`,
    and kernel #4's work at B=256, as the counts were before heads named
    their kind; a head of another kind is no work of kernel #4's."""
    spec = _spec("flagship.fast")
    assert model.network_flops(spec) == 64_968_704
    assert head_mlp.work(spec, 256) == (892_829_696, 30_381_464)
    alone = {}
    for other in ("head88", "head96"):
        s = copy.deepcopy(spec)
        s[other]["kind"] = "se_transformer"
        alone[other] = head_mlp.work(s, 256)
    assert (alone["head96"][0] + alone["head88"][0],
            alone["head96"][1] + alone["head88"][1]) == (892_829_696,
                                                         30_381_464)
    assert alone["head96"][0] > 0 and alone["head88"][0] > 0


def test_postprocess_bound_is_its_bytes():
    assert postprocess.bound_s(128, 100, 451) * 1e3 == pytest.approx(
        0.0028, abs=5e-5)
    ops, nbytes = postprocess.work(128, 100, 451)
    assert nbytes / peaks.BYTES_PER_S > ops / peaks.FP32_FLOPS


@pytest.mark.parametrize("config,frame,mflop", [
    ("flagship.fast", (128, 128), 64.97),
    ("back256.fast", (256, 256), 115.69),
    ("flagship.fast", (480, 640), 64.97 + 298.84)])
def test_model_flops_per_frame(config, frame, mflop):
    """The separable network and, for 640x480 frames, the two resize
    products (2·128·480·1920 + 2·128·128·640·3)."""
    got = model.flops_per_frame(_spec(config), frame) / 1e6
    assert got == pytest.approx(mflop, abs=0.01)


def test_kernel_names():
    assert backbone2.matches("void (anonymous namespace)::block_kernel<4, 1>"
                             "(float const*, __nv_bfloat16 const*)")
    assert not backbone2.matches("void (anonymous namespace)::block_kernel"
                                 "<2>(float const*, float const*)")
    assert backbone2.matches("(anonymous namespace)::chain_kernel(float "
                             "const*, float*)")
    assert head_mlp.matches("void (anonymous namespace)::mlp_head_kernel<64>"
                            "(float const*)")
    assert postprocess.matches("(anonymous namespace)::cta_kernel(Params)")
