"""The SE-Transformer model as the benchmark runs it (perfbench/configs/
setrans.fast.json): the seeded model directory that
headpose_tpu_torch/tools/seed_se_model.py writes, the benchmark's plain
reference head (perfbench/reference/heads/se_transformer.py) against the
port's module and kernel arithmetic, the model through FaceDetector at
"fast" under the "map" profile against the benchmark's reference, held to
the cell's limits, and the precision kernel #5 needs.  CPU tests, seeded;
the tests marked `gpu` run kernel #5 on the card at the cell's batch:

    python -m pytest tests/test_torch_setrans.py -m gpu --noconftest
"""
import ast
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from headpose_tpu_torch.models.heads import (SETransformerHead,
                                             SETransformerHeadNet)
from headpose_tpu_torch.models.params import (flatten_params, load_native,
                                              params_from_jax,
                                              unflatten_params)
from headpose_tpu_torch.ops.kernels import library
from headpose_tpu_torch.ops.kernels import se_attention as kse
from headpose_tpu_torch.ops.kernels.tf32 import split_tf32
from headpose_tpu_torch.runtime.detector import FaceDetector
from headpose_tpu_torch.tools import seed_se_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench.harness import cells, check  # noqa: E402
from perfbench.reference.detector import Reference, tf32_mode  # noqa: E402
from perfbench.reference.model import head_kind  # noqa: E402

WORKLOAD = "setrans.fast-b1024-128px"
MODEL = os.path.join(REPO, "perfbench", "models", "unified-se-seeded")
REFERENCE_HEAD = os.path.join(REPO, "perfbench", "reference", "heads",
                              "se_transformer.py")
# the reference head against the port: both fp32, the same function in
# another order of operations; the rounding that differs is amplified by
# the softmax and two LayerNorms (measured at most 1.7e-6 on outputs up to
# 3.6, 0.17 of this tolerance)
REFERENCE_TOL = dict(rtol=1e-5, atol=1e-5)
# kernel #5 against its plain version (tests/test_pallas.py:52, chip_smoke.py
# SE_TOL): what three TF32 passes keep of fp32 through the softmax and two
# LayerNorms, and what one pass does not
KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(in_features=24, reduction=4, num_heads=2, key_dim=8, ff_dim=32,
             hidden=16)


@pytest.fixture(scope="module")
def cell():
    return cells.from_files(WORKLOAD)


@pytest.fixture(scope="module")
def corpus(cell):
    from perfbench.harness import frames
    return frames.corpus(cell.traffic)


def _seeded(fields: dict, seed: int):
    """(spec, flat JAX-layout params) of a head, seeded as the tool seeds
    the model's heads."""
    spec = SETransformerHead(**fields)
    return spec, flatten_params(seed_se_model.seeded_head(spec, seed))


def _net(spec, flat) -> SETransformerHeadNet:
    net = SETransformerHeadNet(spec, device="cpu")
    net.load_state_dict(params_from_jax(spec, unflatten_params(flat)))
    return net


def _reference_head(spec, flat, prefix=""):
    head_spec = dict(dataclasses.asdict(spec), kind="se_transformer")
    return head_kind("se_transformer").build(head_spec, flat, prefix, "cpu")


def _model_heads():
    """The committed model's two heads: {88: (spec, flat params), 96:
    ...}."""
    spec, params = load_native(MODEL)
    flat = flatten_params(params)
    out = {}
    for name, c in (("head88", 88), ("head96", 96)):
        head = {k[len(name) + 1:]: v for k, v in flat.items()
                if k.startswith(name + "/")}
        out[c] = (getattr(spec, name), head)
    return out


@pytest.fixture(scope="module")
def model_taps(corpus):
    """The committed model's fp32 taps on 2 corpus frames: {88: (2, 16, 16,
    88), 96: (2, 8, 8, 96)}."""
    from headpose_tpu_torch.ops.image import preprocess

    det = FaceDetector.from_native(MODEL, device="cpu")
    with torch.no_grad():
        out = det.net(preprocess(torch.from_numpy(corpus[:2])))
    return {88: out["feat88"], 96: out["feat96"]}


@pytest.mark.parametrize("fields,shape", [
    (SMALL, (3, 4, 4, 24)), (SMALL, (3, 2, 2, 24)),
    (dict(in_features=88), (2, 16, 16, 88))],
    ids=["small_4x4", "small_2x2", "published_16x16"])
def test_reference_head_matches_the_port(fields, shape):
    """The benchmark's plain head against SETransformerHeadNet and against
    kernel #5's plain version, on seeded weights and non-negative maps (the
    taps follow a ReLU)."""
    spec, flat = _seeded(fields, len(shape) + shape[1])
    net = _net(spec, flat)
    x = torch.from_numpy(np.abs(np.random.default_rng(shape[1]).normal(
        0, 1, shape)).astype(np.float32))
    with torch.no_grad():
        want = _reference_head(spec, flat)(x)
        module = net(x)
    plain = kse.se_transformer_forward_plain(net, x)
    assert want.shape == (*shape[:3], 3)
    torch.testing.assert_close(module, want, **REFERENCE_TOL)
    torch.testing.assert_close(plain, want, **REFERENCE_TOL)


def test_reference_flops_are_the_models_products():
    """A multiply-add 2: 40.0 MFLOP over the 16x16 map of 88 channels, 7.4
    over the 8x8 map of 96, at the published fields."""
    kind = head_kind("se_transformer")
    head = dict(kind="se_transformer", reduction=16, num_heads=4,
                key_dim=16, ff_dim=64, hidden=128, out_features=3)
    assert kind.flops(dict(head, in_features=88), 256) == 40_044_256
    assert kind.flops(dict(head, in_features=96), 64) == 7_391_488
    assert kind.COUPLES_CELLS


def test_reference_head_imports_nothing_of_either_package():
    tree = ast.parse(open(REFERENCE_HEAD).read(), REFERENCE_HEAD)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert names and set(n.split(".")[0] for n in names) <= {
        "__future__", "numpy", "torch"}


def test_the_tool_rewrites_the_committed_model(tmp_path):
    """seed_se_model writes the committed spec and, leaf for leaf, bitwise
    the committed params; the backbone is the flagship's unchanged."""
    from headpose_tpu_torch.pretrained import FLAGSHIP, load_pretrained

    seed_se_model.main([str(tmp_path)])
    with open(os.path.join(MODEL, "spec.json")) as f:
        want_doc = json.load(f)
    with open(tmp_path / "spec.json") as f:
        assert json.load(f) == want_doc
    assert want_doc["metadata"]["quality"] == "seeded, untrained"
    got = np.load(tmp_path / "params.npz")
    want = np.load(os.path.join(MODEL, "params.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    flagship = flatten_params(load_pretrained(FLAGSHIP)[1]["backbone"])
    for k, v in flagship.items():
        np.testing.assert_array_equal(want["backbone/" + k], v)
    spec, _ = load_native(MODEL)
    assert spec.head88 == SETransformerHead(88)
    assert spec.head96 == SETransformerHead(96)
    for c in (88, 96):                 # biases and LayerNorm offsets moved
        assert np.abs(want[f"head{c}/ln2/b"]).min() > 0


def test_the_configuration_states_the_models_spec(cell):
    """The configuration's spec, which the reference and the counts read,
    is the committed model's, which the program reads."""
    spec, _ = load_native(MODEL)
    cfg = cell.config["spec"]
    for name in ("head88", "head96"):
        head = dict(cfg[name])
        assert head.pop("kind") == "se_transformer"
        assert head == dataclasses.asdict(getattr(spec, name))
    bb = dataclasses.asdict(spec.backbone)
    for key, value in cfg["backbone"].items():
        want = bb[key]
        assert (list(want) if isinstance(want, tuple) else want) == value
    assert cell.config["detector"] == {"head_eval": "map"}
    assert os.path.dirname(os.path.join(REPO, cell.config["weights"])) == \
        MODEL


def test_the_detector_meets_the_cells_limits(cell, corpus):
    """FaceDetector at "fast" under "map" on the seeded model, the program
    the cell runs (the kernels' plain versions here), against the
    benchmark's reference on 4 parity frames, held to the cell's limits
    by the comparison that decides `correct`."""
    cfg = cell.config
    det = FaceDetector.from_native(
        MODEL, precision="fast", head_eval="map", device="cpu",
        score_threshold=cfg["score_threshold"],
        iou_threshold=cfg["iou_threshold"], max_faces=cfg["max_faces"])
    frames = corpus[:4]
    got = det.detect(frames).trim()
    want = Reference(cfg, os.path.join(REPO, cfg["weights"])).detect(frames)
    readings = check.compare([got], [want], cfg, cell.limits["margins"])
    assert readings["pairs"] >= 4
    correct, shown = check.verdict(readings, cell.limits["limits"])
    assert correct, shown


def _tf32_one_pass(a, b):
    """a @ b as one TF32 pass: the leading term hi.hi of matmul_3xtf32."""
    return split_tf32(a)[0] @ split_tf32(b)[0]


@pytest.mark.parametrize("c", [88, 96])
def test_one_tf32_pass_misses_the_kernels_tolerance(model_taps, c):
    """Why kernel #5 takes three TF32 passes: on the committed model's heads
    over its own taps, at the published widths, three passes lie within
    the kernel's tolerance of fp32 and one pass beyond it."""
    spec, flat = _model_heads()[c]
    net = _net(spec, flat)
    x = model_taps[c]
    want = kse.se_transformer_forward_plain(net, x)

    def ratio(mm):
        with torch.no_grad():
            got = kse._forward(net, x, mm)
        return float(((got - want).abs() / (
            KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * want.abs())).max())

    assert ratio(kse.matmul_3xtf32) <= 0.5
    assert ratio(_tf32_one_pass) > 1.0


def test_the_heads_span_nests_in_the_network(corpus):
    """At "fast" the fused network's `detect.heads` span holds both heads'
    calls, inside `detect.network`."""
    from torch.profiler import ProfilerActivity, profile

    det = FaceDetector.from_native(MODEL, precision="fast", head_eval="map",
                                   device="cpu")
    det.detect(corpus[:1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        det.detect(corpus[:1])
    spans = {e.name: (e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("headpose.")}
    outer, inner = spans["headpose.detect.network"], spans[
        "headpose.detect.heads"]
    assert outer[0] <= inner[0] <= inner[1] <= outer[1]


# ------------------------------------------------------------- on the card
@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_at_the_cells_batch_against_the_reference_head(cuda, cell,
                                                              corpus):
    """Kernel #5 over B=1024 maps of the seeded model's taps (corpus frames,
    half mirrored) at the published widths, against the benchmark's plain
    head computed in blocks of 128 maps, within the kernel's tolerance."""
    from headpose_tpu_torch.ops.image import preprocess

    det = FaceDetector.from_native(MODEL, precision="fast", head_eval="map",
                                   device=cuda)
    rng = np.random.default_rng(2**31 + 25)
    frames = corpus[rng.integers(0, len(corpus), 1024)]
    flip = rng.random(1024) < 0.5
    frames[flip] = frames[flip, :, ::-1]
    with torch.inference_mode():
        x = preprocess(torch.from_numpy(np.ascontiguousarray(frames)).to(
            cuda), 128)
        out = det.net(x)
        params = np.load(os.path.join(MODEL, "params.npz"))
        for c, name in ((88, "head88"), (96, "head96")):
            taps = out[f"feat{c}"].contiguous()
            got = kse.se_transformer_forward_cuda(getattr(det.net, name),
                                                  taps)
            head = head_kind("se_transformer").build(
                cell.config["spec"][name], params, name + "/", cuda)
            with tf32_mode(False):
                want = torch.cat([head(taps[i:i + 128])
                                  for i in range(0, 1024, 128)])
            torch.testing.assert_close(got, want, **KERNEL_TOL)


@pytest.mark.gpu
def test_stream_launches_meet_the_plan(cuda, cell, corpus):
    """Through detect_stream at B=1024, each batch calls kernel #5 once a
    head (the counter: 2 a batch) and its grids launch as the cell's plan
    says (3 a head: 6 a batch), in the device trace."""
    from torch.profiler import ProfilerActivity, profile

    from headpose_tpu_torch.runtime.streaming import detect_stream
    from perfbench.kernels import se_transformer

    det = FaceDetector.from_native(MODEL, precision="fast", head_eval="map",
                                   device=cuda)
    frames = corpus[np.arange(1024) % len(corpus)]
    batches = [torch.from_numpy(frames).pin_memory() for _ in range(3)]
    for br in detect_stream(det, batches[:1]):
        br.trim()
    before = library.launches()["se_transformer"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for br in detect_stream(det, batches):
            br.trim()
        torch.cuda.synchronize()
    assert library.launches()["se_transformer"] - before == 2 * 3
    grids = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and se_transformer.matches(e.name)]
    assert len(grids) == cell.config["launches"]["se_transformer"] * 3
