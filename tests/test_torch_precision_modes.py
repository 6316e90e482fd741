"""precision="turbo" and "max" of the port on the CPU: the dense composition
of models/blazeface.py against the JAX `BlazeFace.apply(dense=True)`, one
island block (the plain version of the island kernel, ops/kernels/
dense_bf16.py) against float64 arithmetic on the same bf16-rounded
operands, the module path and the CPU detector against the JAX function at
`simulate_fast=True`, the island plans of ops/kernels/backbone2.py, the
empty island, and what raises.  Inputs are made from a seed with numpy.

The JAX detector at "turbo" on the CPU is NOT a reference for these modes:
XLA's CPU backend ignores Precision.DEFAULT and computes fp32.  The
reference is the JAX function with `simulate_fast=True`, which rounds the
island's operands to bf16 and accumulates in fp32: the function the TPU's
single-pass mode computes (headpose_tpu/models/blazeface.py:120-144)."""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headpose_tpu.models.blazeface import BlazeFace as JaxBlazeFace
from headpose_tpu.models.blazeface import turbo_fast_blocks as jax_turbo
from headpose_tpu_torch.core.single_pass import bf16_round
from headpose_tpu_torch.models import (BLAZEFACE_BACK, BLAZEFACE_FRONT,
                                       TURBO_FAST_BLOCKS, BlazeFace,
                                       BlazeFaceNet, UnifiedPoseNet,
                                       turbo_fast_blocks)
from headpose_tpu_torch.models.params import params_from_jax
from headpose_tpu_torch.ops.kernels import backbone as kbb
from headpose_tpu_torch.ops.kernels import backbone2 as kb2
from headpose_tpu_torch.ops.kernels import dense_bf16 as kd
from headpose_tpu_torch.ops.kernels import library
from headpose_tpu_torch.pretrained import (FLAGSHIP, best_detector,
                                           flagship_detector, load_pretrained)
from headpose_tpu_torch.runtime.detector import FaceDetector
from headpose_tpu_torch.runtime.fused import (PRECISIONS, fused_network,
                                              island_of)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")
U32 = 2.0 ** -24          # unit roundoff of fp32

# the fp32 dense composition against JAX's: the taps at the backbone
# tolerance of tests/test_pallas.py:83-86; the SSD outputs (sums of 88-96
# products of the taps, up to 141 in size, some cancelling to near 0) at the
# same rtol with an atol of 1e-6 of the output's largest |value| (8 ulps at
# that scale; measured 1.9e-5 on a loc of 141)
BACKBONE_TOL = dict(rtol=1e-4, atol=1e-5)
SSD_ATOL_FRAC = 1e-6
# one island block against float64 on the same rounded operands: only the
# fp32 sum order differs, so |got - want| <= SUM_ORDER_ULPS * u32 * sum|terms|
# (sum of |products| + |bias| + |skip|).  Measured at most 9.1 units on the
# blocks below; a rounding fault (truncation, ties away from zero, K rounded
# before the dw*pw product, a rounded bias) moves the result by a bf16 step
# (2^-8) of some term: at least 4,700 units on every block
SUM_ORDER_ULPS = 64.0
# the module path against JAX's at simulate_fast=True: the same roundings on
# both sides, but a one-ulp fp32 difference before a rounding (another conv
# algorithm's sum order) flips a bf16 value now and then, and the flip
# spreads through the blocks after it.  So the bound is on the mean |diff|
# of each output over its largest |value|.  Measured on the CPU (flagship
# and back model, "turbo" and "max", random and corpus frames), at most
# 9.5e-5 for the taps and the SSD outputs and 7.9e-4 for the pose maps (the
# pose heads amplify a feature difference); a systematic fault gives at
# least 8.9e-4 and 6.2e-3 on some case (activations not rounded), up to
# 3.9e-3 and 1.6e-2 (rounding by truncation; K rounded before the dw*pw
# product lies between).  The largest single |diff| stays at most 6.0e-3 of
# the output's largest |value|, below MAX_DIFF_FRAC
MEAN_DIFF_FRAC = {"feat88": 2e-4, "feat96": 2e-4, "scores": 2e-4,
                  "loc": 2e-4, "pose_front": 2.5e-3, "pose_back": 2.5e-3}
MAX_DIFF_FRAC = 2.0 ** -6
# the CPU detector against JAX's composition: identical detection sets;
# poses within the JAX certificate's pose-error p99 of the mode
# (docs/certification.json: "turbo" 0.216, "max" 0.676 degrees; measured
# here at most 0.075 and 0.19), boxes, keypoints and scores within 5e-3
# (measured at most 2e-3)
POSE_TOL_DEG = {"turbo": 0.216, "max": 0.676}
DETECT_TOL = 5e-3


def _np(batch):
    return {k: getattr(batch, k).numpy() for k in FIELDS}


def _load(name):
    """(port spec, JAX model, params in JAX layout) of a shipped model; the
    back model is a synthetic bring-up artifact, so loading it warns."""
    from headpose_tpu.pretrained import load_pretrained as jax_load

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spec, params = load_pretrained(name)
        jspec, _ = jax_load(name)
    return spec, jspec, params


@pytest.fixture(scope="module")
def models():
    """The flagship and the back model (input 256), each as (port spec,
    JAX model, params, port network on the CPU)."""
    out = {}
    for key, name in (("flagship", FLAGSHIP),
                      ("back", "unified-back-distilled")):
        spec, jspec, params = _load(name)
        net = UnifiedPoseNet(spec, device="cpu").eval()
        net.load_state_dict(params_from_jax(spec, params))
        out[key] = (spec, jspec, params, net)
    return out


def _frames(kind, size, n=2):
    if kind == "random":
        return np.random.default_rng(0).uniform(
            -1, 1, (n, size, size, 3)).astype(np.float32)
    from headpose_tpu_torch.ops.image import preprocess

    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:n]
    return preprocess(torch.from_numpy(imgs), size).contiguous().numpy()


# ------------------------------------------------------------ composition
def test_turbo_fast_blocks_match_jax():
    """The port's own copy of turbo_fast_blocks gives JAX's islands."""
    for spec, jspec in ((BLAZEFACE_FRONT, JaxBlazeFace()),
                        (BLAZEFACE_BACK, JaxBlazeFace(
                            input_size=256,
                            block_channels=BLAZEFACE_BACK.block_channels,
                            downsample_blocks=(0, 3, 6, 12),
                            tap88_block=11))):
        assert turbo_fast_blocks(spec) == jax_turbo(jspec)
    assert TURBO_FAST_BLOCKS == tuple(range(10, 16))
    assert turbo_fast_blocks(BLAZEFACE_BACK) == tuple(range(11, 17))


@pytest.mark.parametrize("model", ["flagship", "back"])
def test_dense_composition_matches_jax(models, model):
    """BlazeFaceNet.forward(dense=True) against the JAX
    BlazeFace.apply(dense=True) in fp32 (HIGHEST) on 2 random frames: the
    taps within the backbone tolerance of tests/test_pallas.py:83-86, the
    SSD outputs within BACKBONE_TOL's rtol and SSD_ATOL_FRAC."""
    spec, jspec, params, net = models[model]
    x = _frames("random", spec.backbone.input_size)
    with jax.default_matmul_precision("highest"):
        want = jspec.backbone.apply(params["backbone"], jnp.asarray(x),
                                    dense=True)
    with torch.no_grad():
        got = net.backbone(torch.from_numpy(x), dense=True)
    for k in ("feat88", "feat96"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **BACKBONE_TOL)
    for k in ("scores", "loc"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(
            got[k].numpy(), w, rtol=BACKBONE_TOL["rtol"],
            atol=SSD_ATOL_FRAC * float(np.abs(w).max()), err_msg=k)


def test_composed_kernel_is_the_product_of_dw_and_pw(models):
    """BlazeBlock.composed: K[co, ci, a, b] = pw[co, ci] * dw[ci, a, b] (one
    fp32 product, bit for bit JAX's), bias dw_bias @ pw + pw_bias."""
    spec, _, params, net = models["flagship"]
    for i, blk in enumerate(params["backbone"]["blocks"]):
        cin = blk["dw_kernel"].shape[-1]
        dwk = jnp.asarray(blk["dw_kernel"]).reshape(3, 3, cin)
        pwk = jnp.asarray(blk["pw_kernel"]).reshape(cin, -1)
        want = np.asarray(dwk[:, :, :, None] * pwk[None, None])   # HWIO
        K, bias = net.backbone.blocks[i].composed()
        np.testing.assert_array_equal(K.detach().permute(2, 3, 1, 0).numpy(),
                                      want)
        np.testing.assert_allclose(
            bias.detach().numpy(),
            blk["dw_bias"] @ blk["pw_kernel"].reshape(cin, -1)
            + blk["pw_bias"], rtol=1e-6, atol=1e-7)


# ------------------------------------------------------ one island block
def _halfway(rng, n):
    """float32 values exactly halfway between two bf16 values (low 16 bits
    0x8000): ties that round to even both ways."""
    bits = rng.integers(0x3C00_0000, 0x4000_0000, n, dtype=np.int64)
    bits = (bits & ~0xFFFF) | 0x8000
    sign = rng.integers(0, 2, n, dtype=np.int64) << 31
    return (bits | sign).astype(np.uint32).view(np.float32)


def _island_input(rng, b, h, cin):
    """Normal values, a fifth of them replaced by exact bf16 ties."""
    x = rng.normal(0.0, 1.0, (b, h, h, cin)).astype(np.float32)
    flat = x.reshape(-1)
    pick = rng.random(flat.size) < 0.2
    flat[pick] = _halfway(rng, int(pick.sum()))
    return x


def _float64_island(net, i, x):
    """(y, scale) of block i as an island, in float64 on the operands the
    function rounds (x and K to bf16 by torch, to nearest even), the bias
    and the skip unrounded; scale is sum|products| + |bias| + |skip|."""
    blk = net.blocks[i]
    K, bias = (t.detach() for t in blk.composed())
    Kb = bf16_round(K).double().numpy()                  # (Cout, Cin, 3, 3)
    xb = bf16_round(torch.from_numpy(x)).double().numpy()
    s, (B, H, _, cin), cout = blk.stride, x.shape, K.shape[0]
    before, after = (1, 1) if s == 1 else (0, 1)
    xp = np.pad(xb, ((0, 0), (before, after), (before, after), (0, 0)))
    Ho = H // s
    acc = np.zeros((B, Ho, Ho, cout))
    mag = np.zeros_like(acc)
    for a in range(3):
        for c in range(3):
            patch = xp[:, a:a + s * Ho:s, c:c + s * Ho:s, :]
            acc += patch @ Kb[:, :, a, c].T
            mag += np.abs(patch) @ np.abs(Kb[:, :, a, c]).T
    skip = x.astype(np.float64)
    if s == 2:
        r = skip.reshape(B, Ho, 2, Ho, 2, cin)
        skip = r.max(axis=(2, 4))
    skip = np.pad(skip, ((0, 0), (0, 0), (0, 0), (0, cout - cin)))
    t = acc + bias.double().numpy()
    return (np.maximum(t + skip, 0.0),
            mag + np.abs(bias.double().numpy()) + np.abs(skip))


ISLAND_CASES = ([("flagship", i) for i in range(16)]
                + [("back", i) for i in (0, 11, 12, 16)])


@pytest.mark.parametrize("model,block", ISLAND_CASES,
                         ids=[f"{m}{i}" for m, i in ISLAND_CASES])
def test_island_block_exact_against_float64(models, model, block):
    """dense_block_plain (the island step of the module path, on the CPU)
    against float64 arithmetic on the same bf16-rounded operands, on 2
    maps of normal values with a fifth exact bf16 ties (8x8, 16x16 at
    stride 2): within SUM_ORDER_ULPS units of fp32 roundoff of the sum of
    |terms|, the fp32 sum order being the only freedom.  This catches a
    missing or wrong rounding (not to nearest even, K rounded before the
    dw*pw product, a rounded bias), a wrong pad and a wrong skip."""
    net = models[model][3].backbone
    blk = net.blocks[block]
    h = 16 if blk.stride == 2 else 8
    x = _island_input(np.random.default_rng(block), 2, h,
                      blk.dw.weight.shape[0])
    got = kd.dense_block(net, block, torch.from_numpy(x)).numpy()
    want, scale = _float64_island(net, block, x)
    assert got.shape == want.shape and got.dtype == np.float32
    units = np.abs(got - want) / (U32 * scale)
    assert units.max() <= SUM_ORDER_ULPS, units.max()


def test_island_block_is_the_module_island_step(models):
    """dense_block on a CPU tensor is the plain version (no kernel path),
    which is BlazeBlock.forward(dense=True, fast=True) in NHWC, and counts
    no launch."""
    net = models["flagship"][3].backbone
    x = torch.from_numpy(_island_input(np.random.default_rng(3), 2, 8, 96))
    before = library.launches()["dense_block"]
    got = kd.dense_block(net, 13, x)
    with torch.no_grad():
        want = net.blocks[13](x.permute(0, 3, 1, 2), dense=True, fast=True)
    assert torch.equal(got, want.permute(0, 2, 3, 1))
    assert library.launches()["dense_block"] == before


def test_dense_pack_is_the_rounded_composition(models):
    """The kernels' weight pack: per block the composed K rounded to bf16
    once (after the fp32 product), laid out (9, Np, Kp + 8) [tap][out][in]
    with zero padding (`kernel(i)` the (9, Np, Kp) view without the rows'
    8 pad columns), and the fp32 bias padded to Np; built once per module
    and rebuilt when a weight changes."""
    net = models["flagship"][3].backbone
    pack = kd.dense_pack(net)
    assert kd.dense_pack(net).kernels is pack.kernels
    for i, blk in enumerate(net.blocks):
        K, bias = (t.detach() for t in blk.composed())
        cout, cin = K.shape[:2]
        w = pack.kernel(i)
        assert w.dtype == torch.bfloat16
        assert tuple(w.shape) == (9, -(-cout // 8) * 8, -(-cin // 16) * 16)
        assert pack.kernels.offsets[i] % 8 == 0          # 16-byte aligned
        want = K.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, cout, cin)
        assert torch.equal(w[:, :cout, :cin], want)
        assert not w[:, cout:].float().any()
        assert not w[:, :, cin:].float().any()
        n, k = w.shape[1:]
        off = pack.kernels.offsets[i]
        rows = pack.kernels.weights[off:off + 9 * n * (k + 8)].view(9, n,
                                                                    k + 8)
        assert torch.equal(rows[:, :, :k], w) and not rows[:, :, k:].any()
        assert torch.equal(pack.bias(i)[:cout], bias)
    net2 = BlazeFaceNet(BLAZEFACE_FRONT, device="cpu")
    net2.load_state_dict(net.state_dict())
    first = kd.dense_pack(net2)
    with torch.no_grad():
        net2.blocks[12].pw.weight.mul_(2.0)
    assert kd.dense_pack(net2).kernels is not first.kernels


def test_cuda_entry_point_refuses_cpu_tensors(models):
    """The kernel side raises rather than computing on the CPU."""
    net = models["flagship"][3].backbone
    with pytest.raises(ValueError, match="CUDA"):
        kd.dense_block_cuda(net, 12, torch.zeros((1, 8, 8, 96)))
    with pytest.raises(ValueError, match=r"\(B, H, H, 96\)"):
        kd.dense_block(net, 12, torch.zeros((1, 8, 8, 88)))
    with pytest.raises(ValueError, match="not a block"):
        kd.dense_block(net, 16, torch.zeros((1, 8, 8, 96)))


# -------------------------------------------------- module path vs JAX
def _outputs_close(got, want, keys):
    """The MEAN_DIFF_FRAC / MAX_DIFF_FRAC bounds on each output."""
    report = {}
    for k in keys:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, k
        d = np.abs(g - w)
        scale = float(np.abs(w).max())
        report[k] = (float(d.mean()) / scale, float(d.max()) / scale)
        assert report[k][0] <= MEAN_DIFF_FRAC[k], (k, report[k])
        assert report[k][1] <= MAX_DIFF_FRAC, (k, report[k])
    return report


@pytest.mark.parametrize("frames", ["random", "corpus"])
@pytest.mark.parametrize("mode", ["turbo", "max"])
@pytest.mark.parametrize("model", ["flagship", "back"])
def test_module_path_matches_jax_simulate_fast(models, model, mode, frames):
    """UnifiedPoseNet.forward(dense=True, fast_blocks=the mode's island)
    against the JAX UnifiedPoseModel.apply(..., dense=True,
    fast_blocks=..., simulate_fast=True) at HIGHEST on 2 frames: the taps,
    the SSD outputs and both pose maps within MEAN_DIFF_FRAC (mean) and
    MAX_DIFF_FRAC (largest) of each output's scale, bounds that admit
    isolated bf16 flips and catch a systematic fault."""
    spec, jspec, params, net = models[model]
    x = _frames(frames, spec.backbone.input_size)
    island = island_of(spec.backbone, mode)
    with jax.default_matmul_precision("highest"):
        want = jspec.apply(params, jnp.asarray(x), dense=True,
                           fast_blocks=island, simulate_fast=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x), dense=True, fast_blocks=island)
    _outputs_close(got, want, ("feat88", "feat96", "scores", "loc",
                               "pose_front", "pose_back"))


def test_separable_fast_blocks_match_jax(models):
    """fast_blocks without dense (each of the depthwise and the pointwise
    at single-pass bf16), as the JAX apply computes it at
    simulate_fast=True, under the same bounds."""
    spec, jspec, params, net = models["flagship"]
    x = _frames("random", 128)
    with jax.default_matmul_precision("highest"):
        want = jspec.backbone.apply(params["backbone"], jnp.asarray(x),
                                    fast_blocks=TURBO_FAST_BLOCKS,
                                    simulate_fast=True)
    with torch.no_grad():
        got = net.backbone(torch.from_numpy(x),
                           fast_blocks=TURBO_FAST_BLOCKS)
    _outputs_close(got, want, ("feat88", "feat96", "scores", "loc"))


# ------------------------------------------------------------ detector
class _SimulateFast:
    """A JAX UnifiedPoseModel whose apply runs at simulate_fast=True: the
    JAX detector then composes preprocess → apply(simulate_fast=True) →
    ops.detection.postprocess, the function of "turbo" and "max"."""

    def __init__(self, model):
        self._model = model
        self.backbone, self.head88, self.head96 = (
            model.backbone, model.head88, model.head96)

    def apply(self, params, x, **kwargs):
        return self._model.apply(params, x, simulate_fast=True, **kwargs)


@pytest.mark.parametrize("images", ["production", "corpus"])
@pytest.mark.parametrize("mode", ["turbo", "max"])
@pytest.mark.parametrize("model", ["flagship", "back"])
def test_cpu_detector_matches_jax_composition(models, model, mode, images):
    """The port's CPU detector at "turbo" and "max" against the JAX
    composition of the same function (JAX preprocess → apply(dense=True,
    simulate_fast=True) → headpose_tpu.ops.detection.postprocess, through
    the JAX FaceDetector) on e2e_production.npz and 6 parity-corpus frames:
    identical detection sets, poses within POSE_TOL_DEG, boxes, keypoints
    and scores within DETECT_TOL.  The port's CPU path runs the blocks
    outside the island split-bf16 (its "fast" plan) where JAX runs them in
    fp32: a 2^-17 difference that flips a bf16 rounding in the island now
    and then."""
    from headpose_tpu.runtime.detector import FaceDetector as JaxDetector

    spec, jspec, params, _ = models[model]
    if images == "production":
        imgs = np.load(os.path.join(GOLDEN, "e2e_production.npz"))["img"][None]
    else:
        imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:6]
    got = _np(FaceDetector(spec, params, device="cpu",
                           precision=mode).detect(imgs))
    want = {k: np.asarray(getattr(JaxDetector(
        _SimulateFast(jspec), params, precision=mode).detect(imgs), k))
        for k in FIELDS}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() >= 1
    m = got["valid"]
    np.testing.assert_allclose(got["poses"][m], want["poses"][m], rtol=0,
                               atol=POSE_TOL_DEG[mode])
    for k in ("boxes", "keypoints", "scores"):
        np.testing.assert_allclose(got[k][m], want[k][m], rtol=0,
                                   atol=DETECT_TOL, err_msg=k)


@pytest.mark.parametrize("mode", ["turbo", "max"])
def test_best_detector_serves_the_modes(mode):
    """best_detector() at "turbo" and "max" on the CPU: the flagship's
    detection sets at the same mode (the two models share the backbone and
    SSD heads), detect and detect_fused one path."""
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:4]
    det = best_detector(device="cpu", precision=mode)
    got = _np(det.detect(imgs))
    want = _np(flagship_detector(device="cpu", precision=mode).detect(imgs))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["boxes"], want["boxes"])
    fused = _np(det.detect_fused(imgs))
    for k in FIELDS:
        np.testing.assert_array_equal(fused[k], got[k])


# ---------------------------------------------------------------- plans
PLANS = {
    "front_turbo": (BLAZEFACE_FRONT, tuple(range(10, 16)),
                    {"A": (0, 2, 64), "B": (3, 5, 32), "C": (6, 9, 16)}, []),
    "back_turbo": (BLAZEFACE_BACK, tuple(range(11, 17)),
                   {"A": (0, 2, 128), "B": (3, 5, 64), "C": (6, 10, 32)},
                   []),
    "front_max": (BLAZEFACE_FRONT, tuple(range(16)), {}, []),
    "back_max": (BLAZEFACE_BACK, tuple(range(17)), {}, []),
    "front_empty": (BLAZEFACE_FRONT, (), kb2.SEGMENTS, [11]),
    "back_empty": (BLAZEFACE_BACK, (),
                   {"A": (0, 2, 128), "B": (3, 5, 64), "C": (6, 11, 32),
                    "D": (12, 16, 16)}, []),
    "front_12_15": (BLAZEFACE_FRONT, (12, 13, 14, 15),
                    {"A": (0, 2, 64), "B": (3, 5, 32), "C": (6, 10, 16)},
                    [11]),
    "front_7_8": (BLAZEFACE_FRONT, (8, 7),
                  {"A": (0, 2, 64), "B": (3, 5, 32), "C": (6, 6, 16),
                   "C2": (9, 10, 16), "D": (12, 15, 8)}, [11]),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_segment_plan_with_island(name):
    """segment_plan cuts the "fast" plan around the island: the expected
    segments, the island's blocks as island steps in block order, the
    plan's fp32 blocks outside the island still fp32, and every block in
    exactly one step."""
    spec, island, plan, fp32 = PLANS[name]
    assert kb2.segment_plan(spec, island) == plan
    steps = kb2._schedule(spec, island)
    assert [k for kind, k in steps if kind == "island"] == sorted(island)
    assert [k for kind, k in steps if kind == "fp32"] == fp32
    covered = []
    for kind, key in steps:
        covered += (list(range(plan[key][0], plan[key][1] + 1))
                    if kind == "segment" else [key])
    assert covered == list(range(len(spec.block_channels)))


def test_island_segments_run_as_planned(models):
    """apply_fused_plain with an island equals composing its steps by hand,
    bit for bit: the plain stem, run_segment_plain over each (shortened)
    segment and dense_block_plain over each island block; "turbo"'s segment
    C stops at block 9, whose output is no tap."""
    net = models["flagship"][3].backbone
    x = torch.from_numpy(_frames("random", 128))
    island = (10, 11, 12, 13, 14, 15)
    got = kb2.apply_fused_plain(net, x, island)
    with torch.no_grad():
        w = list(kbb._leaves(net))
        y = torch.relu(kbb._stem(x, w[0], w[1]))
    for seg in ("A", "B", "C"):
        y = kb2.run_segment_plain(net, y, seg, island)
    assert tuple(y.shape) == (2, 16, 16, 80)
    for i in island:
        y = kd.dense_block_plain(net, i, y)
        if i == 10:
            feat88 = y
    assert torch.equal(got[0], feat88) and torch.equal(got[1], y)


# ---------------------------------------------------------- empty island
def test_empty_island_is_fast_bitwise():
    """turbo_island=() serves the "fast" function: the slabs equal the
    "fast" detector's bit for bit (the SSD heads unrounded too, as JAX's
    empty island leaves them)."""
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:3]
    got = _np(flagship_detector(device="cpu", precision="turbo",
                                turbo_island=()).detect(imgs))
    want = _np(flagship_detector(device="cpu", precision="fast").detect(imgs))
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_turbo_island_is_read_on_every_call():
    """A turbo_island set after construction applies to the next call, as
    precision does: the default island, then (), then back."""
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:2]
    det = flagship_detector(device="cpu", precision="turbo")
    turbo = _np(det.detect(imgs))
    det.turbo_island = ()
    fast = _np(det.detect(imgs))
    np.testing.assert_array_equal(
        fast["poses"], _np(flagship_detector(
            device="cpu", precision="fast").detect(imgs))["poses"])
    assert not np.array_equal(turbo["poses"], fast["poses"])
    det.turbo_island = None
    np.testing.assert_array_equal(_np(det.detect(imgs))["poses"],
                                  turbo["poses"])


# ------------------------------------------------------------ validation
@pytest.mark.parametrize("island", [(16,), (-1,), (3, 99)])
def test_island_outside_the_spec_raises(island):
    """Island indices outside the spec raise, at construction and in the
    plan; the module path's fast_blocks likewise."""
    with pytest.raises(ValueError, match="not blocks of this spec"):
        flagship_detector(device="cpu", precision="turbo",
                          turbo_island=island)
    with pytest.raises(ValueError, match="not blocks of this spec"):
        kb2.segment_plan(BLAZEFACE_FRONT, island)
    net = BlazeFaceNet(BlazeFace(), device="cpu")
    with pytest.raises(ValueError, match="not blocks of this spec"):
        net(torch.zeros((1, 128, 128, 3)), dense=True, fast_blocks=island)


def test_precisions_and_island_options():
    """The four served modes; an island is "turbo"'s option only."""
    assert PRECISIONS == ("highest", "fast", "turbo", "max")
    net = flagship_detector(device="cpu").net
    x = torch.zeros((1, 128, 128, 3))
    for precision in ("highest", "fast", "max"):
        with pytest.raises(ValueError, match="island"):
            fused_network(net, x, precision=precision, island=(12,))
    assert island_of(BLAZEFACE_FRONT, "turbo", ()) == ()
    assert island_of(BLAZEFACE_FRONT, "max") == tuple(range(16))
    assert island_of(BLAZEFACE_FRONT, "fast") == ()


def test_http_cli_takes_the_new_modes(monkeypatch):
    """The server CLI's --precision choices are PRECISIONS: "turbo" and
    "max" reach the detector (which, without a card, raises for the card,
    not for the mode); other strings are refused by the parser."""
    from headpose_tpu_torch.runtime import http as thttp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for precision in ("turbo", "max"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thttp.main(["--port", "0", "--precision", precision])
        det = thttp._build_detector(None, device="cpu", precision=precision)
        assert det.precision == precision
    with pytest.raises(SystemExit):
        thttp.main(["--port", "0", "--precision", "bf16"])


# ------------------------------------------------------------ certificate
class _Replay:
    """A detect whose trim() gives back a corpus's reference detections,
    with the first detection of image `drop` left out."""

    def __init__(self, data, drop=None):
        self.data, self.drop = data, drop

    def __call__(self, imgs):
        return self

    def trim(self):
        from types import SimpleNamespace

        out = []
        for i, c in enumerate(self.data["counts"]):
            first = 1 if i == self.drop else 0
            out.append(SimpleNamespace(**{
                k: self.data[k][i, first:int(c)]
                for k in ("boxes", "scores", "poses")}))
        return out


def test_certify_modes_reports_the_reference_as_exact():
    """tools/certify_modes.py's parity and stress reports: the reference's
    own detections agree on every image with zero error and keep the
    truncation order; leaving one detection out costs that image."""
    from headpose_tpu_torch.tools import certify_modes as cm

    parity = dict(np.load(os.path.join(GOLDEN, "parity_corpus.npz")))
    stress = dict(np.load(os.path.join(GOLDEN, "stress_corpus.npz")))
    rep = cm.certify_parity(_Replay(parity), parity)
    assert rep["set_agreement"] == 1.0 and rep["images"] == 112
    assert rep["pose_deg"]["n"] == rep["reference_detections"] == 451
    assert rep["pose_deg"]["max"] == rep["box_norm"]["max"] == 0.0
    one_off = cm.certify_parity(_Replay(parity, drop=0), parity)
    assert one_off["agree_images"] == 111
    srep = cm.certify_stress(_Replay(stress), stress)
    for axis in cm.AXES:
        assert srep[axis]["set_agreement"] == 1.0, axis
    assert srep["overflow_order"]["order_exact"] == \
        srep["overflow_order"]["images"] == 12
    with pytest.raises(SystemExit):
        cm.main(["bf16"])


def test_card_certificate_meets_the_gates():
    """docs/certification_torch.json, written on the card by
    tools/certify_modes.py: pinned to both corpora (not stale), taken on an
    H100 whose name and power limit it records, and holding the gates
    chip_smoke.py holds the modes to: "highest" and "fast" the 0.1-degree
    contract, "turbo" every detection set at pose p99 <= 0.43 degrees,
    "max" at least 108 of 112 sets at p99 <= 1.35."""
    import hashlib
    import json

    with open(os.path.join(REPO, "docs", "certification_torch.json")) as f:
        cert = json.load(f)
    for key, name in ((cert, "parity_corpus.npz"),
                      (cert["stress"], "stress_corpus.npz")):
        with open(os.path.join(GOLDEN, name), "rb") as f:
            assert key["corpus_sha256"] == hashlib.sha256(
                f.read()).hexdigest(), name
    assert "H100" in cert["device"]["nvidia_smi"]
    assert cert["device"]["nvidia_smi"].rstrip().endswith("W")
    modes = cert["modes"]
    for mode in ("highest", "fast"):
        assert modes[mode]["set_agreement"] == 1.0
        assert modes[mode]["pose_deg"]["max"] < 0.1
    assert modes["turbo"]["set_agreement"] == 1.0
    assert modes["turbo"]["pose_deg"]["p99"] <= 0.43
    assert modes["max"]["agree_images"] >= 108
    assert modes["max"]["pose_deg"]["p99"] <= 1.35
