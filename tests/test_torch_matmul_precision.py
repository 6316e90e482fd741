"""The two strings the JAX package passes to `jax.default_matmul_precision`,
"high" and "default", in the port on the CPU.  Inputs are made from seeds
with numpy.

"high" (the TPU's three bf16 passes): the native detector runs the port's
"fast" network, slab for slab, within the "fast" class of JAX's detector
at "high"; every other path (GraphModel, the detector trainers, the
feature extractor) computes fp32, bitwise its "highest".

"default" (one bf16 pass: bf16-rounded operands, exact products, fp32
sums).  The JAX detector at "default" on the CPU is NOT a reference: XLA's
CPU backend computes fp32 at every precision string.  The references are
JAX's `BlazeFace.apply(simulate_fast=True)` with every block in the island
(its model of the single pass, which leaves the stem fp32: the stem is
given bf16-exact operands there, so that the two functions coincide), and
float64 arithmetic on the same bf16-rounded operands for the stem, every
product of each head family and a GraphModel's convs and Dense layers,
within SUM_ORDER_ULPS units of fp32 roundoff of the sum of |terms|.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from headpose_tpu.models.blazeface import BlazeFace as JaxBlazeFace
from headpose_tpu.train import detector as jdet
from headpose_tpu_torch.core import graph as tgraph
from headpose_tpu_torch.core.graph import GraphModel, load_graph_model
from headpose_tpu_torch.core.single_pass import bf16_round
from headpose_tpu_torch.models import heads as theads
from headpose_tpu_torch.models.heads import (EnsembleHead, MLPHead,
                                             ResidualMLPHead, SEMLPHead,
                                             SETransformerHead, SkipMLPHead,
                                             head_net)
from headpose_tpu_torch.models.params import flatten_params, params_from_jax
from headpose_tpu_torch.ops.image import preprocess
from headpose_tpu_torch.ops.kernels import packing
from headpose_tpu_torch.pretrained import (FLAGSHIP, flagship_detector,
                                           load_pretrained)
from headpose_tpu_torch.runtime.detector import FaceDetector
from headpose_tpu_torch.runtime.fused import SERVED_PRECISIONS
from headpose_tpu_torch.tools.extract_features import FeatureExtractor
from headpose_tpu_torch.train import detector as tdet
from test_torch_detector_train import (STEP_TOL, TINY_STUDENT, TINY_TEACHER,
                                       blobs, init, jcfg, jspec, jtree,
                                       port_grads, port_net, squares)
from test_torch_precision_modes import (MAX_DIFF_FRAC, SUM_ORDER_ULPS, U32,
                                        _halfway)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
FIXTURES = os.path.join(REPO, "tests", "golden_torch")
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")
# the port's "fast" detector against JAX's at "high" (fp32 on the CPU):
# tests/test_torch_backbone2.py's bounds of "fast" against JAX's "fast"
HIGH_VS_JAX = {"boxes": 1e-3, "keypoints": 1e-3, "scores": 1e-3,
               "poses": 0.02}
# one step of the single-pass detector trainer against JAX's simulate_fast
# step: the loss within STEP_TOL; each gradient leaf's largest |diff|
# within 2^-7 of its largest |value|.  The backward rounds each rounded
# operand's cotangent to bf16 on both sides, so a sum-order ulp before
# such a rounding moves that element by a bf16 step (2^-8 relative);
# measured at most 2.6e-3 of the leaf's scale (the stem kernel's gradient,
# which only the port rounds, against JAX's rounded here too)
GRAD_FRAC = 2.0 ** -7
# the single-pass backbone against JAX's simulate_fast one: the same
# roundings on both sides in another sum order, so a one-ulp difference
# before a rounding flips a bf16 value now and then, and the flip spreads
# through the blocks after it; the bound is on the mean |diff| of each
# output over its largest |value|.  Measured at most 4.6e-5 (the flagship
# on 2 corpus frames) and 4.6e-8 (the narrow spec on random frames); a
# systematic fault (activations or weights not rounded) gives at least
# 1.6e-4 on some output of each case.  Random frames drive the flagship's
# maps where flips cascade (a mean of 2.1e-4 without a fault), so it runs
# on corpus frames.  The largest |diff| within MAX_DIFF_FRAC
SP_MEAN_FRAC = 1e-4


def _np(batch):
    return {k: getattr(batch, k).numpy() for k in FIELDS}


def _corpus(n, start=0):
    return np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][
        start:start + n]


def _production():
    return np.load(os.path.join(GOLDEN, "e2e_production.npz"))["img"][None]


# ================================================================= "high"
@pytest.fixture(scope="module")
def high():
    return flagship_detector(device="cpu", precision="high")


def test_served_strings():
    assert SERVED_PRECISIONS == ("highest", "high", "fast", "turbo", "max",
                                 "default")


@pytest.mark.parametrize("images", ["production", "corpus"])
def test_high_detector_is_the_fast_detector(high, images):
    """The native detector at "high" is its "fast" network: detect and
    detect_fused give "fast"'s slab bit for bit (the resize of the 256
    production frame too)."""
    imgs = _production() if images == "production" else _corpus(2)
    want = flagship_detector(device="cpu", precision="fast").detect(
        imgs).slab
    assert torch.equal(high.detect(imgs).slab, want)
    assert torch.equal(high.detect_fused(imgs).slab, want)


def test_high_detector_matches_jax_high(high):
    """6 parity-corpus frames through the port's "high" detector and the JAX
    detector's (fp32 on the CPU): identical detection sets, boxes, keypoints
    and scores within 1e-3, poses within 0.02 degrees, the class of "fast"
    against JAX's "fast" (tests/test_torch_backbone2.py)."""
    from headpose_tpu.pretrained import flagship_detector as jax_flagship

    imgs = _corpus(6)
    got = _np(high.detect(imgs))
    want = {k: np.asarray(v) for k, v in _np_jax(
        jax_flagship(precision="high").detect(imgs)).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() >= len(imgs)
    for k, tol in HIGH_VS_JAX.items():
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def _np_jax(batch):
    return {k: np.asarray(getattr(batch, k)) for k in FIELDS}


def test_graph_model_high_is_highest():
    """GraphModel(matmul_precision="high") is bitwise "highest" (the SE-
    Transformer head fixture: Dense, 1x1 Conv2D and attention), and so is
    a TrainableGraphHead's module built from it; the flagship from
    from_h5_compat at "high" gives the "highest" slab."""
    path = os.path.join(FIXTURES, "se_transformer_head.h5")
    md = load_graph_model(path, device="cpu").definition
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 16, 16, 88)).astype(np.float32))
    want = GraphModel(md, "highest", device="cpu")(x)
    high_gm = GraphModel(md, "high", device="cpu")
    assert torch.equal(high_gm(x), want)
    head = head_net(tgraph.TrainableGraphHead(high_gm, 88), device="cpu")
    assert torch.equal(head(x), want)
    flagship = os.path.join(FIXTURES, "flagship_joined.h5")
    imgs = _corpus(4)
    slabs = {p: FaceDetector.from_h5_compat(flagship, precision=p,
                                            device="cpu").detect(imgs).slab
             for p in ("highest", "high")}
    assert torch.equal(slabs["high"], slabs["highest"])


def _trainer_run(objective, precision):
    """3 steps of a detector trainer at `precision` on given batches."""
    if objective == "fit":
        imgs, boxes, mask, kps = squares(8, 32, 0)
        cfg = tdet.DetectorFitConfig(steps=3, batch_size=4,
                                     steps_per_sync=3, precision=precision)
        return tdet._fit_detector(TINY_STUDENT, imgs, boxes, mask, cfg,
                                  keypoints=kps, kp_weight=1.0,
                                  device="cpu")
    cfg = tdet.DetectorDistillConfig(steps=3, batch_size=4,
                                     steps_per_sync=3, precision=precision)
    imgs = blobs(8, 16, 1)
    teacher = init(TINY_TEACHER, 1)
    if objective == "distill":
        return tdet.distill_detector(TINY_STUDENT, TINY_TEACHER, teacher,
                                     imgs, cfg, device="cpu")
    return tdet.distill_prefix(TINY_STUDENT, 0, TINY_TEACHER, 0, teacher,
                               imgs, cfg, device="cpu")


@pytest.mark.parametrize("objective", ["fit", "distill", "prefix"])
def test_trainers_high_are_highest(objective):
    """fit_detector, distill_detector and distill_prefix at "high" train
    bitwise as at "highest": params and every history value."""
    got_p, got_h = _trainer_run(objective, "high")
    want_p, want_h = _trainer_run(objective, "highest")
    fg, fw = flatten_params(got_p), flatten_params(want_p)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert np.array_equal(fg[k], fw[k]), k
    for k in want_h:
        assert np.array_equal(got_h[k], want_h[k]), k


def test_extractor_high_is_highest():
    """FeatureExtractor(precision="high") extracts bitwise "highest"'s
    rows from the resized production frame and 4 corpus frames."""
    for imgs in (_production(), _corpus(4)):
        got = FeatureExtractor(None, None, 0.05, 0.3, "bgr", "high",
                               device="cpu").extract(imgs)
        want = FeatureExtractor(score_threshold=0.05,
                                device="cpu").extract(imgs)
        for k in ("features88", "features96", "scores", "found"):
            assert np.array_equal(getattr(got, k), getattr(want, k)), k


# ============================================================== "default"
NARROW = dict(stem_features=8,
              block_channels=(8, 8, 12, 12, 16, 16, 24, 24, 32, 32, 40,
                              96, 96, 96, 96, 96))


@pytest.mark.parametrize("model", ["flagship", "narrow"])
def test_single_pass_backbone_matches_jax_simulate_fast(model):
    """BlazeFaceNet.forward(single_pass=True) against JAX's
    BlazeFace.apply(dense=False, fast_blocks=every block,
    simulate_fast=True) at HIGHEST on 2 frames of bf16 values (the flagship
    on corpus frames, the narrow spec on random ones), the stem kernel
    given to JAX rounded to bf16 (JAX's model keeps the stem fp32: on bf16
    operands its fp32 stem is the single pass): the taps and the SSD
    outputs within SP_MEAN_FRAC and MAX_DIFF_FRAC of each output's
    scale."""
    if model == "flagship":
        spec, params = load_pretrained(FLAGSHIP)
        spec, params, jspec_ = spec.backbone, params["backbone"], JaxBlazeFace()
        x = preprocess(torch.from_numpy(_corpus(2)))
    else:
        from headpose_tpu_torch.models.blazeface import BlazeFace

        spec = BlazeFace(**NARROW)
        params = spec.init(torch.Generator().manual_seed(3))
        jspec_ = JaxBlazeFace(**NARROW)
        x = torch.from_numpy(np.random.default_rng(0).normal(
            0.0, 0.5, (2, 128, 128, 3)).astype(np.float32))
    x = bf16_round(x).contiguous().numpy()
    net = port_net(spec, params)
    jparams = dict(params)
    jparams["stem"] = {"kernel": bf16_round(torch.from_numpy(np.asarray(
        params["stem"]["kernel"]))).numpy(), "bias": params["stem"]["bias"]}
    with jax.default_matmul_precision("highest"):
        want = jspec_.apply(jtree(jparams), jnp.asarray(x),
                            fast_blocks=tuple(range(len(
                                spec.block_channels))),
                            simulate_fast=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x), single_pass=True)
    for k in ("feat88", "feat96", "scores", "loc"):
        w, g = np.asarray(want[k]), got[k].numpy()
        d = np.abs(g - w) / float(np.abs(w).max())
        assert d.mean() <= SP_MEAN_FRAC, (k, d.mean())
        assert d.max() <= MAX_DIFF_FRAC, (k, d.max())


def _units(got, want, mag):
    """The largest |got - want| in units of fp32 roundoff of mag (the sum
    of |terms|); an exact 0 where mag is 0 counts 0."""
    d = np.abs(got.astype(np.float64) - want)
    return np.where(d == 0, 0.0, d / np.maximum(U32 * mag, 1e-300)).max()


def test_stem_against_float64():
    """The single-pass stem (5x5/2, TF SAME pad) on 2 maps of normal values,
    a fifth of them exact bf16 ties, against float64 on the bf16-rounded
    operands (to nearest even), the bias unrounded, then the ReLU: within
    SUM_ORDER_ULPS."""
    spec, params = load_pretrained(FLAGSHIP)
    net = port_net(spec.backbone, params["backbone"])
    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 1.0, (2, 128, 128, 3)).astype(np.float32)
    flat = x.reshape(-1)
    pick = rng.random(flat.size) < 0.2
    flat[pick] = _halfway(rng, int(pick.sum()))
    with torch.no_grad():
        got = net._stem(torch.from_numpy(x), single_pass=True).numpy()
    xp = F.pad(bf16_round(torch.from_numpy(x)).double().permute(0, 3, 1, 2),
               (1, 2, 1, 2))
    w = bf16_round(net.stem.weight.detach()).double()
    b = net.stem.bias.detach().double()
    want = torch.relu(F.conv2d(xp, w, stride=2) + b[:, None, None]).numpy()
    mag = (F.conv2d(xp.abs(), w.abs(), stride=2)
           + b.abs()[:, None, None]).numpy()
    assert got.shape == want.shape
    assert _units(got, want, mag) <= SUM_ORDER_ULPS
    with torch.no_grad():              # not the fp32 stem
        fp32 = net._stem(torch.from_numpy(x)).numpy()
    assert _units(fp32, want, mag) > 100 * SUM_ORDER_ULPS


class _Products:
    """Records every product a module runs through models/single_pass.py's
    `linear` and `einsum` as the head modules call them (their operands,
    bias, single_pass flag and output); `check()` holds each recorded
    output to float64 on its bf16-rounded operands."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        real_linear, real_einsum = module.linear, module.einsum

        def linear(layer, x, single_pass=False):
            out = real_linear(layer, x, single_pass)
            self.calls.append(("linear", x.detach(), layer.weight.detach(),
                               layer.bias.detach(), single_pass,
                               out.detach()))
            return out

        def einsum(eq, a, b, single_pass=False):
            out = real_einsum(eq, a, b, single_pass)
            self.calls.append((eq, a.detach(), b.detach(), None,
                               single_pass, out.detach()))
            return out

        monkeypatch.setattr(module, "linear", linear)
        monkeypatch.setattr(module, "einsum", einsum)

    def check(self):
        worst = 0.0
        for op, a, b, bias, single_pass, out in self.calls:
            assert single_pass, op
            ar, br = bf16_round(a).double(), bf16_round(b).double()
            if op == "linear":
                want = F.linear(ar, br, bias.double())
                mag = F.linear(ar.abs(), br.abs(), bias.double().abs())
            else:
                want = torch.einsum(op, ar, br)
                mag = torch.einsum(op, ar.abs(), br.abs())
            units = _units(out.numpy(), want.numpy(), mag.numpy())
            worst = max(worst, units)
            assert units <= SUM_ORDER_ULPS, (op, units)
        return worst


FAMILIES = {
    "mlp": (MLPHead(16, ((8, "tanh"), (3, "linear"))), 2),
    "residual": (ResidualMLPHead(in_features=16, width=8, num_blocks=2,
                                 bottleneck=4), 7),
    "skip": (SkipMLPHead(in_features=16, enc1=8, enc2=12), 4),
    "se_mlp": (SEMLPHead(in_features=16, reduction=4, hidden=8), 4),
    # SE 2, q k v 3, Q·Kᵀ, P·V, the output projection, ff 2, fc and out
    "se_transformer": (SETransformerHead(in_features=16, reduction=4,
                                         num_heads=2, key_dim=4, ff_dim=8,
                                         hidden=8), 12),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_head_family_products_against_float64(monkeypatch, family):
    """Each head family at single_pass over (2, 4, 4, 16) maps: every one of
    its products (counted) rounds both operands and, given them, lies within
    SUM_ORDER_ULPS of float64; the output differs from the fp32 head's."""
    spec, n_products = FAMILIES[family]
    net = head_net(spec, device="cpu")
    net.load_state_dict(params_from_jax(
        spec, spec.init(torch.Generator().manual_seed(0))))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 4, 4, 16)).astype(np.float32))
    with torch.no_grad():
        fp32 = net(x)
        spy = _Products(monkeypatch, theads)
        got = net(x, single_pass=True)
    assert len(spy.calls) == n_products
    spy.check()
    assert got.shape == fp32.shape and not torch.equal(got, fp32)


def test_ensemble_members_at_single_pass():
    """An ensemble (a stack: two equal MLP members as one vmap group, a
    skip member alone) at single_pass is its members' single-pass outputs
    weighted and summed (the group's batched products bitwise the members'
    own), plus the bias; every member's products rounded."""
    a = MLPHead(16, ((8, "tanh"), (3, "linear")))
    b = SkipMLPHead(in_features=16, enc1=8, enc2=12)
    weights = ((0.5, 0.25, 1.0), (0.25, 0.5, 0.0), (0.25, 0.25, 0.5))
    spec = EnsembleHead(members=(a, a, b), weights=weights,
                        bias=(0.1, -0.2, 0.3))
    net = head_net(spec, device="cpu")
    net.load_state_dict(params_from_jax(
        spec, spec.init(torch.Generator().manual_seed(1))))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 4, 4, 16)).astype(np.float32))
    with torch.no_grad():
        got = net(x, single_pass=True)
        members = [m(x, single_pass=True) for m in net.members]
        fp32 = net(x)
    w = torch.tensor(weights)
    want = (members[0] * w[0] + members[1] * w[1]) + members[2] * w[2]
    want = want + torch.tensor((0.1, -0.2, 0.3))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert not torch.allclose(got, fp32, rtol=0, atol=1e-6)


class _GraphProducts:
    """Records GraphModel's `_conv2d` and `_dense` calls (operands, options,
    rounding, output); `check()` holds each to float64 on the rounded
    operands, computed by the same functions on float64 tensors."""

    def __init__(self, monkeypatch):
        self.calls = []
        real_conv, real_dense = tgraph._conv2d, tgraph._dense

        def conv2d(x, kernel, bias, strides, padding, groups=1,
                   dilation=(1, 1), rnd=tgraph._identity):
            out = real_conv(x, kernel, bias, strides, padding, groups,
                            dilation, rnd)
            self.calls.append(("conv", x, kernel, bias, rnd, out,
                               (strides, padding, groups, dilation)))
            return out

        def dense(x, kernel, bias, rnd=tgraph._identity):
            out = real_dense(x, kernel, bias, rnd)
            self.calls.append(("dense", x, kernel, bias, rnd, out, ()))
            return out

        self.real = real_conv, real_dense
        monkeypatch.setattr(tgraph, "_conv2d", conv2d)
        monkeypatch.setattr(tgraph, "_dense", dense)

    @torch.no_grad()
    def check(self, monkeypatch, calls):
        monkeypatch.undo()
        kinds = set()
        for kind, x, kernel, bias, rnd, out, opts in calls:
            assert rnd is bf16_round, kind
            kinds.add(kind)
            xr, kr = bf16_round(x).double(), bf16_round(kernel).double()
            b = bias.double() if bias is not None else None
            ab = b.abs() if b is not None else None
            fn = tgraph._conv2d if kind == "conv" else tgraph._dense
            want = fn(xr, kr, b, *opts)
            mag = fn(xr.abs(), kr.abs(), ab, *opts)
            units = _units(out.detach().numpy(), want.numpy(), mag.numpy())
            assert units <= SUM_ORDER_ULPS, (kind, units)
        return kinds


def test_graph_model_convs_and_dense_against_float64(monkeypatch):
    """GraphModel(matmul_precision="default"): every product rounds (each
    recorded call's rounding is bf16_round), and given its rounded operands
    lies within SUM_ORDER_ULPS of float64: of the flagship fixture the
    5x5/2 Conv2D stem and the first blocks' DepthwiseConv2D and 1x1
    Conv2D, and the last calls (the SSD and pose heads' 1x1s); every
    Dense, 1x1 Conv2D of the SE-Transformer fixture.  The outputs differ
    from "highest"'s."""
    flagship = load_graph_model(os.path.join(FIXTURES, "flagship_joined.h5"),
                                matmul_precision="default", device="cpu")
    se = load_graph_model(os.path.join(FIXTURES, "se_transformer_head.h5"),
                          matmul_precision="default", device="cpu")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 128, 128, 3)).astype(
        np.float32))
    t = torch.from_numpy(rng.normal(size=(1, 16, 16, 88)).astype(
        np.float32))
    spy = _GraphProducts(monkeypatch)
    with torch.no_grad():
        outs = flagship(x)
        y = se(t)
    assert len(spy.calls) > 40
    assert all(call[4] is bf16_round for call in spy.calls)
    checked = spy.calls[:8] + spy.calls[-20:]
    assert spy.check(monkeypatch, checked) == {"conv", "dense"}
    with torch.no_grad():
        assert not torch.equal(outs[0], flagship(x, single_pass=False)[0])
        assert not torch.equal(y, se(t, single_pass=False))


def test_fit_step_matches_jax_simulate_fast():
    """One fit_detector step's loss and gradients at "default" against
    jax.grad of JAX's objective with the whole backbone in the
    simulate_fast island, where the two functions coincide: frames of 0
    and 255 (preprocessed to exactly -1 and 1, at the model's size: no
    resize) and a stem kernel of bf16 values, so the port's rounding of the
    stem's operands changes nothing forward.  The loss within STEP_TOL,
    each gradient leaf within GRAD_FRAC of its scale (the stem kernel's
    against JAX's rounded to bf16: the port's stem rounding rounds its
    cotangent)."""
    spec = TINY_STUDENT
    imgs, boxes, mask, kps = squares(8, 32, 0)
    imgs = np.where(imgs > 127, 255, 0).astype(np.uint8)
    cfg = tdet.DetectorFitConfig(precision="default")
    p = init(spec, 0)
    p["stem"]["kernel"] = bf16_round(torch.from_numpy(
        p["stem"]["kernel"])).numpy()
    labels, loc_tgt = tdet.ssd_targets(spec, torch.from_numpy(boxes), mask,
                                       torch.from_numpy(kps))
    net = port_net(spec, p)
    x = preprocess(torch.from_numpy(imgs), spec.input_size, "bgr", True)
    loss, _ = tdet.ssd_loss(spec, net(x, single_pass=True), labels, loc_tgt,
                            cfg, 1.0)
    loss.backward()
    js, jc = jspec(spec), jcfg(cfg)
    island = tuple(range(len(spec.block_channels)))

    def loss_fn(params, frames, lab, tgt):
        from headpose_tpu.ops.image import preprocess as jpreprocess
        with jax.default_matmul_precision("highest"):
            out = js.apply(params, jpreprocess(frames, spec.input_size),
                           fast_blocks=island, simulate_fast=True)
        return jdet.ssd_loss(js, out, lab, tgt, jc, 1.0)

    (jl, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jtree(p), imgs, jnp.asarray(labels.numpy()),
        jnp.asarray(loc_tgt.numpy()))
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=STEP_TOL["rtol"])
    got = flatten_params(port_grads(spec, net))
    want = flatten_params(jax.tree.map(np.asarray, jg))
    assert sorted(got) == sorted(want)
    for k in want:
        w = want[k]
        if k.startswith("stem") and k.endswith("kernel"):
            w = bf16_round(torch.tensor(w)).numpy()
        scale = float(np.abs(w).max())
        assert np.abs(got[k] - w).max() <= GRAD_FRAC * scale, k


def test_trainers_default_train_and_differ_from_highest():
    """The three trainers at "default" for 3 steps: finite histories that
    differ from "highest"'s (the student's products are rounded)."""
    for objective in ("fit", "distill", "prefix"):
        _, got = _trainer_run(objective, "default")
        _, want = _trainer_run(objective, "highest")
        assert np.isfinite(got["loss"]).all(), objective
        assert not np.array_equal(got["loss"], want["loss"]), objective


def test_resize_against_float64():
    """preprocess(single_pass=True) of the 256 production frame to 128: its
    two GEMMs on bf16-rounded operands against float64 (the second given
    the first's fp32 output rounded), within one bf16 step (2^-8) of the
    map's largest value at most, in the mean within SUM_ORDER_ULPS fp32
    units of it, and not the fp32 resize."""
    from headpose_tpu_torch.ops.bicubic import bicubic_matrix

    img = torch.from_numpy(_production())
    got = preprocess(img, 128, "bgr", True).double()
    x = bf16_round(img.to(torch.float32).flip(-1) / 255.0).double()
    rh = bf16_round(torch.from_numpy(bicubic_matrix(256, 128))).double()
    y = torch.matmul(rh, x.reshape(1, 256, -1))
    y = bf16_round(y.float()).double().reshape(128, 256, 3)
    y = torch.einsum("pw,nwc->npc", rh, y)[None]
    want = (y - 0.5) / 0.5
    d = (got - want).abs()
    assert d.max() <= 2.0 ** -8 * want.abs().max()
    assert d.mean() <= SUM_ORDER_ULPS * U32 * want.abs().max()
    fp32 = preprocess(img, 128, "bgr").double()
    assert (fp32 - got).abs().max() > 100 * d.mean()


def test_default_detector_mutation_round_trip():
    """A detector built at "highest" and switched to "default" rounds (the
    slab of a detector built at "default", the production frame resized
    too), switched back it is bitwise "highest" again; at "default" no
    weight pack is built or stamped, detect_fused raises, and a string it
    does not serve raises on the next call."""
    imgs = _production()
    det = flagship_detector(device="cpu")
    highest = det.detect(imgs).slab
    det.precision = "default"
    got = det.detect(imgs).slab
    fresh = flagship_detector(device="cpu", precision="default")
    assert torch.equal(got, fresh.detect(imgs).slab)
    assert not torch.equal(got, highest)
    assert not any(m in packing._CACHE for m in det.net.modules())
    assert not any(m in packing._CACHE for m in fresh.net.modules())
    with pytest.raises(ValueError, match="'default'"):
        det.detect_fused(imgs)
    det.precision = "highest"
    assert torch.equal(det.detect(imgs).slab, highest)
    det.precision = "bfloat16"
    with pytest.raises(ValueError, match="not served"):
        det.detect(imgs)


def test_default_detector_survivors_and_graph():
    """At "default" the survivors profile's heads round too: the per-cell
    flagship heads give the "map" profile's poses (within 1e-3 degrees) on
    6 corpus frames; from_h5_compat of the flagship fixture at "default"
    finds the native "default" detector's sets, poses within 0.5 degrees
    (GraphModel's 1x1s are GEMMs where the native convs are cuDNN's: another
    sum order before each rounding)."""
    imgs = _corpus(6)
    m = _np(flagship_detector(device="cpu", precision="default",
                              head_eval="map").detect(imgs))
    s = _np(flagship_detector(device="cpu", precision="default",
                              head_eval="survivors").detect(imgs))
    np.testing.assert_array_equal(s["valid"], m["valid"])
    np.testing.assert_allclose(s["poses"], m["poses"], rtol=0, atol=1e-3)
    g = _np(FaceDetector.from_h5_compat(
        os.path.join(FIXTURES, "flagship_joined.h5"), precision="default",
        device="cpu").detect(imgs))
    np.testing.assert_array_equal(g["valid"], m["valid"])
    np.testing.assert_allclose(g["poses"], m["poses"], rtol=0, atol=0.5)


def test_extractor_default_rounds():
    """FeatureExtractor at "default" extracts the single-pass network's
    rows: the features at each best face's cell of the network run with
    single_pass, and not "highest"'s."""
    imgs = _corpus(4)
    ext = FeatureExtractor(score_threshold=0.05, precision="default",
                           device="cpu")
    got = ext.extract(imgs)
    with torch.no_grad():
        x = preprocess(torch.from_numpy(imgs), 128, "bgr", True)
        out = ext.net(x, heads=False, single_pass=True)
    from headpose_tpu_torch.ops.detection import (_f32,
                                                  score_threshold_to_logit)
    from headpose_tpu_torch.tools.extract_features import (best_face,
                                                           gather_cells)
    best, _, _ = best_face(out["scores"],
                           _f32(score_threshold_to_logit(0.05)))
    f88, f96 = gather_cells(best, out["feat88"], out["feat96"])
    assert np.array_equal(got.features88, f88.numpy())
    assert np.array_equal(got.features96, f96.numpy())
    highest = FeatureExtractor(score_threshold=0.05, device="cpu").extract(
        imgs)
    assert not np.array_equal(got.features88, highest.features88)


@pytest.mark.parametrize("precision", ["default"])
def test_export_bakes_the_string(tmp_path, precision):
    """export_detector of a "default" detector bakes the string: the
    program (the rounding casts in it, kernel #1's op the one op of the
    port) replays the source's slab bit for bit on the resized production
    frame.  ("high" is the "fast" network, whose export
    tests/test_torch_aot.py replays.)"""
    from headpose_tpu_torch.tools.aot import export_detector, load_exported

    det = flagship_detector(device="cpu", precision=precision)
    path = str(tmp_path / precision)
    meta = export_detector(det, path, batch_sizes=(1,),
                           image_shape=(256, 256))
    assert meta["config"]["precision"] == precision
    assert all(p["ops"] == ["postprocess"]
               for p in meta["programs"].values())
    frames = _production()
    assert torch.equal(load_exported(path).detect(frames).slab,
                       det.detect(frames).slab)


def test_demo_cli_takes_jax_choices(monkeypatch):
    """runtime/demo.py's --precision takes JAX's demo choices (highest,
    high, fast, turbo, max) and passes them on; "default" is none."""
    from headpose_tpu_torch.runtime import demo

    seen = {}
    monkeypatch.setattr(demo, "run_demo",
                        lambda **kw: seen.update(kw) or 0)
    for precision in ("highest", "high", "fast", "turbo", "max"):
        demo.main(["--precision", precision, "--headless"])
        assert seen["precision"] == precision
    with pytest.raises(SystemExit):
        demo.main(["--precision", "default"])


def test_card_certificate_of_the_two_strings():
    """docs/certification_torch.json, written on the card by
    tools/certify_modes.py, holds "high" and "default": "high" the
    0.1-degree contract on both corpora ("fast"'s figures, the same
    network), "default" the gate chip_smoke.py holds it to (at least 108
    of 112 images, pose p99 <= 2.1 degrees, twice the CPU's 1.05)."""
    import json

    with open(os.path.join(REPO, "docs", "certification_torch.json")) as f:
        cert = json.load(f)
    assert "H100" in cert["device"]["nvidia_smi"]
    modes, stress = cert["modes"], cert["stress"]["modes"]
    assert modes["high"]["set_agreement"] == 1.0
    assert modes["high"]["pose_deg"]["max"] < 0.1
    assert modes["high"]["pose_deg"] == modes["fast"]["pose_deg"]
    for axis in ("threshold", "nms", "saturation", "overflow"):
        assert stress["high"][axis]["set_agreement"] == 1.0, axis
    assert stress["high"]["overflow_order"]["order_exact"] == 12
    assert modes["default"]["agree_images"] >= 108
    assert modes["default"]["pose_deg"]["p99"] <= 2.1


def test_http_builder_serves_what_the_detector_serves():
    """runtime/http.py's _build_detector serves "high" and "default" (the
    detector's strings) while its CLI keeps JAX's four choices
    (tests/test_torch_http.py)."""
    from headpose_tpu_torch.runtime import http

    for precision in ("high", "default"):
        det = http._build_detector(None, device="cpu", precision=precision)
        assert det.precision == precision
