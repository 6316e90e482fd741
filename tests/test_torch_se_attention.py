"""The SE-Transformer pose head of the port on the CPU: the kernel's plain
version against the JAX package's Pallas se_transformer_forward (interpret
mode), the module against SETransformerHead.apply, the weight pack, the
dispatch and the kernel's domain; the SE-Transformer model through
FaceDetector in both head profiles against the JAX FaceDetector.  Inputs and
weight perturbations are made from a seed with numpy; weights start from
JAX's own init."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headpose_tpu.models.heads import SETransformerHead as JaxSETransformer
from headpose_tpu.models.unified import UnifiedPoseModel as JaxUnified
from headpose_tpu.ops.pallas.se_attention import \
    se_transformer_forward as jax_se_kernel
from headpose_tpu.pretrained import load_pretrained as jax_load_pretrained
from headpose_tpu.runtime.detector import FaceDetector as JaxFaceDetector
from headpose_tpu_torch.models.heads import (SETransformerHead,
                                             SETransformerHeadNet)
from headpose_tpu_torch.models.params import flatten_params, params_from_jax
from headpose_tpu_torch.models.unified import UnifiedPoseModel
from headpose_tpu_torch.ops.image import preprocess
from headpose_tpu_torch.ops.kernels import library
from headpose_tpu_torch.ops.kernels import se_attention as kse
from headpose_tpu_torch.pretrained import (FLAGSHIP, flagship_detector,
                                           load_pretrained)
from headpose_tpu_torch.runtime.detector import FaceDetector
from headpose_tpu_torch.utils.build import NVCC_FLAGS_FMA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_pallas.py:52
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")


def se_params(fields, seed):
    """JAX's init of the head, every leaf then moved by N(0, 0.05) noise
    (numpy, from the seed) so that biases and LayerNorm offsets are not
    zero: numpy leaves in JAX layout."""
    jparams = JaxSETransformer(**fields).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + rng.normal(
        0, 0.05, a.shape)).astype(np.float32), jparams)


def se_net(fields, params):
    spec = SETransformerHead(**fields)
    net = SETransformerHeadNet(spec, device="cpu")
    net.load_state_dict(params_from_jax(spec, params))
    return net


@pytest.fixture(scope="module")
def flagship_feats():
    """The flagship's feat88 / feat96 on 2 corpus frames (the port's CPU
    network)."""
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:2]
    net = flagship_detector(device="cpu").net
    with torch.no_grad():
        out = net(preprocess(torch.from_numpy(imgs)))
    return {88: out["feat88"].numpy(), 96: out["feat96"].numpy()}


CASES = {
    # name: (fields, input shape or the flagship tap)
    "88_defaults_b2": (dict(in_features=88), (2, 16, 16, 88)),
    "96_defaults_b2": (dict(in_features=96), (2, 8, 8, 96)),
    "96_2x8": (dict(in_features=96, num_heads=2, key_dim=8), (2, 8, 8, 96)),
    "88_one_head": (dict(in_features=88, num_heads=1), (2, 16, 16, 88)),
    "rows_n5": (dict(in_features=88), (5, 1, 1, 88)),
    "flagship_feat88": (dict(in_features=88), 88),
    "flagship_feat96": (dict(in_features=96), 96),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_kernel(name, flagship_feats):
    """se_transformer_forward_plain against the Pallas kernel in interpret
    mode at rtol 1e-4 / atol 1e-5 (measured: at most 1.55e-6 apart, 0.09
    of the tolerance)."""
    fields, shape = CASES[name]
    params = se_params(fields, len(name))
    if isinstance(shape, int):
        x = flagship_feats[shape]
    else:
        x = np.random.default_rng(len(name)).normal(
            0, 1, shape).astype(np.float32)
    want = np.asarray(jax_se_kernel(JaxSETransformer(**fields), params,
                                    jnp.asarray(x), interpret=True))
    got = kse.se_transformer_forward_plain(se_net(fields, params),
                                           torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*x.shape[:3], 3)
    np.testing.assert_allclose(got, want, **KERNEL_TOL)


@pytest.mark.parametrize("form", ["map", "rows"])
def test_module_matches_jax_apply(form):
    """SETransformerHeadNet against SETransformerHead.apply, on 16x16x88
    maps and on (N, 88) rows (each a 1x1 map), at rtol 1e-4 / atol 1e-5."""
    fields = dict(in_features=88, num_heads=2, key_dim=8)
    params = se_params(fields, 3)
    shape = (2, 16, 16, 88) if form == "map" else (40, 88)
    x = np.random.default_rng(3).normal(0, 1, shape).astype(np.float32)
    want = np.asarray(JaxSETransformer(**fields).apply(params,
                                                       jnp.asarray(x)))
    net = se_net(fields, params)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*shape[:-1], 3)
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    if form == "rows":   # the kernel's T = 1 path gives the module's rows
        rows = kse.se_transformer_forward(net, torch.from_numpy(
            x[:, None, None, :]))[:, 0, 0].numpy()
        np.testing.assert_allclose(rows, got, **KERNEL_TOL)


def test_pack_is_the_flattened_jax_leaves():
    """Leaf i of the pack is the JAX wrapper's argument i (q/k/v flattened
    (C, H, D) → (C, H·D), attn_out (H, D, C) → (H·D, C)), row-major, in the
    kernel's layout: the matrices it multiplies on the tensor cores zero-
    padded to (in rounded up to 8, out rounded up to 32), every leaf to a
    multiple of 4 floats."""
    fields = dict(in_features=96, num_heads=2, key_dim=8)
    params = se_params(fields, 1)
    pack = kse.se_pack(se_net(fields, params))
    p = params
    want = [p["se"]["fc1"]["w"], p["se"]["fc1"]["b"], p["se"]["fc2"]["w"],
            p["se"]["fc2"]["b"]]
    for name in ("query", "key", "value"):
        want += [p[name]["w"].reshape(96, 16), p[name]["b"].reshape(16)]
    want += [p["attn_out"]["w"].reshape(16, 96), p["attn_out"]["b"],
             p["ln1"]["g"], p["ln1"]["b"], p["ff1"]["w"], p["ff1"]["b"],
             p["ff2"]["w"], p["ff2"]["b"], p["ln2"]["g"], p["ln2"]["b"],
             p["fc"]["w"], p["fc"]["b"], p["out"]["w"], p["out"]["b"]]
    assert len(pack.offsets) == len(want) == 24
    assert sum(w.size for w in want) == sum(
        v.size for v in flatten_params(params).values())
    ends = list(pack.offsets[1:]) + [pack.weights.numel()]
    for i, (off, end, w) in enumerate(zip(pack.offsets, ends, want)):
        assert off % 4 == 0
        leaf = pack.weights[off:end].numpy()
        if i in (4, 6, 8, 10, 14, 16, 20, 22):          # tiled matrices
            k, n = w.shape
            grid = leaf.reshape(-(-k // 8) * 8, -(-n // 32) * 32)
            np.testing.assert_array_equal(grid[:k, :n], w)
            assert not grid[k:].any() and not grid[:, n:].any()
        else:
            np.testing.assert_array_equal(leaf[:w.size], w.reshape(-1))
            assert not leaf[w.size:].any() and leaf.size - w.size < 4


def test_leaf_order_matches_the_kernel_enum():
    """csrc/se_attention.cu's `enum Leaf` names the 24 leaves in the order
    `_leaves` yields them."""
    src = open(os.path.join(REPO, "headpose_tpu_torch", "csrc",
                            "se_attention.cu")).read()
    body = re.search(r"enum Leaf : int \{(.*?)\};", src, re.S)[1]
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "kLeaves" and len(names) - 1 == 24
    assert names[:4] == ["kSe1W", "kSe1B", "kSe2W", "kSe2B"]
    assert names[-3:-1] == ["kOutW", "kOutB"]


def test_tile_width_matches_the_kernel():
    """The pack pads the tiled matrices to the kernel's tile of columns
    (csrc/se_attention.cu `kTileN`), so that a tile is whole 16-byte rows."""
    src = open(os.path.join(REPO, "headpose_tpu_torch", "csrc",
                            "se_attention.cu")).read()
    assert int(re.search(r"constexpr int kTileN = (\d+);", src)[1]) \
        == kse.TILE_N
    assert kse.TILE_N % 4 == 0


@pytest.mark.parametrize("fields,message", [
    (dict(num_heads=3), "num_heads"),
    (dict(key_dim=12), "key_dim"),
    (dict(num_heads=8, key_dim=16), "num_heads \\* key_dim"),
    (dict(in_features=160, reduction=16), "in_features"),
    (dict(hidden=512), "hidden")])
def test_outside_the_domain_raises(fields, message):
    """The wrapper refuses heads the kernel does not take, on the CPU too
    (as ops/kernels/backbone.py::_check_domain does)."""
    net = SETransformerHeadNet(SETransformerHead(**fields), device="cpu")
    c = net.spec.in_features
    with pytest.raises(ValueError, match=message):
        kse.se_transformer_forward(net, torch.zeros((1, 2, 2, c)))


def test_rejects_a_wrong_input():
    net = SETransformerHeadNet(SETransformerHead(88), device="cpu")
    with pytest.raises(ValueError, match=r"\(B, H, W, 88\)"):
        kse.se_transformer_forward(net, torch.zeros((4, 88)))
    with pytest.raises(ValueError, match="float32"):
        kse.se_transformer_forward(net, torch.zeros((1, 2, 2, 88),
                                                    dtype=torch.float64))


def test_cpu_tensors_go_to_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel; the CUDA entry point refuses
    one; the launch counter does not move."""
    def boom(*a, **k):
        raise AssertionError("the kernel path was taken for a CPU tensor")

    fields = dict(in_features=96)
    net = se_net(fields, se_params(fields, 2))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (1, 8, 8, 96)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        kse.se_transformer_forward_cuda(net, x)
    monkeypatch.setattr(kse, "se_transformer_forward_cuda", boom)
    before = library.launches()["se_transformer"]
    assert torch.equal(kse.se_transformer_forward(net, x),
                       kse.se_transformer_forward_plain(net, x))
    assert library.launches()["se_transformer"] == before


def test_build_flags():
    assert kse.LIBRARY.flags == NVCC_FLAGS_FMA
    assert "--use_fast_math" not in kse.LIBRARY.flags
    assert os.path.isfile(kse.LIBRARY.sources[0])


# ---------------------------------------------- the SE-Transformer model
def se_model():
    """The flagship's backbone and SSD weights with SETransformerHead(88)
    and SETransformerHead(96) at their defaults (seeds 88 and 96)."""
    spec, params = load_pretrained(FLAGSHIP)
    params = {"backbone": params["backbone"],
              "head88": se_params(dict(in_features=88), 88),
              "head96": se_params(dict(in_features=96), 96)}
    return UnifiedPoseModel(backbone=spec.backbone,
                            head88=SETransformerHead(88),
                            head96=SETransformerHead(96)), params


def jax_se_detector(head_eval):
    spec, params = se_model()
    jspec = JaxUnified(backbone=jax_load_pretrained(FLAGSHIP)[0].backbone,
                       head88=JaxSETransformer(88),
                       head96=JaxSETransformer(96))
    return JaxFaceDetector(jspec, params, head_eval=head_eval)


@pytest.fixture(scope="module")
def corpus4():
    return np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:4]


def _np(batch):
    return {k: np.asarray(getattr(batch, k)) for k in FIELDS}


@pytest.fixture(scope="module")
def jax_se(corpus4):
    """The JAX detector's results on 4 corpus frames, per profile."""
    return {ev: _np(jax_se_detector(ev).detect(corpus4))
            for ev in ("map", "survivors")}


@pytest.mark.parametrize("path", ["detect", "detect_fused"])
@pytest.mark.parametrize("head_eval", ["map", "survivors"])
def test_se_model_matches_jax_detector(jax_se, corpus4, head_eval, path):
    """The SE-Transformer model through the module path (detect) and the
    kernel path (detect_fused: the plain version on the CPU) in both
    profiles against the JAX FaceDetector: identical detection sets, boxes
    within 1e-4, scores within 1e-5, poses within rtol = atol = 1e-4."""
    spec, params = se_model()
    det = FaceDetector(spec, params, head_eval=head_eval, device="cpu")
    got, want = _np(getattr(det, path)(corpus4)), jax_se[head_eval]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() >= 4
    for k, tol in (("boxes", 1e-4), ("keypoints", 1e-4), ("scores", 1e-5)):
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)
    np.testing.assert_allclose(got["poses"], want["poses"], rtol=1e-4,
                               atol=1e-4)


def test_se_model_profiles(jax_se):
    """'auto' resolves to 'survivors' for the SE-Transformer model, in both
    packages; the attention couples a map's cells, so the profiles give
    other poses."""
    spec, params = se_model()
    assert FaceDetector(spec, params, device="cpu").head_eval == "survivors"
    assert jax_se_detector("auto").head_eval == "survivors"
    m = jax_se["map"]["valid"]
    assert np.abs(jax_se["map"]["poses"] - jax_se["survivors"]["poses"]
                  )[m].max() > 1e-2


def _seeded(spec, seed):
    """JAX-layout params of a head spec: the port's shapes, normal(0, 0.2)
    leaves from the seed (numpy)."""
    from headpose_tpu_torch.models.heads import head_net
    from headpose_tpu_torch.models.params import params_to_jax

    shapes = params_to_jax(spec, head_net(spec, device="cpu").state_dict())
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.normal(0, 0.2, a.shape).astype(
        np.float32), shapes)


def _outside_model(family):
    """The flagship's backbone and SSD weights with heads outside their
    kernels' domains: SETransformerHead(88|96, num_heads=3), or an MLP head
    of khead.MAX_LAYERS + 1 layers (both maps)."""
    from headpose_tpu_torch.models import MLPHead
    from headpose_tpu_torch.ops.kernels import head_mlp as khead

    if family == "se_heads3":
        heads = {c: SETransformerHead(c, num_heads=3) for c in (88, 96)}
    else:
        heads = {c: MLPHead(c, ((16, "tanh"),) * khead.MAX_LAYERS
                            + ((3, "linear"),)) for c in (88, 96)}
    spec, params = load_pretrained(FLAGSHIP)
    params = {"backbone": params["backbone"],
              "head88": _seeded(heads[88], 88),
              "head96": _seeded(heads[96], 96)}
    return UnifiedPoseModel(backbone=spec.backbone, head88=heads[88],
                            head96=heads[96]), params


@pytest.mark.parametrize("family", ["se_heads3", "mlp_deep"])
@pytest.mark.parametrize("head_eval", ["map", "survivors"])
def test_heads_outside_the_kernel_domain_serve_fast(corpus4, family,
                                                    head_eval):
    """precision="fast" serves heads outside their kernel's domain as their
    modules (head_route "module", decided from the spec), in both profiles:
    the "highest" detect's detection sets, poses within 0.05 (the bound the
    shipped models' "fast" is held to against "highest"; seeded heads, so
    not degrees); detect_fused at "highest" runs them as modules too."""
    from headpose_tpu_torch.runtime.fused import head_route

    spec, params = _outside_model(family)
    fast = FaceDetector(spec, params, head_eval=head_eval, device="cpu",
                        precision="fast")
    highest = FaceDetector(spec, params, head_eval=head_eval, device="cpu")
    assert [head_route(h) for h in (fast.net.head88, fast.net.head96)] == \
        ["module", "module"]
    got, want = _np(fast.detect(corpus4)), _np(highest.detect(corpus4))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() >= 4
    np.testing.assert_allclose(got["poses"], want["poses"], rtol=0, atol=0.05)
    fused = _np(highest.detect_fused(corpus4))
    np.testing.assert_array_equal(fused["valid"], want["valid"])
    np.testing.assert_allclose(fused["poses"], want["poses"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fields,route", [
    (dict(in_features=88), "kernel"),
    (dict(in_features=96, num_heads=2, key_dim=32), "kernel"),
    (dict(in_features=88, num_heads=3), "module"),
    (dict(in_features=96, key_dim=12), "module"),
    (dict(in_features=88, num_heads=8, key_dim=16), "module")])
def test_head_route_follows_the_kernel_domain(fields, route):
    """head_route and the wrapper decide with the same predicate
    (kse.domain_error): a head routed to the kernel passes the wrapper's
    check, a head routed to its module is one the wrapper refuses."""
    from headpose_tpu_torch.runtime.fused import head_route

    net = SETransformerHeadNet(SETransformerHead(**fields), device="cpu")
    assert head_route(net) == route
    assert (kse.domain_error(net) is None) == (route == "kernel")
    x = torch.zeros((1, 2, 2, net.spec.in_features))
    if route == "module":
        with pytest.raises(ValueError, match="does not take this head"):
            kse.se_transformer_forward(net, x)
    else:
        assert kse.se_transformer_forward(net, x).shape == (1, 2, 2, 3)


# ------------------------------------------ the kernel's 3-pass TF32 split
def test_split_tf32_rounds_as_cvt_rna():
    """hi keeps 10 stored mantissa bits, rounded to nearest with ties away
    from zero; t - hi is exact; hi + lo holds t to 2^-21 relative."""
    t = torch.from_numpy(np.random.default_rng(0).normal(
        0, 3, 4096).astype(np.float32))
    hi, lo = kse.split_tf32(t)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.equal(hi + (t - hi), t)
    assert float(((hi + lo - t).abs() / t.abs()).max()) <= 2.0 ** -21
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                         1.0 + 3 * 2.0 ** -11])
    np.testing.assert_array_equal(kse.split_tf32(ties)[0].numpy(),
                                  [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                   1.0 + 2.0 ** -9])


SPLIT_CASES = {
    "head88_16x16": (dict(in_features=88), (2, 16, 16, 88)),
    "head96_8x8": (dict(in_features=96), (2, 8, 8, 96)),
    "head88_rows": (dict(in_features=88), (300, 1, 1, 88)),
    "head96_rows": (dict(in_features=96), (300, 1, 1, 96)),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_3xtf32_head_within_kernel_tolerance(name):
    """The kernel's precision choice, emulated on the CPU: the head with
    every tensor-core product as lo.hi + hi.lo + hi.hi of TF32 halves, at
    the flagship's widths, within rtol 1e-4 / atol 1e-5 of the fp32 plain
    version (measured: at most 0.12 of the tolerance)."""
    fields, shape = SPLIT_CASES[name]
    net = se_net(fields, se_params(fields, len(name)))
    x = torch.from_numpy(np.random.default_rng(len(name)).normal(
        0, 1, shape).astype(np.float32))
    want = kse.se_transformer_forward_plain(net, x)
    with torch.no_grad():
        got = kse._forward(net, x, kse.matmul_3xtf32)
    ratio = ((got - want).abs() / (KERNEL_TOL["atol"]
                                   + KERNEL_TOL["rtol"] * want.abs())).max()
    assert float(ratio) <= 0.5
    torch.testing.assert_close(got, want, **KERNEL_TOL)


def test_split_bf16_head_misses_kernel_tolerance():
    """Why not kernel 3's split-bf16 (hi + lo to 2^-17): the same head with
    its products as 3-pass split-bf16 lies beyond rtol 1e-4 / atol 1e-5 of
    the fp32 plain version on 16x16x88 maps."""
    from headpose_tpu_torch.ops.kernels.backbone2 import split_bf16

    def mm(a, b):
        (a_hi, a_lo), (b_hi, b_lo) = split_bf16(a), split_bf16(b)
        return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi

    fields, shape = SPLIT_CASES["head88_16x16"]
    net = se_net(fields, se_params(fields, 12))
    x = torch.from_numpy(np.random.default_rng(12).normal(
        0, 1, shape).astype(np.float32))
    want = kse.se_transformer_forward_plain(net, x)
    with torch.no_grad():
        got = kse._forward(net, x, mm)
    ratio = ((got - want).abs() / (KERNEL_TOL["atol"]
                                   + KERNEL_TOL["rtol"] * want.abs())).max()
    assert float(ratio) > 1.0
