"""The fused backbone and pose-head kernels of the port on the CPU: their plain
versions against the JAX package's Pallas kernels (interpret mode), the
packing of their weights, their dispatch, and the flagship's whole fused
path against FaceDetector.detect.  Inputs are made from a seed with numpy."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headpose_tpu.models.blazeface import BlazeFace as JaxBlazeFace
from headpose_tpu.models.heads import MLPHead as JaxMLPHead
from headpose_tpu.ops.pallas.backbone import backbone_forward as jax_backbone
from headpose_tpu.ops.pallas.head_mlp import mlp_head_forward as jax_head
from headpose_tpu_torch.core.activations import (ACTIVATION_IDS, ACTIVATIONS,
                                                 activation_id)
from headpose_tpu_torch.models import (BLAZEFACE_BACK, BlazeFace,
                                       BlazeFaceNet, MLPHead, MLPHeadNet,
                                       UnifiedPoseNet)
from headpose_tpu_torch.models.params import params_from_jax, params_to_jax
from headpose_tpu_torch.ops.kernels import backbone as kbb
from headpose_tpu_torch.ops.kernels import head_mlp as khead
from headpose_tpu_torch.ops.kernels import library
from headpose_tpu_torch.ops.kernels import postprocess as kpost
from headpose_tpu_torch.pretrained import (BEST, FLAGSHIP, best_detector,
                                           flagship_detector, load_pretrained)
from headpose_tpu_torch.runtime.fused import fused_network
from headpose_tpu_torch.utils.build import NVCC_FLAGS, NVCC_FLAGS_FMA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")

# a narrow spec with a stride-2 first block and growing channels
NARROW = dict(input_size=32, stem_features=8, block_channels=(8, 12, 16, 16, 20),
              downsample_blocks=(0, 1, 3), tap88_block=2)


def _random_params(spec, seed):
    """Glorot-uniform kernels and small normal biases, JAX layout, numpy."""
    rng = np.random.default_rng(seed)
    shapes = params_to_jax(spec, BlazeFaceNet(spec, device="cpu").state_dict())

    def init(leaf):
        if leaf.ndim == 1:
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        kh, kw, cin, cout = leaf.shape
        lim = np.sqrt(6.0 / (kh * kw * (cin + cout)))
        return rng.uniform(-lim, lim, leaf.shape).astype(np.float32)

    return jax.tree.map(init, shapes)


def _backbone_case(name):
    """(port spec, JAX spec, params in JAX layout) of a named case."""
    if name == "flagship":
        spec, params = load_pretrained(FLAGSHIP)
        return spec.backbone, JaxBlazeFace(), params["backbone"]
    spec = BlazeFace(**NARROW)
    return spec, JaxBlazeFace(**NARROW), _random_params(spec, 5)


def _net(spec, params):
    net = BlazeFaceNet(spec, device="cpu")
    net.load_state_dict(params_from_jax(spec, params))
    return net


# ------------------------------------------------------------------ backbone
@pytest.mark.parametrize("name", ["flagship", "narrow"])
def test_backbone_plain_matches_jax_kernel(name):
    """backbone_forward_plain against the Pallas backbone_forward in
    interpret mode, flagship at B=2 and the narrow spec at B=4, at the
    tolerance of tests/test_pallas.py:83-86 (rtol 1e-4, atol 1e-5)."""
    spec, jspec, params = _backbone_case(name)
    b = 2 if name == "flagship" else 4
    s = spec.input_size
    x = np.random.default_rng(0).uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    w88, w96 = jax_backbone(jspec, params, jnp.asarray(x), tile=b,
                            interpret=True)
    got88, got96 = kbb.backbone_forward_plain(_net(spec, params),
                                              torch.from_numpy(x))
    for got, want in ((got88, w88), (got96, w96)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["flagship", "narrow"])
def test_backbone_pack_round_trips(name):
    """Each leaf of the packed buffer is the JAX-layout parameter it came
    from, through params_from_jax and the module."""
    spec, _, params = _backbone_case(name)
    pack = kbb.backbone_pack(_net(spec, params))
    want = [params["stem"]["kernel"], params["stem"]["bias"]]
    for blk in params["blocks"]:
        want += [blk["dw_kernel"][:, :, 0], blk["dw_bias"],
                 blk["pw_kernel"][0, 0], blk["pw_bias"]]
    assert len(pack.offsets) == len(want) == 2 + 4 * len(spec.block_channels)
    assert pack.weights.numel() == sum(w.size for w in want)
    _assert_leaves(pack, want)


def _assert_leaves(pack, want):
    """Leaf i of the pack is want[i], row-major, at offsets[i]."""
    for off, w in zip(pack.offsets, want):
        np.testing.assert_array_equal(
            pack.weights[off:off + w.size].numpy(), w.reshape(-1))


def test_backbone_pack_is_cached_and_follows_the_weights():
    spec, _, params = _backbone_case("narrow")
    net = _net(spec, params)
    first = kbb.backbone_pack(net)
    assert kbb.backbone_pack(net) is first
    with torch.no_grad():
        net.blocks[1].pw.bias.add_(1.0)
    again = kbb.backbone_pack(net)
    assert again is not first
    off = again.offsets[2 + 4 * 1 + 3]
    np.testing.assert_array_equal(again.weights[off:off + 12].numpy(),
                                  params["blocks"][1]["pw_bias"] + 1.0)


@pytest.mark.parametrize("spec,message", [
    (BLAZEFACE_BACK, "S/8 and S/16"),
    (BlazeFace(input_size=40), "divisible by 16"),
    (BlazeFace(**{**NARROW, "tap88_block": 3}), "S/8 and S/16")])
def test_backbone_outside_the_domain_raises(spec, message):
    """BLAZEFACE_BACK's taps land at S/16 and S/32: the JAX kernel fails on
    it (backbone.py:176-177) and the port's wrapper raises."""
    net = BlazeFaceNet(spec, device="cpu")
    x = torch.zeros((1, spec.input_size, spec.input_size, 3))
    with pytest.raises(ValueError, match=message):
        kbb.backbone_forward(net, x)


def test_backbone_rejects_a_wrong_input():
    spec, _, params = _backbone_case("narrow")
    net = _net(spec, params)
    with pytest.raises(ValueError, match=r"\(B, 32, 32, 3\)"):
        kbb.backbone_forward(net, torch.zeros((1, 16, 16, 3)))
    with pytest.raises(ValueError, match="float32"):
        kbb.backbone_forward(net, torch.zeros((1, 32, 32, 3),
                                              dtype=torch.float64))


# --------------------------------------------------------------- pose heads
def _head_cases():
    cases = [(f"pallas_{i}", 96, layers, 700) for i, layers in enumerate((
        ((32, "tanh"), (16, "tanh"), (3, "linear")),
        ((64, "softsign"), (3, "linear")),
        ((3, "linear"),)))]
    cases += [(f"act_{a}", 88, ((16, a), (3, "linear")), 64)
              for a in ACTIVATIONS]
    cases.append(("ragged_513", 88, ((8, "tanh"), (3, "linear")), 513))
    for model in (FLAGSHIP, BEST):
        for head in ("head88", "head96"):
            cases.append((f"{model}.{head}", None, (model, head), None))
    return cases


def _head_net_and_params(c, layers, seed):
    if c is None:                     # a shipped model's head
        model, head = layers
        spec, params = load_pretrained(model)
        hspec, hparams = getattr(spec, head), params[head]
    else:
        hspec = MLPHead(c, layers)
        jparams = JaxMLPHead(c, layers).init(jax.random.PRNGKey(seed))
        hparams = jax.tree.map(np.asarray, jparams)
    net = MLPHeadNet(hspec, device="cpu")
    net.load_state_dict(params_from_jax(hspec, hparams))
    return hspec, hparams, net


@pytest.mark.parametrize("name,c,layers,n", _head_cases(),
                         ids=[c[0] for c in _head_cases()])
def test_mlp_head_plain_matches_jax_kernel(name, c, layers, n):
    """mlp_head_forward_plain against the Pallas mlp_head_forward in
    interpret mode at rtol = atol = 1e-5 (the port sums in torch's order;
    tests/test_pallas.py:30's 1e-6 compares two JAX programs)."""
    hspec, hparams, net = _head_net_and_params(c, layers, len(name))
    if c is None:     # a shipped head on the path's rows: feature-map cells
        k = hspec.in_features
        x = np.load(os.path.join(GOLDEN, "heads.npz"))[f"xmap{k}"].reshape(
            -1, k)
    else:
        x = np.random.default_rng(len(name)).normal(
            0, 2, (n, hspec.in_features)).astype(np.float32)
    def pallas():
        return np.asarray(jax_head(JaxMLPHead(hspec.in_features,
                                              hspec.layers),
                                   hparams, jnp.asarray(x), tile=256,
                                   interpret=True))

    def plain():
        return khead.mlp_head_forward_plain(net, torch.from_numpy(x)).numpy()

    want, got = pallas(), plain()
    assert got.shape == want.shape == (len(x), hspec.layers[-1][0])
    msg = ""
    if not np.allclose(got, want, rtol=1e-5, atol=1e-5):
        # a mismatch seen once in a parallel run of the whole suite and not
        # reproduced since: say which side does not give its result again
        msg = (f"plain gives the same result again: "
               f"{np.array_equal(plain(), got)}; Pallas gives the same "
               f"result again: {np.array_equal(pallas(), want)}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=msg)


@pytest.mark.parametrize("model", [FLAGSHIP, BEST])
def test_head_pack_round_trips(model):
    spec, params = load_pretrained(model)
    for head in ("head88", "head96"):
        net = MLPHeadNet(getattr(spec, head), device="cpu")
        net.load_state_dict(params_from_jax(getattr(spec, head),
                                            params[head]))
        pack = khead.head_pack(net)
        want = [a for layer in params[head]["layers"]
                for a in (layer["w"], layer["b"])]
        assert len(pack.offsets) == len(want)
        # each leaf padded with zero columns to a multiple of 4: unpadded,
        # it is the JAX leaf exactly
        padded = [w.shape[:-1] + (w.shape[-1] + -w.shape[-1] % 4,)
                  for w in want]
        assert pack.weights.numel() == sum(int(np.prod(s)) for s in padded)
        for off, w, shape in zip(pack.offsets, want, padded):
            leaf = pack.weights[off:off + int(np.prod(shape))].reshape(shape)
            np.testing.assert_array_equal(leaf[..., :w.shape[-1]].numpy(), w)
            assert not leaf[..., w.shape[-1]:].any()


def test_activation_ids_match_the_kernel_enum():
    """csrc/head_mlp.cu numbers the activations as ACTIVATION_IDS does."""
    src = open(os.path.join(REPO, "headpose_tpu_torch", "csrc",
                            "head_mlp.cu")).read()
    enum = {re.sub(r"(?<!^)([A-Z])", r"_\1", m[0]).lower(): int(m[1])
            for m in re.findall(r"\bk([A-Z][A-Za-z]*) = (\d+),", src)}
    assert enum == ACTIVATION_IDS
    assert sorted(ACTIVATION_IDS.values()) == list(range(11))
    assert activation_id(None) == activation_id("linear") == 0
    with pytest.raises(NotImplementedError):
        activation_id("hard_sigmoid")


# ----------------------------------------------------------------- dispatch
def test_cpu_tensors_go_to_the_plain_versions(monkeypatch):
    """A CPU tensor never reaches a kernel: the CUDA entry points are
    replaced by ones that fail, and the launch counters do not move."""
    def boom(*a, **k):
        raise AssertionError("the kernel path was taken for a CPU tensor")

    monkeypatch.setattr(kbb, "backbone_forward_cuda", boom)
    monkeypatch.setattr(khead, "mlp_head_forward_cuda", boom)
    spec, _, params = _backbone_case("narrow")
    net = _net(spec, params)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32))
    before = library.launches()
    got = kbb.backbone_forward(net, x)
    want = kbb.backbone_forward_plain(net, x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, _, head = _head_net_and_params(20, ((8, "tanh"), (3, "linear")), 0)
    rows = got[1].reshape(-1, 20)
    assert torch.equal(khead.mlp_head_forward(head, rows),
                       khead.mlp_head_forward_plain(head, rows))
    assert library.launches() == before       # no kernel on the CPU


def test_cuda_entry_points_refuse_cpu_tensors():
    """The kernel side raises rather than computing on the CPU."""
    spec, _, params = _backbone_case("narrow")
    with pytest.raises(ValueError, match="CUDA"):
        kbb.backbone_forward_cuda(_net(spec, params),
                                  torch.zeros((1, 32, 32, 3)))
    _, _, head = _head_net_and_params(88, ((8, "tanh"), (3, "linear")), 0)
    with pytest.raises(ValueError, match="CUDA"):
        khead.mlp_head_forward_cuda(head, torch.zeros((4, 88)))


def test_build_flags():
    """The postprocess library keeps its bitwise flags; the two new ones
    contract FMAs but keep IEEE division and accurate math functions."""
    assert kpost.LIBRARY.flags == NVCC_FLAGS
    assert "--fmad=false" in NVCC_FLAGS
    for lib in (kbb.LIBRARY, khead.LIBRARY):
        assert lib.flags == NVCC_FLAGS_FMA
        assert "--fmad=false" not in lib.flags
        assert "--use_fast_math" not in lib.flags
        assert os.path.isfile(lib.sources[0])


# ---------------------------------------------------------- the fused path
@pytest.fixture(scope="module")
def flagship():
    return flagship_detector(device="cpu")


def test_fused_network_matches_the_golden_forward(flagship):
    """All six outputs of the reference H5 signature through the fused path
    against tests/golden/unified_forward.npz, at the tolerances of
    tests/test_torch_models.py (rtol 1e-3, atol 2e-4)."""
    g = np.load(os.path.join(GOLDEN, "unified_forward.npz"))
    out = fused_network(flagship.net, torch.from_numpy(g["inputs"]))
    B = g["inputs"].shape[0]
    outs = (out["scores"][:, :512].reshape(B, 512, 1),
            out["scores"][:, 512:].reshape(B, 384, 1),
            out["loc"][:, :512], out["loc"][:, 512:],
            out["pose_front"], out["pose_back"])
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o.numpy(), g[f"out{i}"], rtol=1e-3,
                                   atol=2e-4, err_msg=f"output {i}")


def _fields(batch):
    return {k: getattr(batch, k).numpy() for k in FIELDS}


@pytest.mark.parametrize("model,images", [
    ("flagship", "production"), ("flagship", "corpus"), ("best", "corpus")])
def test_detect_fused_matches_detect(flagship, model, images):
    """The whole fused path on the CPU (plain versions throughout) gives
    FaceDetector.detect's detections: valid equal, boxes and scores within
    1e-4, poses within 5e-4."""
    det = flagship if model == "flagship" else best_detector(device="cpu")
    if images == "production":
        imgs = np.load(os.path.join(GOLDEN, "e2e_production.npz"))["img"][None]
    else:
        imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:4]
    got, want = _fields(det.detect_fused(imgs)), _fields(det.detect(imgs))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() >= len(imgs)
    for k, tol in (("boxes", 1e-4), ("keypoints", 1e-4), ("scores", 1e-4),
                   ("poses", 5e-4)):
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)


def test_fused_network_needs_no_pose_heads():
    """A UnifiedPoseNet without heads gives the backbone and SSD outputs."""
    from headpose_tpu_torch.models.unified import UnifiedPoseModel

    spec = UnifiedPoseModel(backbone=BlazeFace(**NARROW))
    net = UnifiedPoseNet(spec, device="cpu")
    out = fused_network(net, torch.zeros((2, 32, 32, 3)))
    assert sorted(out) == ["feat88", "feat96", "loc", "scores"]
    assert tuple(out["scores"].shape) == (2, 4 * 4 * 2 + 2 * 2 * 6)
    assert tuple(out["loc"].shape) == (2, 4 * 4 * 2 + 2 * 2 * 6, 16)
