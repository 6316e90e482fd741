"""The split-bf16 backbone of the port (ops/kernels/backbone2.py) on the CPU:
its split and weight packs against the JAX package's backbone2, its plain
version against the Pallas segments in interpret mode and against the fp32
backbone, its dispatch and domain, and FaceDetector(precision="fast")
against the JAX detector's fast mode.  Inputs are made from a seed with
numpy."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headpose_tpu.models.blazeface import BlazeFace as JaxBlazeFace
from headpose_tpu.ops.pallas import backbone2 as jb2
from headpose_tpu_torch.models import BLAZEFACE_BACK, BlazeFace, BlazeFaceNet
from headpose_tpu_torch.models.params import params_from_jax, params_to_jax
from headpose_tpu_torch.ops.kernels import backbone as kbb
from headpose_tpu_torch.ops.kernels import backbone2 as kb2
from headpose_tpu_torch.ops.kernels import library
from headpose_tpu_torch.pretrained import (FLAGSHIP, best_detector,
                                           flagship_detector, load_pretrained)
from headpose_tpu_torch.runtime.fused import fused_network
from headpose_tpu_torch.utils.build import NVCC_FLAGS_FMA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")

# a narrow spec inside the reference's domain: blocks 11-15 at 96, segment
# D's fixed width (backbone2.py:489)
NARROW = dict(stem_features=8,
              block_channels=(8, 8, 12, 12, 16, 16, 24, 24, 32, 32, 40,
                              96, 96, 96, 96, 96))
# the plain version against the Pallas segments: the same split-bf16
# arithmetic in another sum order; what differs is mostly the dropped lo.lo
# term where a 1-ulp difference of a depthwise value flips its hi/lo split
# (measured 4.3e-5 on the flagship, features up to 2.7, and 1.57e-4 on the
# corpus's largest maps: test_reference_segment_meets_bare_atol_on_large_
# maps).  SPLIT_TOL's atol alone, without its relative term: the reference
# meets it on every input here
VS_PALLAS_ATOL = kb2.SPLIT_TOL["atol"]
# either split-bf16 backbone against the fp32 one: tests/test_pallas.py:111-114
VS_FP32_ATOL = 5e-4


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


def _case(name):
    """(port spec, JAX spec, params in JAX layout) of a named case."""
    if name == "flagship":
        spec, params = load_pretrained(FLAGSHIP)
        return spec.backbone, JaxBlazeFace(), params["backbone"]
    spec = BlazeFace(**NARROW)
    return spec, JaxBlazeFace(**NARROW), _random_params(spec, 3)


def _net(spec, params):
    net = BlazeFaceNet(spec, device="cpu")
    net.load_state_dict(params_from_jax(spec, params))
    return net


@pytest.fixture(scope="module", params=["flagship", "narrow", "corpus"])
def case(request):
    """One JAX apply_fused (interpret mode) and one fp32 JAX backbone per
    case, with the port's plain version on the same frames: the flagship
    and the narrow spec on 8 random frames, and the flagship on the first
    16 parity-corpus frames (preprocessed), whose maps reach about 20
    where random frames' stay under 3."""
    spec, jspec, params = _case("narrow" if request.param == "narrow"
                                else "flagship")
    if request.param == "corpus":
        from headpose_tpu_torch.ops.image import preprocess

        imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"]
        x = preprocess(torch.from_numpy(imgs[:16])).contiguous().numpy()
    else:
        x = np.random.default_rng(0).uniform(-1, 1, (8, 128, 128, 3)).astype(
            np.float32)
    packed = jb2.pack_backbone(jspec, params)
    pallas = jb2.apply_fused(jspec, params, packed, jnp.asarray(x),
                             interpret=True)
    with jax.default_matmul_precision("highest"):
        ref = jspec.apply(params, jnp.asarray(x))
    net = _net(spec, params)
    plain = kb2.apply_fused_plain(net, torch.from_numpy(x))
    return {"name": request.param, "spec": spec, "jspec": jspec,
            "params": params, "net": net, "x": x, "packed": packed,
            "pallas": [np.asarray(a) for a in pallas],
            "fp32": [np.asarray(ref["feat88"]), np.asarray(ref["feat96"])],
            "plain": [a.numpy() for a in plain]}


# -------------------------------------------------------------------- split
def _halfway(rng, n):
    """float32 values exactly halfway between two bf16 values (low 16 bits
    0x8000), with even and odd bf16 neighbours: ties to even both ways."""
    bits = rng.integers(0x3C00_0000, 0x4100_0000, n, dtype=np.int64)
    bits = (bits & ~0xFFFF) | 0x8000
    sign = rng.integers(0, 2, n, dtype=np.int64) << 31
    return (bits | sign).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("what", ["weights", "activations", "halfway"])
def test_split_bf16_matches_jax(what):
    """split_bf16 equals the JAX astype(bfloat16) split (backbone2.py:
    102-105, 194-195) bit for bit."""
    rng = np.random.default_rng(4)
    if what == "weights":
        _, params = load_pretrained(FLAGSHIP)
        t = np.concatenate([b["pw_kernel"].reshape(-1)
                            for b in params["backbone"]["blocks"]])
    elif what == "activations":
        t = (rng.normal(0, 1, 50_000) * 10.0 ** rng.uniform(-6, 2, 50_000)
             ).astype(np.float32)
    else:
        t = _halfway(rng, 20_000)
    t = t.astype(np.float32)
    hi, lo = kb2.split_bf16(torch.from_numpy(t))
    jhi = np.asarray(jnp.asarray(t).astype(jnp.bfloat16)).astype(np.float32)
    jlo = np.asarray(jnp.asarray(t - jhi).astype(jnp.bfloat16)).astype(
        np.float32)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  jhi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  jlo.view(np.uint32))
    # hi + lo holds t to 2^-16 relative
    assert np.all(np.abs(hi.numpy() + lo.numpy() - t)
                  <= np.abs(t) * 2.0 ** -16)


# -------------------------------------------------------------------- packs
@pytest.mark.parametrize("name", ["flagship", "narrow"])
def test_pack_matches_jax_pack(name):
    """Per block, the pointwise w_hi and w_lo equal the JAX pack's slices
    (plane 0 of the block-diagonal packs: backbone2.py:151-187), the mma
    tile's padding is zero, and the fp32 leaves are the block's dw taps, dw
    bias and pw bias."""
    spec, jspec, params = _case(name)
    pack = kb2.pack_backbone(_net(spec, params))
    jpack = jb2.pack_backbone(jspec, params)
    for seg, (first, last, _) in kb2.SEGMENTS.items():
        lay = jb2._seg_layout(jspec, seg)
        for j, i in enumerate(range(first, last + 1)):
            cin = spec.block_channels[i - 1] if i else spec.stem_features
            cout = spec.block_channels[i]
            koff = lay[j]["koff"]
            for part in ("w_hi", "w_lo"):
                got = getattr(pack, part)(i)
                assert got.dtype == torch.bfloat16
                assert tuple(got.shape) == (-(-cout // 8) * 8,
                                            -(-cin // 16) * 16)
                got = got.float().numpy()
                want = np.asarray(jpack[seg][part][:cout, koff:koff + cin],
                                  np.float32)
                np.testing.assert_array_equal(got[:cout, :cin], want)
                assert not got[cout:].any() and not got[:, cin:].any()
            blk = params["blocks"][i]
            for off, w in zip(pack.f32_offsets(i),
                              (blk["dw_kernel"][:, :, 0], blk["dw_bias"],
                               blk["pw_bias"])):
                np.testing.assert_array_equal(
                    pack.f32.weights[off:off + w.size].numpy(), w.reshape(-1))


def test_pack_is_cached_beside_the_fp32_pack():
    """One module holds both packs: the fp32 one is backbone_pack's (the
    stem, block 11 and the depthwise take it), the bf16 one is cached beside
    it; each follows the weights."""
    spec, _, params = _case("narrow")
    net = _net(spec, params)
    first = kb2.pack_backbone(net)
    again = kb2.pack_backbone(net)
    assert again.f32 is first.f32 and again.bf16 is first.bf16
    assert kbb.backbone_pack(net) is first.f32
    assert first.bf16.weights.dtype == torch.bfloat16
    with torch.no_grad():
        net.blocks[12].pw.weight.mul_(2.0)
    moved = kb2.pack_backbone(net)
    assert moved.bf16 is not first.bf16
    torch.testing.assert_close(moved.w_hi(12).float(),
                               2.0 * first.w_hi(12).float())


# ------------------------------------------------------------ plain version
def test_plain_matches_jax_apply_fused(case):
    """apply_fused_plain against the Pallas apply_fused in interpret mode at
    atol 2e-4 (VS_PALLAS_ATOL)."""
    for got, want in zip(case["plain"], case["pallas"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=VS_PALLAS_ATOL)


@pytest.mark.parametrize("which", ["plain", "pallas"])
def test_split_bf16_backbone_matches_fp32(case, which):
    """Both split-bf16 backbones against the JAX fp32 backbone
    (BlazeFace.apply at HIGHEST) at atol 5e-4 (VS_FP32_ATOL)."""
    for got, want in zip(case[which], case["fp32"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=VS_FP32_ATOL)


def _jax_segment_input(seg, y):
    """The JAX segment's input layout (backbone2.py:459-489) of an NHWC map:
    parity planes for A and B, flat-gapped for C and D, coalesced by 8."""
    h = y.shape[1]
    nchw = jnp.asarray(y).transpose(0, 3, 1, 2)
    c8 = jb2._rup8(y.shape[-1])
    if seg in "AB":
        return jb2._coalesce(jb2._planes_nchw(nchw, c8), 8,
                             jb2._geom(h // 2)[2])
    return jb2._coalesce(jb2._gap_nchw(nchw, c8), 8, jb2._geom(h)[2])


@torch.no_grad()
def _fp32_map(net, x, upto):
    """The fp32 map in front of block `upto`: the stem and blocks 0..upto-1
    of the plain fp32 backbone, the input a segment sees in the backbone."""
    w = list(kbb._leaves(net))
    y = torch.relu(kbb._stem(x, w[0], w[1]))
    for i in range(upto):
        stride = 2 if i in net.spec.downsample_blocks else 1
        y = kbb._block(y, *w[2 + 4 * i:6 + 4 * i], stride)
    return y


@pytest.mark.parametrize("seg", ["A", "B", "C", "D"])
def test_run_segment_plain_matches_jax_run_segment(seg):
    """Each segment alone, flagship weights, at B=8 on the fp32 map that
    feeds it for random frames: run_segment_plain against the Pallas
    run_segment in interpret mode at atol 2e-4 (VS_PALLAS_ATOL)."""
    spec, jspec, params = _case("flagship")
    net = _net(spec, params)
    first, last, h = kb2.SEGMENTS[seg]
    x = np.random.default_rng(ord(seg)).uniform(
        -1, 1, (8, 128, 128, 3)).astype(np.float32)
    y = _fp32_map(net, torch.from_numpy(x), first)
    assert tuple(y.shape[1:3]) == (h, h)
    jout = jb2.run_segment(jspec, jb2.pack_backbone(jspec, params)[seg],
                           _jax_segment_input(seg, y.numpy()), seg=seg,
                           interpret=True)
    ho = h // 2 if last in spec.downsample_blocks else h
    cout = spec.block_channels[last]
    want = np.asarray(jb2._unflatten_nchw(
        jb2._uncoalesce(jout, 8, jb2._geom(ho)[1]), ho, cout)
        .transpose(0, 2, 3, 1))
    got = kb2.run_segment_plain(net, y, seg)
    assert tuple(got.shape) == want.shape == (8, ho, ho, cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=VS_PALLAS_ATOL)


# the 8 parity-corpus frames whose fp32 maps are largest at segment C's and
# D's outputs (up to 21.87: the corpus's peak, where one split-bf16 rounding
# step, 2^-17 of the value, is 1.7e-4)
LARGE_MAP_FRAMES = {"C": [34, 54, 56, 15, 61, 68, 29, 0],
                    "D": [29, 3, 56, 17, 5, 0, 93, 108]}


@pytest.mark.parametrize("seg", ["C", "D"])
def test_reference_segment_meets_bare_atol_on_large_maps(seg):
    """Does the Pallas run_segment (interpret mode) meet the bare 2e-4
    against the plain version where the corpus's maps peak?  Segments C and
    D on the fp32 map that feeds them for the 8 frames of the largest maps,
    B=8: yes (1.57e-4 at C, 6.8e-5 at D on an x86 CPU: about one rounding
    step of the peak value), so SPLIT_TOL holds the kernel to that bare
    atol plus a few such steps of the value."""
    from headpose_tpu_torch.ops.image import preprocess

    spec, jspec, params = _case("flagship")
    net = _net(spec, params)
    first, last, h = kb2.SEGMENTS[seg]
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"]
    x = preprocess(torch.from_numpy(imgs[LARGE_MAP_FRAMES[seg]])).contiguous()
    y = _fp32_map(net, x, first)
    jout = jb2.run_segment(jspec, jb2.pack_backbone(jspec, params)[seg],
                           _jax_segment_input(seg, y.numpy()), seg=seg,
                           interpret=True)
    ho = h // 2 if last in spec.downsample_blocks else h
    cout = spec.block_channels[last]
    want = np.asarray(jb2._unflatten_nchw(
        jb2._uncoalesce(jout, 8, jb2._geom(ho)[1]), ho, cout)
        .transpose(0, 2, 3, 1))
    assert np.abs(want).max() > 19.0            # the corpus's largest maps
    got = kb2.run_segment_plain(net, y, seg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=VS_PALLAS_ATOL)


def test_any_batch_size():
    """B need not be a multiple of 8 (the JAX coalescing factor): the plain
    version of B=3 images equals their rows of a B=8 run."""
    spec, _, params = _case("narrow")
    net = _net(spec, params)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (8, 128, 128, 3)).astype(np.float32))
    full = kb2.apply_fused(net, x)
    for b in (1, 3):
        part = kb2.apply_fused(net, x[:b].contiguous())
        for p, f in zip(part, full):
            torch.testing.assert_close(p, f[:b], rtol=0, atol=1e-6)


# ----------------------------------------------------------------- dispatch
def test_cpu_tensors_go_to_the_plain_version(monkeypatch):
    """A CPU tensor never reaches a kernel: the CUDA entry points are
    replaced by ones that fail, and the launch counters do not move."""
    def boom(*a, **k):
        raise AssertionError("the kernel path was taken for a CPU tensor")

    for name in ("apply_fused_cuda", "run_segment_cuda"):
        monkeypatch.setattr(kb2, name, boom)
    for name in ("stem_forward_cuda", "block_forward_cuda",
                 "backbone_forward_cuda"):
        monkeypatch.setattr(kbb, name, boom)
    spec, _, params = _case("narrow")
    net = _net(spec, params)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 128, 128, 3)).astype(np.float32))
    before = library.launches()
    got = kb2.apply_fused(net, x)
    want = kb2.apply_fused_plain(net, x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    seg_in = torch.relu(torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 8, 8, 96)).astype(np.float32)))
    assert torch.equal(kb2.run_segment(net, seg_in, "D"),
                       kb2.run_segment_plain(net, seg_in, "D"))
    assert library.launches() == before       # no kernel on the CPU


def test_cuda_entry_points_refuse_cpu_tensors():
    """The kernel side raises rather than computing on the CPU."""
    spec, _, params = _case("narrow")
    net = _net(spec, params)
    with pytest.raises(ValueError, match="CUDA"):
        kb2.apply_fused_cuda(net, torch.zeros((1, 128, 128, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        kb2.run_segment_cuda(net, torch.zeros((1, 8, 8, 96)), "D")
    with pytest.raises(ValueError, match="CUDA"):
        kbb.stem_forward_cuda(net, torch.zeros((1, 128, 128, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        kbb.block_forward_cuda(net, 11, torch.zeros((1, 16, 16, 40)))


_C = (24, 28, 32, 36, 42, 48, 56, 64, 72, 80, 88, 96, 96, 96, 96, 96)


@pytest.mark.parametrize("spec,message", [
    (BLAZEFACE_BACK, None),
    (BlazeFace(downsample_blocks=(2, 5, 10)), None),
    (BlazeFace(tap88_block=9), None),
    (BlazeFace(block_channels=_C[:15], downsample_blocks=(2, 5, 11)), None),
    (BlazeFace(block_channels=_C[:11] + (88,) + _C[12:]), None),
    (BlazeFace(block_channels=_C[:11] + (104,) * 5), None),
    (BlazeFace(block_channels=_C[:12] + (96, 96, 96, 136)), "at most 128"),
    (BlazeFace(input_size=120), "halve exactly"),
    (BlazeFace(input_size=64, downsample_blocks=(0, 1, 2, 5, 11, 12)),
     "halve exactly"),
], ids=["back", "downsample", "tap", "depth", "block11_narrow",
        "block11_wide", "too_wide", "input_120", "too_many_halvings"])
def test_outside_the_domain_raises(spec, message):
    """Specs outside the JAX function's segment table.  Those within the
    kernel's limits are served by the plan derived from the spec (every
    block split-bf16), and hold the fp32 backbone's taps at VS_FP32_ATOL on
    random frames; the others raise."""
    net = BlazeFaceNet(spec, device="cpu")
    s = spec.input_size
    if message is not None:
        with pytest.raises(ValueError, match=message):
            kb2.apply_fused(net, torch.zeros((1, s, s, 3)))
        return
    net.load_state_dict(params_from_jax(spec, _random_params(spec, 9)))
    assert set(kb2._split_blocks(spec)) == set(range(len(spec.block_channels)))
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (1, s, s, 3)).astype(np.float32))
    got = kb2.apply_fused(net, x)
    with torch.no_grad():
        want = net(x)
    for g, key in zip(got, ("feat88", "feat96")):
        assert g.shape == want[key].shape
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), rtol=0,
                                   atol=VS_FP32_ATOL, err_msg=key)


@pytest.mark.parametrize("name,plan", [
    ("front", kb2.SEGMENTS),
    ("narrow", kb2.SEGMENTS),
    ("back", {"A": (0, 2, 128), "B": (3, 5, 64), "C": (6, 11, 32),
              "D": (12, 16, 16)}),
])
def test_segment_plan(name, plan):
    """The front topology (and any spec in the JAX function's domain) keeps
    the JAX segment table exactly, block 11 in fp32; the back topology runs
    every block split-bf16, split at its downsample blocks and after the
    tap (block 11)."""
    spec = {"front": BlazeFace(), "narrow": BlazeFace(**NARROW),
            "back": BLAZEFACE_BACK}[name]
    assert kb2.segment_plan(spec) == plan
    fp32 = [key for kind, key in kb2._schedule(spec) if kind == "fp32"]
    assert fp32 == ([] if name == "back" else [11])


@pytest.mark.parametrize("frames", ["random", "corpus"])
def test_back_plain_matches_jax_fp32(frames):
    """apply_fused_plain on the shipped back model (input 256, every block
    split-bf16) against the JAX fp32 BlazeFace.apply at HIGHEST, at
    VS_FP32_ATOL: 2 random frames, and 4 parity-corpus frames resized to 256
    by the preprocess (maps up to about 20)."""
    import warnings

    from headpose_tpu_torch.ops.image import preprocess

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spec, params = load_pretrained("unified-back-distilled")
    if frames == "random":
        x = np.random.default_rng(8).uniform(-1, 1, (2, 256, 256, 3)).astype(
            np.float32)
    else:
        imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"]
        x = preprocess(torch.from_numpy(imgs[:4]), 256).contiguous().numpy()
    jspec = JaxBlazeFace(**{f: getattr(spec.backbone, f) for f in (
        "input_size", "stem_features", "block_channels", "downsample_blocks",
        "tap88_block", "cls_channels", "loc_channels")})
    with jax.default_matmul_precision("highest"):
        ref = jspec.apply(params["backbone"], jnp.asarray(x))
    got = kb2.apply_fused_plain(_net(spec.backbone, params["backbone"]),
                                torch.from_numpy(x))
    for g, key in zip(got, ("feat88", "feat96")):
        want = np.asarray(ref[key])
        assert g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=VS_FP32_ATOL,
                                   err_msg=key)


def test_rejects_a_wrong_input():
    spec, _, params = _case("narrow")
    net = _net(spec, params)
    with pytest.raises(ValueError, match=r"\(B, 128, 128, 3\)"):
        kb2.apply_fused(net, torch.zeros((1, 64, 64, 3)))
    with pytest.raises(ValueError, match="float32"):
        kb2.apply_fused(net, torch.zeros((1, 128, 128, 3),
                                         dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(B, 16, 16, 16\)"):
        kb2.run_segment(net, torch.zeros((1, 16, 16, 12)), "C")
    with pytest.raises(ValueError, match="seg must be"):
        kb2.run_segment(net, torch.zeros((1, 16, 16, 16)), "E")


def test_build_flags_and_tensor_core_source():
    """backbone2 builds with FMA contraction and no fast math, its
    pointwise product is the bf16 mma.sync of the tensor cores, and its
    split rounds to nearest even (the paired conversion, two values at a
    time)."""
    assert kb2.LIBRARY.flags == NVCC_FLAGS_FMA
    assert "--use_fast_math" not in kb2.LIBRARY.flags
    assert "arch=compute_90a,code=sm_90a" in kb2.LIBRARY.flags
    src = open(kb2.LIBRARY.sources[0]).read()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "__floats2bfloat162_rn" in src


# ------------------------------------------------------- the "fast" detector
@pytest.fixture(scope="module")
def fast():
    return flagship_detector(device="cpu", precision="fast")


def _np(batch):
    return {k: np.asarray(getattr(batch, k)) for k in FIELDS}


@pytest.mark.parametrize("images", ["production", "corpus"])
def test_fast_detector_matches_jax_fast(fast, images):
    """e2e_production.npz and 6 parity-corpus images through the port's
    "fast" detector and the JAX detector's: identical detection sets, boxes
    and scores within 1e-3, poses within 0.02 degrees (3x the TPU's
    certified "fast" maximum of 0.0064; the JAX CPU "fast" is fp32 with
    dense-composed convs, the port's CPU "fast" the split-bf16 arithmetic)."""
    from headpose_tpu.pretrained import flagship_detector as jax_flagship

    if images == "production":
        imgs = np.load(os.path.join(GOLDEN, "e2e_production.npz"))["img"][None]
    else:
        imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:6]
    got = _np(fast.detect(imgs))
    want = _np(jax_flagship(precision="fast").detect(imgs))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() >= len(imgs)
    for k, tol in (("boxes", 1e-3), ("keypoints", 1e-3), ("scores", 1e-3),
                   ("poses", 0.02)):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("model", ["flagship", "best"])
def test_fast_detect_against_highest(fast, model):
    """Both shipped models at "fast" against their own "highest" detect on
    6 corpus images: identical sets, poses within 0.05 degrees; detect and
    detect_fused are one path at "fast"."""
    if model == "flagship":
        det, ref = fast, flagship_detector(device="cpu")
    else:
        det = best_detector(device="cpu", precision="fast")
        ref = best_detector(device="cpu")
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][6:12]
    got, want = _np(det.detect(imgs)), _np(ref.detect(imgs))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["poses"], want["poses"], rtol=0,
                               atol=0.05)
    fused = _np(det.detect_fused(imgs))
    for k in FIELDS:
        np.testing.assert_array_equal(fused[k], got[k])


@pytest.fixture(scope="module")
def back():
    """The shipped back-camera model (input 256) as both detectors'
    (spec, params); it is a synthetic bring-up artifact, so loading warns."""
    import warnings

    from headpose_tpu.pretrained import load_pretrained as jax_load

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return load_pretrained("unified-back-distilled"), jax_load(
            "unified-back-distilled")


def test_back_fast_detector_matches_jax_fast(back):
    """unified-back-distilled through the port's "fast" detector and the JAX
    detector's on 6 parity-corpus frames (resized to 256 by the
    preprocess): identical detection sets, at least one face, and
    test_fast_detector_matches_jax_fast's tolerances (boxes and scores 1e-3,
    poses 0.02 degrees)."""
    from headpose_tpu.runtime.detector import FaceDetector as JaxDetector
    from headpose_tpu_torch.runtime.detector import FaceDetector

    (spec, params), (jspec, jparams) = back
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:6]
    got = _np(FaceDetector(spec, params, device="cpu",
                           precision="fast").detect(imgs))
    want = _np(JaxDetector(jspec, jparams, precision="fast").detect(imgs))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() >= 1
    for k, tol in (("boxes", 1e-3), ("keypoints", 1e-3), ("scores", 1e-3),
                   ("poses", 0.02)):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_back_fast_detect_against_highest(back):
    """unified-back-distilled at "fast" against its own "highest" detect on
    6 corpus frames: identical sets, poses within 0.05 degrees (the bound
    test_fast_detect_against_highest holds the front models to); at "fast"
    detect and detect_fused are one path."""
    from headpose_tpu_torch.runtime.detector import FaceDetector

    (spec, params), _ = back
    det = FaceDetector(spec, params, device="cpu", precision="fast")
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][6:12]
    got = _np(det.detect(imgs))
    want = _np(FaceDetector(spec, params, device="cpu").detect(imgs))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() >= 1
    np.testing.assert_allclose(got["poses"], want["poses"], rtol=0, atol=0.05)
    fused = _np(det.detect_fused(imgs))
    for k in FIELDS:
        np.testing.assert_array_equal(fused[k], got[k])
    with pytest.raises(ValueError, match="S/8 and S/16"):
        FaceDetector(spec, params, device="cpu").detect_fused(imgs[:1])


def test_fused_network_fast_uses_apply_fused(fast):
    """fused_network(..., "fast") takes its taps from apply_fused; a
    precision outside PRECISIONS raises."""
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (2, 128, 128, 3)).astype(np.float32))
    out = fused_network(fast.net, x, precision="fast")
    f88, f96 = kb2.apply_fused_plain(fast.net.backbone, x)
    assert torch.equal(out["feat88"], f88) and torch.equal(out["feat96"], f96)
    with pytest.raises(ValueError, match="precision"):
        fused_network(fast.net, x, precision="bf16")


@pytest.mark.parametrize("precision", ["tensorfloat32", "bf16", "bfloat16"])
def test_unserved_precisions_raise(precision):
    """Precisions outside SERVED_PRECISIONS raise: JAX's enum spellings
    ("bfloat16", "tensorfloat32": jax.default_matmul_precision's aliases,
    which no module of the JAX package passes) and any other; the message
    names the six served strings."""
    with pytest.raises(ValueError, match="'highest', 'high', 'fast', "
                                         "'turbo', 'max', 'default'"):
        flagship_detector(device="cpu", precision=precision)
