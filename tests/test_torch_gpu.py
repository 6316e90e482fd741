"""The port on the card: the CUDA postprocess kernel against its plain twin,
and FaceDetector.detect through the kernel against the same pipeline through
the twin, both bit for bit; the fused backbone and pose-head kernels against
their plain versions (rtol 1e-4 / atol 1e-5 and rtol = atol = 1e-5: the
kernels sum in another order than cuBLAS), and detect_fused against detect;
the split-bf16 segment kernel (apply_fused) against its plain version
(SPLIT_TOL) and an fp32 backbone (atol 5e-4), on the flagship and the back
model, and the "fast" detector against the "highest" one; the island
kernels of "turbo" and "max" (dense_block, dense_chain) against their
plain versions (1e-5 of the map a block; a whole chain within one bf16
step of the map), their layouts against the Python mirrors, their detects'
launches, and the empty island against "fast"; the
SE-Transformer head kernel (se_transformer_forward) against its plain
version (rtol 1e-4 / atol 1e-5),
and the SE-Transformer model's detect_fused in both head profiles;
runtime.streaming.detect_stream against detect, the tracking and
smoothing of runtime.tracking and runtime.smoothing on CUDA tensors against
the same on CPU tensors, and head training (train.fit) and the feature
extractor on the card against the CPU.

Marked `gpu`.  Each test skips in the `cuda` fixture when no CUDA device is
present (never at import: every xdist worker must collect the same tests).
The file imports neither jax nor headpose_tpu, and tests/conftest.py imports
jax, so on a machine without JAX run it as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""
import os

import numpy as np
import pytest
import torch

from headpose_tpu_torch.core.activations import ACTIVATIONS
from headpose_tpu_torch.models import (BLAZEFACE_BACK, BlazeFace, BlazeFaceNet,
                                       MLPHead)
from headpose_tpu_torch.models.anchors import generate_anchors
from headpose_tpu_torch.models.heads import (MLPHeadNet, SETransformerHead,
                                             SETransformerHeadNet)
from headpose_tpu_torch.ops import detection as det
from headpose_tpu_torch.ops.image import preprocess
from headpose_tpu_torch.ops.kernels import backbone as kbb
from headpose_tpu_torch.ops.kernels import backbone2 as kb2
from headpose_tpu_torch.ops.kernels import head_mlp as khead
from headpose_tpu_torch.ops.kernels import postprocess as kern
from headpose_tpu_torch.ops.kernels import se_attention as kse

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, seed, loc_std=8.0, quantize=False, nonfinite=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, (b, 896)).astype(np.float32)
    if quantize:
        logits = np.round(logits).astype(np.float32)   # exact score ties
    loc = rng.normal(0.0, loc_std, (b, 896, 16)).astype(np.float32)
    pf = rng.normal(0, 0.5, (b, 16, 16, 3)).astype(np.float32)
    pb = rng.normal(0, 0.5, (b, 8, 8, 3)).astype(np.float32)
    if nonfinite:
        logits[0, 5], logits[-1, 7], logits[0, 700] = np.nan, -np.inf, np.inf
        logits[-1, 9] = 1e30
        loc[0, 3, :] = np.nan
        loc[-1, 11, 2], loc[0, 12, 5] = np.inf, -np.inf
    return logits, loc, pf, pb


def _assert_equal(got, want):
    for k in FIELDS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", [
    dict(b=1, thr=0.0, iou=0.3, mf=100, seed=6),
    dict(b=3, thr=0.4, iou=0.01, mf=32, seed=8),
    dict(b=3, thr=1.0, iou=0.3, mf=16, seed=2),
    dict(b=128, thr=0.4, iou=0.3, mf=100, seed=1),
    dict(b=128, thr=0.4, iou=0.3, mf=32, seed=11, quantize=True),
    dict(b=3, thr=0.0, iou=0.3, mf=256, seed=14, nonfinite=True),
    dict(b=3, thr=0.4, iou=0.3, mf=1, seed=3),
    dict(b=8, thr=0.4, iou=0.3, mf=100, seed=21, size=256),
])
def test_kernel_matches_twin(cuda, case):
    """The kernel, from the raw network outputs to the finished slab in one
    launch, bit for bit against the plain chain: thresholds 0 and 1, exact
    score ties, non-finite logits and loc, one slot, 256 slots, the back
    model's anchors."""
    from headpose_tpu_torch.models.anchors import BACK_CONFIG, FRONT_CONFIG

    case = dict(case)
    size = case.pop("size", 128)
    kw = dict(score_threshold=case.pop("thr"), iou_threshold=case.pop("iou"),
              max_faces=case.pop("mf"), input_size=size)
    args = [torch.from_numpy(x).to(cuda) for x in _inputs(**case)]
    anchors = torch.tensor(generate_anchors(
        BACK_CONFIG if size == 256 else FRONT_CONFIG).astype(np.float32),
        device=cuda)
    before = kern.postprocess_kernel.launches
    got = kern.postprocess_kernel(*args, anchors, **kw)
    want = det.postprocess(*args, anchors, **kw)
    torch.cuda.synchronize()
    assert kern.postprocess_kernel.launches == before + 1
    _assert_equal(got, want)


def test_detect_through_kernel_equals_twin(cuda):
    from headpose_tpu_torch.pretrained import flagship_detector

    flagship = flagship_detector()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:16]
    before = kern.postprocess_kernel.launches
    batch = flagship.detect(imgs)
    assert kern.postprocess_kernel.launches == before + 1
    with torch.inference_mode():
        out = flagship.net(preprocess(torch.from_numpy(imgs).to(cuda)))
        want = det.postprocess(out["scores"], out["loc"], out["pose_front"],
                               out["pose_back"], flagship.anchors)
    _assert_equal({k: getattr(batch, k) for k in FIELDS}, want)
    assert int(batch.valid.sum()) >= 16


def test_kernel_rejects_what_it_does_not_take(cuda):
    logits, loc, pf, pb = (torch.from_numpy(x).to(cuda)
                           for x in _inputs(2, 0))
    anchors = torch.tensor(generate_anchors().astype(np.float32), device=cuda)
    strided = torch.zeros((2, 16, 896), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kern.postprocess_slab_cuda(logits, strided, pf, pb, anchors)
    with pytest.raises(ValueError):
        kern.postprocess_slab_cuda(logits, loc.cpu(), pf, pb, anchors)
    with pytest.raises(ValueError, match="power-of-two"):
        kern.postprocess_slab_cuda(logits, loc, pf, pb, anchors,
                                   input_size=192)
    # an expanded (batch stride 0) pose map is taken as it is
    got = kern.postprocess_slab_cuda(logits, loc, pf[:1].expand(2, -1, -1, -1),
                                     pb, anchors, score_threshold=0.0)
    want = det.postprocess(logits, loc, pf[:1].expand(2, -1, -1, -1), pb,
                           anchors, score_threshold=0.0)
    torch.cuda.synchronize()
    assert torch.equal(got[..., 16:19], want["poses"])


def test_empty_batch_launches_nothing(cuda):
    args = [torch.from_numpy(x).to(cuda)[:0] for x in _inputs(1, 0)]
    anchors = torch.tensor(generate_anchors().astype(np.float32), device=cuda)
    before = kern.postprocess_kernel.launches
    out = kern.postprocess_kernel(*args, anchors)
    assert out["valid"].shape == (0, 100)
    assert kern.postprocess_kernel.launches == before


# ------------------------------------------------ fused backbone and heads
NARROW = BlazeFace(input_size=32, stem_features=8,
                   block_channels=(8, 12, 16, 16, 20),
                   downsample_blocks=(0, 1, 3), tap88_block=2)


def _random_init(net, seed):
    """Glorot-uniform weights and small normal biases, made with numpy."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in net.parameters():
            if p.ndim == 1:
                v = rng.normal(0, 0.05, tuple(p.shape))
            else:
                fan = p.shape[1] * (p.shape[2] * p.shape[3] if p.ndim == 4
                                    else 1)
                lim = np.sqrt(6.0 / (fan + p.shape[0]))
                v = rng.uniform(-lim, lim, tuple(p.shape))
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return net


@pytest.fixture(scope="module")
def flagship(cuda):
    from headpose_tpu_torch.pretrained import flagship_detector

    return flagship_detector()


def test_xla_postprocess_is_refused_on_the_card(cuda, flagship):
    """postprocess='xla' (the plain chain) runs on the CPU only: on the card
    kernel #1 serves the same slab, and asking for the plain chain raises,
    at construction and when the attribute is set later."""
    from headpose_tpu_torch.pretrained import FLAGSHIP, load_pretrained
    from headpose_tpu_torch.runtime.detector import FaceDetector

    model, params = load_pretrained(FLAGSHIP)
    with pytest.raises(ValueError, match="CPU only"):
        FaceDetector(model, params, postprocess="xla")
    flagship.postprocess = "xla"
    try:
        with pytest.raises(ValueError, match="CPU only"):
            flagship.detect(_corpus(1))
    finally:
        flagship.postprocess = "auto"


def _corpus(b):
    """b parity-corpus frames (the 112 repeated from the start past 112)."""
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"]
    return np.concatenate([imgs, imgs])[:b]


@pytest.mark.parametrize("case", ["flagship_b1", "flagship_b3",
                                  "flagship_b128", "narrow_b4"])
def test_backbone_kernel_matches_plain(cuda, flagship, case):
    if case.startswith("flagship"):
        net = flagship.net.backbone
        x = preprocess(torch.from_numpy(_corpus(int(case.split("_b")[1])))
                       .to(cuda))
    else:
        net = _random_init(BlazeFaceNet(NARROW, device=cuda), 5)
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            -1, 1, (4, 32, 32, 3)).astype(np.float32)).to(cuda)
    before = kbb.backbone_forward.launches
    got = kbb.backbone_forward(net, x)
    want = kbb.backbone_forward_plain(net, x)
    torch.cuda.synchronize()
    assert kbb.backbone_forward.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layer", ["stem", "block0", "block1", "block2",
                                   "block5", "block11", "narrow_block3"])
def test_stem_and_block_kernels_match_plain(cuda, flagship, layer):
    """The stem and single blocks through headpose_backbone_stem /
    headpose_backbone_block (the split-bf16 backbone's fp32 layers) against
    the plain version's layers: the flagship's 64x64 layers, its stride-2
    blocks (block 5 takes 42 channels: not a multiple of 4) and a narrow
    spec's 4x4 block, at rtol 1e-4 / atol 1e-5."""
    net = (flagship.net.backbone if layer != "narrow_block3"
           else _random_init(BlazeFaceNet(NARROW, device=cuda), 3))
    w = list(kbb._leaves(net))
    rng = np.random.default_rng(len(layer))
    if layer == "stem":
        x = preprocess(torch.from_numpy(_corpus(5)).to(cuda))
        got = kbb.stem_forward_cuda(net, x)
        want = torch.relu(kbb._stem(x, w[0], w[1]))
    else:
        i = int(layer.split("block")[1])
        sizes = kbb._check_domain(net.spec)
        h = sizes[i - 1] if i else net.spec.input_size // 2
        cin = (net.spec.stem_features, *net.spec.block_channels)[i]
        x = torch.from_numpy(np.abs(rng.normal(0, 1, (3, h, h, cin))).astype(
            np.float32)).to(cuda)
        got = kbb.block_forward_cuda(net, i, x)
        stride = 2 if i in net.spec.downsample_blocks else 1
        want = kbb._block(x, *w[2 + 4 * i:6 + 4 * i], stride)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["flagship.head88", "flagship.head96",
                                  "best.head88", "best.head96", "gelu",
                                  "selu", "softplus", "ragged_513"])
def test_head_kernel_matches_plain(cuda, case):
    from headpose_tpu_torch.pretrained import BEST, FLAGSHIP, load_pretrained
    from headpose_tpu_torch.tools.convert import params_from_jax

    if "." in case:
        model, head = case.split(".")
        spec, params = load_pretrained(FLAGSHIP if model == "flagship"
                                       else BEST)
        hspec = getattr(spec, head)
        net = MLPHeadNet(hspec, device=cuda)
        net.load_state_dict(params_from_jax(hspec, params[head]))
        k = hspec.in_features
        x = np.load(os.path.join(GOLDEN, "heads.npz"))[f"xmap{k}"].reshape(
            -1, k)
    else:
        act = "tanh" if case == "ragged_513" else case
        net = _random_init(MLPHeadNet(MLPHead(88, ((16, act), (3, "linear"))),
                                      device=cuda), 1)
        x = np.random.default_rng(1).normal(
            0, 2, (513 if case == "ragged_513" else 64, 88)).astype(np.float32)
    x = torch.from_numpy(x).to(cuda)
    before = khead.mlp_head_forward.launches
    got = khead.mlp_head_forward(net, x)
    want = khead.mlp_head_forward_plain(net, x)
    torch.cuda.synchronize()
    assert khead.mlp_head_forward.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _edge_head(case, cuda, flagship):
    """(net, rows) of a case on the kernel's edges: unified-best-distilled's
    heads on the flagship's B=128 maps, ragged N on its head88, widths that
    are not multiples of 4 under each activation, the 32- and 16-row tiles
    of wide layers, 8 layers, C % 4 != 0 and rows not 16-byte aligned."""
    from headpose_tpu_torch.pretrained import BEST, load_pretrained
    from headpose_tpu_torch.tools.convert import params_from_jax

    rng = np.random.default_rng(len(case))
    if case.startswith("best") or case.startswith("n"):
        spec, params = load_pretrained(BEST)
        head = case.split(".")[1].split("_")[0] if "." in case else "head88"
        hspec = getattr(spec, head)
        net = MLPHeadNet(hspec, device=cuda)
        net.load_state_dict(params_from_jax(hspec, params[head]))
        if case.startswith("best"):
            with torch.inference_mode():
                o = flagship.net(preprocess(torch.from_numpy(
                    _corpus(128)).to(cuda)))
            k = hspec.in_features
            return net, o[f"feat{k}"].reshape(-1, k).contiguous()
        x = rng.normal(0, 1, (int(case[1:]), 88))
        return net, torch.from_numpy(x.astype(np.float32)).to(cuda)
    layers, c, n = {
        "tile32": (((640, "relu"), (3, "linear")), 512, 100),
        "tile16": (((896, "gelu"), (8, "tanh"), (3, "linear")), 896, 70),
        "eight_layers": (tuple((w, a) for w, a in zip(
            (40, 24, 13, 30, 9, 17, 6), ("elu", "swish", "sigmoid",
                                         "softplus", "selu", "leaky_relu",
                                         "softsign"))) + ((3, "linear"),),
            96, 130),
        "c37": (((16, "tanh"), (3, "linear")), 37, 65),
        "unaligned": (((64, "softsign"), (3, "linear")), 88, 65),
    }.get(case, (((37, case[7:]), (5, case[7:]), (3, "linear")), 88, 200))
    net = _random_init(MLPHeadNet(MLPHead(c, layers), device=cuda), 3)
    flat = torch.from_numpy(rng.normal(0, 2, n * c + 1).astype(
        np.float32)).to(cuda)
    x = (flat[1:] if case == "unaligned" else flat[:-1]).view(n, c)
    return net, x


EDGE_CASES = (["best.head88_b128", "best.head96_b128", "n1", "n15", "n63",
               "n64", "n65", "n513", "tile32", "tile16", "eight_layers",
               "c37", "unaligned"] + [f"padded_{a}" for a in ACTIVATIONS])


@pytest.mark.parametrize("case", EDGE_CASES)
def test_head_kernel_edges_match_plain(cuda, flagship, case):
    """One launch each, within rtol = atol = 1e-5 of the plain version."""
    net, x = _edge_head(case, cuda, flagship)
    before = khead.mlp_head_forward.launches
    got = khead.mlp_head_forward(net, x)
    want = khead.mlp_head_forward_plain(net, x)
    torch.cuda.synchronize()
    assert khead.mlp_head_forward.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("images", ["corpus", "production"])
def test_detect_fused_matches_detect(cuda, flagship, images):
    """16 corpus frames (128x128) and e2e_production.npz (256x256: the
    resize path)."""
    if images == "corpus":
        imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:16]
    else:
        imgs = np.load(os.path.join(GOLDEN, "e2e_production.npz"))["img"]
    before = (kbb.backbone_forward.launches, khead.mlp_head_forward.launches)
    got = flagship.detect_fused(imgs)
    assert (kbb.backbone_forward.launches,
            khead.mlp_head_forward.launches) == (before[0] + 1, before[1] + 2)
    want = flagship.detect(imgs)
    assert torch.equal(got.valid, want.valid)
    assert int(want.valid.sum()) >= 1
    for k, tol in (("boxes", 1e-4), ("scores", 1e-4), ("poses", 5e-4)):
        err = (getattr(got, k) - getattr(want, k)).abs().max()
        assert float(err) <= tol, k


def test_fused_kernels_reject_what_they_do_not_take(cuda, flagship):
    net = flagship.net.backbone
    x = torch.zeros((2, 3, 128, 128), device=cuda).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kbb.backbone_forward_cuda(net, x)
    with pytest.raises(ValueError, match="CUDA"):
        kbb.backbone_forward_cuda(net, x.cpu().contiguous())
    head = flagship.net.head88
    rows = torch.zeros((88, 8), device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        khead.mlp_head_forward_cuda(head, rows)
    with pytest.raises(ValueError, match=r"\(N, 88\)"):
        khead.mlp_head_forward_cuda(head, torch.zeros((8, 96), device=cuda))


# ------------------------------------------------ split-bf16 segment backbone
# the flagship's widths with segment D widening to 128 channels (the
# kernel's widest instance)
WIDE_D = BlazeFace(block_channels=(24, 28, 32, 36, 42, 48, 56, 64, 72, 80,
                                   88, 96, 104, 112, 120, 128))


@pytest.mark.parametrize("case", ["flagship_b1", "flagship_b8",
                                  "wide_d_b2", "back_b1", "back_b8"])
def test_apply_fused_kernel_matches_plain(cuda, flagship, case):
    """The segment kernels (mma.sync bf16 -> fp32, another sum order than
    the plain version's fp32 matmuls; per-block launches on the large maps,
    one launch for each run of small-map blocks), within SPLIT_TOL of the plain version and 5e-4 of an fp32 backbone (the
    fp32 backbone_forward kernel; for the back model, whose taps that kernel
    does not take, its cuDNN BlazeFaceNet), on corpus frames (resized to
    256 for the back model) and a random-init spec whose segment D widens
    to 128 channels."""
    import warnings

    from headpose_tpu_torch.pretrained import load_pretrained
    from headpose_tpu_torch.runtime.detector import FaceDetector

    b = int(case.split("_b")[1])
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:b]
    if case.startswith("back"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            net = FaceDetector(*load_pretrained(
                "unified-back-distilled")).net.backbone
    elif case.startswith("flagship"):
        net = flagship.net.backbone
    else:
        net = _random_init(BlazeFaceNet(WIDE_D, device=cuda), 7)
    x = preprocess(torch.from_numpy(imgs).to(cuda),
                   net.spec.input_size).contiguous()   # the resize's view
    before = (kb2.apply_fused.launches, kb2.run_segment.launches)
    got = kb2.apply_fused(net, x)
    want = kb2.apply_fused_plain(net, x)
    if case.startswith("back"):
        with torch.inference_mode():
            out = net(x)
        fp32 = (out["feat88"], out["feat96"])
    else:
        fp32 = kbb.backbone_forward_cuda(net, x)
    torch.cuda.synchronize()
    assert (kb2.apply_fused.launches,
            kb2.run_segment.launches) == (before[0] + 1, before[1] + 4)
    for g, w, f in zip(got, want, fp32):
        torch.testing.assert_close(g, w, **kb2.SPLIT_TOL)
        torch.testing.assert_close(g, f, rtol=0, atol=5e-4)


def test_fast_detect_matches_highest(cuda, flagship):
    """e2e_production.npz (the resize path) through precision="fast" and
    "highest": identical detection sets, poses within 0.05 degrees."""
    from headpose_tpu_torch.pretrained import flagship_detector

    fast = flagship_detector(precision="fast")
    img = np.load(os.path.join(GOLDEN, "e2e_production.npz"))["img"]
    before = kb2.apply_fused.launches
    got = fast.detect(img)
    assert kb2.apply_fused.launches == before + 1
    want = flagship.detect(img)
    assert torch.equal(got.valid, want.valid)
    assert int(want.valid.sum()) >= 1
    assert float((got.poses - want.poses).abs().max()) < 0.05


def test_back_fast_detect_matches_highest(cuda):
    """unified-back-distilled (input 256) at "fast" (every block through
    the split-bf16 kernel) and "highest" (cuDNN) on 16 corpus frames:
    identical detection sets, at least one face, poses within 0.05."""
    import warnings

    from headpose_tpu_torch.pretrained import load_pretrained
    from headpose_tpu_torch.runtime.detector import FaceDetector

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spec, params = load_pretrained("unified-back-distilled")
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:16]
    before = kb2.apply_fused.launches
    got = FaceDetector(spec, params, precision="fast").detect(imgs)
    assert kb2.apply_fused.launches == before + 1
    want = FaceDetector(spec, params).detect(imgs)
    assert torch.equal(got.valid, want.valid)
    assert int(want.valid.sum()) >= 1
    assert float((got.poses - want.poses).abs().max()) < 0.05


# ------------------------------------------- single-pass bf16 islands
@pytest.mark.parametrize("case", ["flagship_b3", "back_b2", "wide_d_b2"])
def test_island_kernel_matches_plain(cuda, flagship, case):
    """The island kernel (mma.sync bf16 -> fp32 on the same bf16 operands
    as its plain version, another fp32 sum order) block by block on the
    "max" plan's inputs (every block of the flagship, the back model, and a
    random-init spec widening to 128 channels), within 1e-5 of the map's
    largest |value|; one launch counted per block."""
    import warnings

    from headpose_tpu_torch.ops.kernels import dense_bf16 as kd
    from headpose_tpu_torch.pretrained import load_pretrained
    from headpose_tpu_torch.runtime.detector import FaceDetector

    b = int(case.split("_b")[1])
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:b]
    if case.startswith("back"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            net = FaceDetector(*load_pretrained(
                "unified-back-distilled")).net.backbone
    elif case.startswith("flagship"):
        net = flagship.net.backbone
    else:
        net = _random_init(BlazeFaceNet(WIDE_D, device=cuda), 7)
    x = preprocess(torch.from_numpy(imgs).to(cuda),
                   net.spec.input_size).contiguous()
    island = tuple(range(len(net.blocks)))
    inputs = kb2.segment_inputs(net, x, kb2.pack_backbone(net), island)
    for i in island:
        before = kd.dense_block.launches
        got = kd.dense_block(net, i, inputs[i])
        assert kd.dense_block.launches == before + 1
        want = kd.dense_block_plain(net, i, inputs[i])
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_island_kernel_rejects_what_it_does_not_take(cuda, flagship):
    from headpose_tpu_torch.ops.kernels import dense_bf16 as kd

    net = flagship.net.backbone
    with pytest.raises(ValueError, match="float32"):
        kd.dense_block(net, 12, torch.zeros((1, 8, 8, 96), device=cuda,
                                            dtype=torch.float16))
    with pytest.raises(ValueError, match="even map"):
        kd.dense_block(net, 11, torch.zeros((1, 15, 15, 88), device=cuda))
    empty = kd.dense_block(net, 12, torch.zeros((0, 8, 8, 96), device=cuda))
    assert tuple(empty.shape) == (0, 8, 8, 96)


@pytest.mark.parametrize("mode", ["turbo", "max"])
def test_turbo_and_max_detect_launch_the_island_kernel(cuda, flagship, mode):
    """One detect launches exactly the island plan's kernels
    (`island_chains`: at "turbo" one chain launch for blocks 10-15, at
    "max" blocks 0-5 one launch each and one chain launch for 6-15) and the
    split-bf16 kernel over the plan's segments (A, B, C 6-9 at "turbo",
    none at "max"); identical detection sets to "highest" on
    e2e_production.npz and poses within the JAX certificate's pose max of
    the mode (4.21 and 4.89 degrees)."""
    from headpose_tpu_torch.ops.kernels import dense_bf16 as kd
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.runtime.fused import island_of

    det = flagship_detector(precision=mode)
    spec = flagship.net.backbone.spec
    island = island_of(spec, mode)
    steps = kd.island_chains(spec, island)
    img = np.load(os.path.join(GOLDEN, "e2e_production.npz"))["img"]
    before = (kd.dense_block.launches, kd.dense_chain.launches,
              kb2.run_segment.launches)
    got = det.detect(img)
    torch.cuda.synchronize()
    assert (kd.dense_block.launches - before[0],
            kd.dense_chain.launches - before[1],
            kb2.run_segment.launches - before[2]) == (
        sum(s[0] == "block" for s in steps),
        sum(s[0] == "chain" for s in steps),
        len(kb2.segment_plan(spec, island)))
    assert steps == ((("chain", 10, 15),) if mode == "turbo" else
                     tuple(("block", i) for i in range(6)) + (
                         ("chain", 6, 15),))
    want = flagship.detect(img)
    assert torch.equal(got.valid, want.valid)
    tol = {"turbo": 4.21, "max": 4.89}[mode]
    assert float((got.poses - want.poses).abs().max()) < tol


def _island_net(cuda, flagship, case):
    import warnings

    from headpose_tpu_torch.pretrained import load_pretrained
    from headpose_tpu_torch.runtime.detector import FaceDetector

    if case.startswith("back"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return FaceDetector(*load_pretrained(
                "unified-back-distilled")).net.backbone
    if case.startswith("flagship"):
        return flagship.net.backbone
    return _random_init(BlazeFaceNet(WIDE_D, device=cuda), 7)


# one bf16 step of the map's largest |value| (tests/
# test_torch_island_chain.py::CHAIN_TOL_FRAC)
CHAIN_TOL_FRAC = 2.0 ** -7


@pytest.mark.parametrize("case", ["flagship_b3", "back_b2", "wide_d_b2",
                                  "flagship_b128"])
def test_island_chain_matches_plain(cuda, flagship, case):
    """Every chain of the "turbo" and "max" plans (the flagship, the back
    model, the wide spec), on the backbone's own map in front of it: (a)
    block by block, each of the kernel's prefix chains first..k against
    dense_block_plain of block k on the prefix first..k-1's map (the
    chain's own intermediate: the kernel computes a block the same way
    whatever follows it, and the whole chain equals its longest prefix and
    its tap its prefix to the tap bit for bit) within 1e-5 of the map's
    largest |value|, the island block's own tolerance; (b) the whole chain
    against dense_chain_plain within CHAIN_TOL_FRAC of the map's largest
    |value| (an fp32 ulp before a block's bf16 rounding can move an element
    a bf16 step, and the blocks after it carry that on).  One launch counted
    per call."""
    from headpose_tpu_torch.ops.kernels import dense_bf16 as kd
    from headpose_tpu_torch.runtime.fused import island_of

    b = int(case.split("_b")[1])
    imgs = _corpus(b)
    net = _island_net(cuda, flagship, case)
    x = preprocess(torch.from_numpy(imgs).to(cuda),
                   net.spec.input_size).contiguous()
    inputs = kb2.segment_inputs(net, x, kb2.pack_backbone(net),
                                tuple(range(len(net.blocks))))
    chains = {s for mode in ("turbo", "max")
              for s in kd.island_chains(net.spec, island_of(net.spec, mode))
              if s[0] == "chain"}
    assert chains
    tap = net.spec.tap88_block
    for _, first, last in sorted(chains):
        y0 = inputs[first]
        before = kd.dense_chain.launches
        got, got_tap = kd.dense_chain(net, first, last, y0)
        assert kd.dense_chain.launches == before + 1
        prev = y0
        for k in range(first, last + 1):                          # (a)
            cur, t = kd.dense_chain_cuda(net, first, k, y0)
            want = kd.dense_block_plain(net, k, prev)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                cur, want, rtol=0, atol=1e-5 * float(want.abs().max()))
            if k == tap:
                assert torch.equal(got_tap, cur)
            prev = cur
        assert torch.equal(got, prev)
        if not first <= tap <= last:
            assert got_tap is None
        want, want_tap = kd.dense_chain_plain(net, first, last, y0)  # (b)
        for g, w in ((got, want), (got_tap, want_tap)):
            if w is not None:
                torch.testing.assert_close(
                    g, w, rtol=0,
                    atol=CHAIN_TOL_FRAC * float(w.abs().max()))


@pytest.mark.parametrize("model", ["flagship", "back"])
def test_island_is_batch_invariant(cuda, flagship, model):
    """An image's maps do not depend on its place in the batch: at "turbo"
    and "max", apply_fused over 3 corpus frames gives each frame's feat88
    and feat96 bit for bit as apply_fused over that frame alone (every
    island block and chain sums its taps in one order for every image,
    whatever tiles the batch gives the block kernel)."""
    from headpose_tpu_torch.runtime.fused import island_of

    net = _island_net(cuda, flagship, model)
    x = preprocess(torch.from_numpy(_corpus(3)).to(cuda),
                   net.spec.input_size).contiguous()
    for mode in ("turbo", "max"):
        island = island_of(net.spec, mode)
        whole = kb2.apply_fused(net, x, island)
        for j in range(3):
            alone = kb2.apply_fused(net, x[j:j + 1], island)
            for w, a in zip(whole, alone):
                assert torch.equal(w[j], a[0]), (mode, j)


@pytest.mark.parametrize("mode", ["turbo", "max"])
def test_turbo_and_max_detect_is_batch_invariant(cuda, mode):
    """detect([a, b]) answers b as detect([b]) does: the backbone's maps
    bit for bit (test_island_is_batch_invariant), so the same detection
    set; boxes, keypoints and scores within 1e-5 and poses within 1e-3
    degrees, the serve phase's bounds for one answer through two routes
    (the SSD 1x1 heads are cuBLAS GEMMs over B x cells rows, whose sum
    order may change with the row count: at "max" the boxes of one such
    pair differed in the last bits)."""
    from headpose_tpu_torch.pretrained import flagship_detector

    det = flagship_detector(precision=mode)
    imgs = _corpus(2)
    pair, alone = det.detect(imgs), det.detect(imgs[1:2])
    assert torch.equal(pair.valid[1], alone.valid[0])
    assert int(alone.valid.sum()) >= 1
    for k, tol in (("boxes", 1e-5), ("keypoints", 1e-5), ("scores", 1e-5),
                   ("poses", 1e-3)):
        torch.testing.assert_close(getattr(pair, k)[1], getattr(alone, k)[0],
                                   rtol=0, atol=tol)


def test_island_chain_rejects_what_it_does_not_take(cuda, flagship):
    """A float16 input, a run the plan does not make a chain, another
    input side: ValueError, no launch; an empty batch: empty maps (the tap
    too), no launch."""
    from headpose_tpu_torch.ops.kernels import dense_bf16 as kd

    net = flagship.net.backbone
    before = kd.dense_chain.launches
    with pytest.raises(ValueError, match="float32"):
        kd.dense_chain(net, 12, 15, torch.zeros(
            (1, 8, 8, 96), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="not a chain"):
        kd.dense_chain(net, 5, 7, torch.zeros((1, 32, 32, 42), device=cuda))
    with pytest.raises(ValueError, match="takes"):
        kd.dense_chain(net, 12, 15, torch.zeros((1, 16, 16, 96),
                                                device=cuda))
    y, t = kd.dense_chain(net, 10, 15, torch.zeros((0, 16, 16, 80),
                                                   device=cuda))
    assert tuple(y.shape) == (0, 8, 8, 96) and tuple(t.shape) == (
        0, 16, 16, 88)
    assert kd.dense_chain.launches == before


def test_island_plans_match_the_kernel(cuda):
    """The island plans against the library's own: every block of the
    front, back and wide specs at B = 1, 3, 128 has a tile plan of the
    block kernel (`tile_plan`, headpose_dense_bf16_block_plan) within a
    block's shared memory, at 1 to 16 output rows a tile; the Python mirror
    of the chain kernel's layout (`chain_plan`, which `island_chains`
    reads) equals headpose_dense_bf16_chain_plan on every small-map run of
    "max", and a run that fits no chain."""
    import ctypes

    from headpose_tpu_torch.ops.kernels import dense_bf16 as kd
    from headpose_tpu_torch.ops.kernels.packing import c_ints

    lib = kd.LIBRARY.load()
    too_wide = BlazeFace(input_size=32, stem_features=128,
                         block_channels=(128, 128), downsample_blocks=(1,),
                         tap88_block=0)
    for spec in (BlazeFace(), BLAZEFACE_BACK, WIDE_D, too_wide):
        for cin, cout, s, h in kd._shapes(spec):
            for b in (1, 3, 128):
                plan = kd.tile_plan(b, h, cin, cout, s)
                assert plan is not None and plan[2] <= kd.SMEM_MAX
                assert 1 <= plan[1] <= min(16, h // s)
        n = len(spec.block_channels)
        runs = {(first, n - 1) for first in range(n)
                if kd._shapes(spec)[first][3] ** 2 <= kd.CHAIN_PIXELS}
        for first, last in runs:
            channels, strides, h = kd._chain_args(spec, first, last)
            out = (ctypes.c_int * 4)()
            rc = lib.headpose_dense_bf16_chain_plan(
                c_ints(channels), c_ints(strides), len(strides), h, out)
            want = kd.chain_plan(channels, strides, h)
            assert (rc == 0) == (want is not None)
            if want is not None:
                assert tuple(out) == want


def test_empty_island_is_fast_on_the_card(cuda, flagship):
    """turbo_island=() gives the "fast" slabs bit for bit."""
    from headpose_tpu_torch.pretrained import flagship_detector

    imgs = _corpus(16)
    a = flagship_detector(precision="turbo", turbo_island=()).detect(imgs)
    b = flagship_detector(precision="fast").detect(imgs)
    _assert_equal({k: getattr(a, k) for k in FIELDS},
                  {k: getattr(b, k) for k in FIELDS})


# ------------------------------------------------- SE-Transformer head
def _se_head(cuda, seed, **fields):
    """A random SE-Transformer head, with the limits of the JAX init
    (Glorot-uniform kernels; q/k/v and attn_out at sqrt(6 / (C + H D)));
    biases N(0, 0.05), LayerNorm gains 1 + N(0, 0.05); numpy, seeded."""
    net = SETransformerHeadNet(SETransformerHead(**fields), device=cuda)
    rng = np.random.default_rng(seed)
    s = net.spec
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith((".bias", ".b")):
                v = rng.normal(0, 0.05, tuple(p.shape))
            elif name.endswith(".g"):
                v = 1 + rng.normal(0, 0.05, tuple(p.shape))
            else:
                fans = (s.in_features + s.num_heads * s.key_dim
                        if p.ndim == 3 else sum(p.shape))
                lim = np.sqrt(6.0 / fans)
                v = rng.uniform(-lim, lim, tuple(p.shape))
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return net


@pytest.mark.parametrize("case", ["flagship88_b1", "flagship96_b1",
                                  "flagship88_b8", "flagship96_b8",
                                  "flagship88_b128", "flagship96_b128",
                                  "rows_n1", "rows_n100", "rows_n12800",
                                  "narrow_2x8", "one_head", "maps_5x5",
                                  "heads8_kd8", "key_dim32"])
def test_se_kernel_matches_plain(cuda, flagship, case):
    """The kernel (3-pass TF32 tensor-core products, another sum order, an
    online softmax) against its plain version at rtol 1e-4 / atol 1e-5: the
    flagship's taps at B in {1, 8, 128}, T = 1 rows (the path without
    attention) at N in {1, 100, 12800}, a 2 x 8 head, a one-head spec, 5x5
    maps (T = 25: ragged key blocks and query tiles that span images), 8
    heads of 8 and 2 heads of 32 on random maps."""
    c = 96 if "96" in case or case == "narrow_2x8" else 88
    fields = {"narrow_2x8": dict(num_heads=2, key_dim=8),
              "one_head": dict(num_heads=1),
              "heads8_kd8": dict(num_heads=8, key_dim=8),
              "key_dim32": dict(num_heads=2, key_dim=32)}.get(case, {})
    net = _se_head(cuda, 11, in_features=c, **fields)
    if case.startswith("flagship"):
        b = int(case.split("_b")[1])
        with torch.inference_mode():
            out = flagship.net(preprocess(torch.from_numpy(_corpus(b))
                                          .to(cuda)))
        x = out["feat88" if c == 88 else "feat96"].clone()
    else:
        shape = ((int(case.split("_n")[1]), 1, 1, c) if case.startswith("rows")
                 else (3, 5, 5, c) if case == "maps_5x5"
                 else (3, 8, 8, c) if c == 96 else (2, 16, 16, c))
        x = torch.from_numpy(np.random.default_rng(4).normal(
            0, 1, shape).astype(np.float32)).to(cuda)
    before = kse.se_transformer_forward.launches
    got = kse.se_transformer_forward(net, x)
    want = kse.se_transformer_forward_plain(net, x)
    torch.cuda.synchronize()
    assert kse.se_transformer_forward.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_se_kernel_rejects_what_it_does_not_take(cuda):
    net = _se_head(cuda, 1, in_features=88)
    x = torch.zeros((2, 88, 4, 4), device=cuda).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kse.se_transformer_forward_cuda(net, x)
    with pytest.raises(ValueError, match="num_heads"):
        kse.se_transformer_forward_cuda(
            _se_head(cuda, 1, in_features=88, num_heads=3),
            torch.zeros((1, 4, 4, 88), device=cuda))


@pytest.mark.parametrize("head_eval", ["map", "survivors"])
def test_se_model_detect_fused_launches_the_kernel(cuda, flagship,
                                                   head_eval):
    """The flagship's backbone with two random-init SE-Transformer heads:
    detect_fused launches the kernel twice (both maps, or both heads' rows)
    and gives detect's detections and poses."""
    from headpose_tpu_torch.models.unified import UnifiedPoseModel
    from headpose_tpu_torch.runtime.detector import FaceDetector
    from headpose_tpu_torch.tools.convert import params_to_jax

    spec = UnifiedPoseModel(backbone=flagship.model.backbone,
                            head88=SETransformerHead(88),
                            head96=SETransformerHead(96))
    params = {"backbone": params_to_jax(flagship.model.backbone,
                                        flagship.net.backbone.state_dict())}
    for name, c in (("head88", 88), ("head96", 96)):
        head = _se_head(cuda, c, in_features=c)
        params[name] = params_to_jax(head.spec, head.state_dict())
    det = FaceDetector(spec, params, head_eval=head_eval)
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:8]
    before = kse.se_transformer_forward.launches
    got = det.detect_fused(imgs)
    assert kse.se_transformer_forward.launches == before + 2
    want = det.detect(imgs)
    assert torch.equal(got.valid, want.valid)
    assert int(want.valid.sum()) >= 8
    for k in ("boxes", "scores"):
        assert float((getattr(got, k) - getattr(want, k)).abs().max()) \
            <= 1e-4, k
    torch.testing.assert_close(got.poses, want.poses, rtol=1e-4, atol=1e-4)


def test_detect_stream_matches_detect(cuda, flagship):
    """detect_stream over 48 corpus frames in batches of 16 (pinned staging,
    copies on a side stream, prefetch 2): each slab equals that batch's
    detect, and the results come in order."""
    from headpose_tpu_torch.runtime.streaming import detect_stream

    imgs = _corpus(48)
    batches = [imgs[i:i + 16] for i in range(0, 48, 16)]
    got = list(detect_stream(flagship, iter(batches), prefetch=2))
    assert len(got) == len(batches)
    for batch, out in zip(batches, got):
        want = flagship.detect(batch)
        assert out.slab.device.type == "cuda"
        assert torch.equal(out.valid, want.valid)
        torch.testing.assert_close(out.slab, want.slab, rtol=0.0, atol=1e-6)


def _timeline_gpu(seed, N=12, F=6, faces=8):
    """Seeded boxes, validity and poses with duplicate boxes (IoU ties) and
    more faces than slots when tracked with 5 slots."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (faces, 2))
    half = rng.uniform(0.05, 0.12, (faces, 1))
    boxes = rng.uniform(0.0, 1.0, (N, F, 4)).astype(np.float32)
    poses = rng.normal(0.0, 30.0, (N, F, 3)).astype(np.float32)
    valid = np.zeros((N, F), bool)
    for t in range(N):
        present = [k for k in range(faces) if rng.random() < 0.7][:F]
        rng.shuffle(present)
        for f, k in enumerate(present):
            c = centers[k] + rng.normal(0, 0.005, 2)
            boxes[t, f] = np.round(np.concatenate([c - half[k],
                                                   c + half[k]]) * 32) / 32
            valid[t, f] = True
        if len(present) >= 2 and t % 3 == 1:
            boxes[t, 1] = boxes[t, 0]
    return boxes, valid, poses


@pytest.mark.parametrize("source", ["seeded", "detections"])
def test_tracking_on_the_card_matches_cpu(cuda, flagship, source):
    """track_sequence (in two chunks with the state carried) and
    smooth_sequence on CUDA tensors against the same calls on CPU tensors:
    states and slot occupancy identical, values within 1e-6 — on a seeded
    timeline with ties and slot stealing (5 slots), and on the flagship's
    detections of 32 corpus frames (100 slots per frame)."""
    from headpose_tpu_torch.runtime.smoothing import smooth_sequence
    from headpose_tpu_torch.runtime.tracking import track_sequence

    if source == "seeded":
        boxes, valid, poses = _timeline_gpu(3)
        slots = 5
    else:
        out = flagship.detect(_corpus(32))
        boxes, valid, poses = (out.boxes.cpu().numpy(),
                               out.valid.cpu().numpy(),
                               out.poses.cpu().numpy())
        slots = None

    def run(dev):
        b, v = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
        sig = {"poses": torch.from_numpy(poses).to(dev), "boxes": b}
        h = len(boxes) // 2
        first, st = track_sequence(b[:h], v[:h], {k: x[:h] for k, x in
                                                   sig.items()}, 0.3,
                                   num_slots=slots, max_missed=2,
                                   return_state=True)
        second, st = track_sequence(b[h:], v[h:], {k: x[h:] for k, x in
                                                    sig.items()}, 0.3,
                                    num_slots=slots, max_missed=2,
                                    state=st, return_state=True)
        return first, second, st, smooth_sequence(sig, 0.3, valid=v)

    (f0, s0, st0, sm0), (f1, s1, st1, sm1) = run("cpu"), run(cuda)
    assert torch.equal(st1.active.cpu(), st0.active)
    assert torch.equal(st1.age.cpu(), st0.age)
    for a, b in ((st1.boxes, st0.boxes),
                 *((st1.ema.value[k], st0.ema.value[k]) for k in sm0),
                 *((f1[k], f0[k]) for k in sm0),
                 *((s1[k], s0[k]) for k in sm0),
                 *((sm1[k], sm0[k]) for k in sm0)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6)
    for k in sm0:
        assert torch.equal(st1.ema.initialized[k].cpu(),
                           st0.ema.initialized[k])


@pytest.mark.parametrize("epochs_per_sync", [1, 3])
def test_fit_on_the_card_matches_the_cpu(cuda, tmp_path, epochs_per_sync):
    """Head training on the card: the same seeds give the CPU's epochs
    (per-epoch losses within rtol 1e-4, the same best epoch), with dropout
    off (the masks come from a device generator) and minibatches (the row
    order comes from a CPU generator: the same on both)."""
    from headpose_tpu_torch.data import Dataset
    from headpose_tpu_torch.train import config_96, fit

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 96)).astype(np.float32)
    y = (x[:, :3] * 10).astype(np.float32)
    runs = [fit(config_96(total_epochs=7, batch_size=64, learning_rate=1e-3,
                          reduce_lr_on_plateau=True, reduce_lr_patience=1,
                          epochs_per_sync=epochs_per_sync,
                          checkpoint_dir=str(tmp_path), run_name=device),
                Dataset(x, y), device=device) for device in ("cuda", "cpu")]
    assert runs[0].best_epoch == runs[1].best_epoch
    for a, b in zip(runs[0].history, runs[1].history):
        for key in ("train_loss", "val_loss", "train_mae", "val_mae"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4)


def test_extractor_on_the_card_matches_the_cpu(cuda):
    from headpose_tpu_torch.tools.extract_features import FeatureExtractor

    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:32]
    got = FeatureExtractor(score_threshold=0.05).extract(imgs)
    want = FeatureExtractor(score_threshold=0.05, device="cpu").extract(imgs)
    np.testing.assert_array_equal(got.found, want.found)
    for k in ("features88", "features96", "scores"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=1e-4, err_msg=k)


# detector training (train.detector, train.calibrate): the first steps on
# the card against the CPU on the same data, init and batch draws
TINY_TEACHER = BlazeFace(input_size=16, stem_features=4,
                         block_channels=(8, 12), downsample_blocks=(1,),
                         tap88_block=0)
TINY_STUDENT = BlazeFace(input_size=32, stem_features=4,
                         block_channels=(8, 8, 12), downsample_blocks=(0, 2),
                         tap88_block=1)
TRAIN_STEPS = 5
# per-step loss terms, card vs CPU: 1e-5 (the trainers stay within 6e-7;
# TF32 left on moves full-width fit by 2.6e-5 and distill by 3.8e-4 in 5
# steps on an H100); calibration's loss, on images given bitwise
# to both, is the island's bf16 rounding residual: 1e-3 (chip_smoke.py's
# TRAIN_LOSS_RTOL) or twice its own noise floor (`_calibration_floor`),
# whichever is larger, and its exact targets within 1e-3
TRAIN_RTOL = {"fit": 1e-5, "prefix": 1e-5, "distill": 1e-5,
              "calibrate": 1e-3}
# params after 5 steps: Adam turns an element's tiny gradient into an
# lr-sized step whatever its size, so a gradient near 0 whose last bits
# differ moves that element differently (1.1e-5 seen at lr 1e-3)
TRAIN_PARAM_ATOL = 1e-4
CALIB_BATCH = 16


def _squares(n, size, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 60, size=(n, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((n, 1, 4), np.float32)
    for i in range(n):
        s = rng.uniform(0.15, 0.6)
        cx, cy = rng.uniform(s / 2, 1 - s / 2, size=2)
        boxes[i, 0] = [cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2]
        px = (boxes[i, 0] * size).astype(int)
        imgs[i, px[1]:px[3], px[0]:px[2]] = rng.integers(180, 256, size=3)
    return imgs, boxes, np.ones((n, 1), np.float32)


def _calibration_model(width):
    """(model, params, island) calibrated at `width`: the tiny unified
    model of tests/test_calibrate.py, or the flagship's "turbo" island."""
    from headpose_tpu_torch.models import (TURBO_FAST_BLOCKS,
                                           UnifiedPoseModel)
    from headpose_tpu_torch.pretrained import FLAGSHIP, load_pretrained

    if width != "tiny":
        return (*load_pretrained(FLAGSHIP), TURBO_FAST_BLOCKS)
    spec = BlazeFace(input_size=32, stem_features=8,
                     block_channels=(8, 12, 16), downsample_blocks=(1,),
                     tap88_block=0)
    model = UnifiedPoseModel(spec, MLPHead(8, ((4, "tanh"), (3, "linear"))),
                             MLPHead(16, ((3, "linear"),)))
    g = torch.Generator().manual_seed(0)
    params = {"backbone": spec.init(g), "head88": model.head88.init(g),
              "head96": model.head96.init(g)}
    return model, params, (0, 1, 2)


def _trainer_run(trainer, width, device):
    """(history, params) of TRAIN_STEPS steps of one trainer on `device`;
    "tiny" runs the tiny specs, "full" the shipped widths (the front spec,
    the front→back pair, the flagship)."""
    from headpose_tpu_torch.models import BLAZEFACE_FRONT
    from headpose_tpu_torch.train import calibrate, detector

    tiny = width == "tiny"
    if trainer == "calibrate":
        model, params, fast = _calibration_model(width)
        new, hist = calibrate._calibrate(
            model, params, images=_calibration_images(model),
            device=device, **_calibration_recipe(fast))
        return hist, new["backbone"]
    student, teacher = ((TINY_STUDENT, TINY_TEACHER) if tiny
                        else (BLAZEFACE_BACK, BLAZEFACE_FRONT))
    if trainer == "fit":
        spec = TINY_STUDENT if tiny else BLAZEFACE_FRONT
        imgs, boxes, mask = _squares(32, spec.input_size, 0)
        cfg = detector.DetectorFitConfig(steps=TRAIN_STEPS, batch_size=8,
                                         warmup_steps=2, steps_per_sync=2)
        params, hist = detector.fit_detector(spec, imgs, boxes, mask, cfg,
                                             device=device)
        return hist, params
    t = teacher.init(torch.Generator().manual_seed(1))
    imgs = np.random.default_rng(2).integers(
        0, 256, (24, teacher.input_size, teacher.input_size, 3),
        dtype=np.uint8)
    ws = detector.warmstart_params(student, teacher, t)
    cfg = detector.DetectorDistillConfig(steps=TRAIN_STEPS, batch_size=6,
                                         warmup_steps=2, steps_per_sync=2,
                                         feat_cell_eps=0.2)
    if trainer == "prefix":
        params, hist = detector.distill_prefix(
            student, 0, teacher, 0 if tiny else -1, t, imgs, cfg,
            init_params=ws, device=device)
    else:
        params, hist = detector.distill_detector(student, teacher, t, imgs,
                                                 cfg, init_params=ws,
                                                 device=device)
    return hist, params


@pytest.mark.parametrize("width", ["tiny", "full"])
@pytest.mark.parametrize("trainer", ["fit", "prefix", "distill",
                                     "calibrate"])
def test_trainer_first_steps_on_the_card_match_the_cpu(cuda, trainer, width):
    """Every per-step loss term of the first 5 steps within TRAIN_RTOL of
    the CPU's, and the params within TRAIN_PARAM_ATOL, with TF32 switched
    ON around the call: the trainers turn it off for the whole step
    (forward and backward) and restore it after."""
    from headpose_tpu_torch.tools.convert import flatten_params

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        got, p_card = _trainer_run(trainer, width, None)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    want, p_cpu = _trainer_run(trainer, width, "cpu")
    floor = _calibration_floor(width, want) if trainer == "calibrate" else {}
    assert sorted(got) == sorted(want)
    for k in want:
        assert len(got[k]) == TRAIN_STEPS and np.isfinite(got[k]).all()
        np.testing.assert_allclose(
            got[k], want[k], err_msg=k,
            rtol=max(TRAIN_RTOL[trainer], 2.0 * floor.get(k, 0.0)))
    if trainer == "calibrate":    # its params follow the loss's rounding
        _assert_calibration_targets_agree(width)         # noise: no params
        return
    a, b = flatten_params(p_card), flatten_params(p_cpu)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0,
                                   atol=TRAIN_PARAM_ATOL, err_msg=k)


def _calibration_recipe(fast) -> dict:
    return dict(steps=TRAIN_STEPS, batch=CALIB_BATCH, learning_rate=1e-5,
                fast_blocks=fast, seed=0, loss_weights=(1.0, 1.0, 10.0, 0.1))


def _calibration_images(model) -> torch.Tensor:
    """TRAIN_STEPS batches synthesized once on the CPU from calibrate's own
    draws (seed 0), given bitwise to the card and the CPU."""
    from headpose_tpu_torch.train import calibrate

    gen = torch.Generator().manual_seed(0)
    return torch.stack([calibrate.synthesize_images(
        gen, CALIB_BATCH, model.backbone.input_size, device="cpu")
        for _ in range(TRAIN_STEPS)])


def _calibration_floor(width, want) -> dict:
    """The calibration objective's own noise floor on the CPU: the largest
    relative change of each loss term over the first steps when every
    input pixel moves one ulp up or down (chip_smoke.py's
    CALIB_FLOOR_FACTOR holds the card within twice it).  Its loss is the
    island's bf16 rounding residual, carried by a few cells."""
    from headpose_tpu_torch.train import calibrate

    model, params, fast = _calibration_model(width)
    x = _calibration_images(model)
    ulp = [calibrate._calibrate(
        model, params, device="cpu", **_calibration_recipe(fast),
        images=torch.nextafter(x, torch.tensor(v)))[1]
        for v in (np.inf, -np.inf)]
    return {k: max(float(np.abs(h[k] / want[k] - 1.0).max()) for h in ulp)
            for k in want}


def _assert_calibration_targets_agree(width):
    """Calibration's targets, the exact fp32 forward (TF32 off) of the
    original params on the first batch, which no island rounds: card
    against CPU within TRAIN_RTOL["calibrate"] of each output's largest
    value."""
    from headpose_tpu_torch.models.blazeface import fp32_exact
    from headpose_tpu_torch.models.unified import UnifiedPoseNet
    from headpose_tpu_torch.tools.convert import params_from_jax

    model, params, _ = _calibration_model(width)
    x = _calibration_images(model)[0]
    outs = []
    for device in (None, "cpu"):
        net = UnifiedPoseNet(model, device=device).eval()
        net.load_state_dict(params_from_jax(model, params))
        with torch.no_grad(), fp32_exact():
            out = net(x.to(net.backbone.stem.weight.device))
        out["scores"] = torch.sigmoid(out["scores"])
        outs.append({k: out[k].cpu().double().numpy() for k in (
            "pose_front", "pose_back", "scores", "loc")})
    for k, want in outs[1].items():
        assert (np.abs(outs[0][k] - want).max()
                <= TRAIN_RTOL["calibrate"] * np.abs(want).max()), k


def test_ssd_targets_on_the_card_are_the_cpus(cuda):
    """With cell collisions (several GTs in one cell, masked rows), the
    card's targets equal the CPU's bit for bit: the winner of a cell is
    resolved explicitly, not by the order of a scatter."""
    from headpose_tpu_torch.models import BLAZEFACE_FRONT
    from headpose_tpu_torch.train.detector import ssd_targets

    rng = np.random.default_rng(4)
    B, K = 64, 12
    s = rng.uniform(0.05, 0.7, (B, K))
    c = rng.uniform(0, 1, (B, K, 2))
    c[:, 1::2] = c[:, 0:-1:2] + rng.uniform(-1e-3, 1e-3, (B, K // 2, 2))
    boxes = np.concatenate([c - s[..., None] / 2, c + s[..., None] / 2],
                           -1).astype(np.float32)
    mask = (rng.uniform(size=(B, K)) > 0.2).astype(np.float32)
    kps = rng.uniform(0, 1, (B, K, 6, 2)).astype(np.float32)
    for spec in (BLAZEFACE_FRONT, TINY_STUDENT):
        got = ssd_targets(spec, torch.from_numpy(boxes).to(cuda), mask,
                          torch.from_numpy(kps).to(cuda))
        want = ssd_targets(spec, torch.from_numpy(boxes), mask,
                           torch.from_numpy(kps))
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)


def test_distill_prefix_on_the_card_keeps_frozen_leaves(cuda):
    """distill_prefix on the card (front→back, stem + block 0 trained):
    every other leaf comes back bit for bit, the trained ones move."""
    from headpose_tpu_torch.models import BLAZEFACE_FRONT
    from headpose_tpu_torch.tools.convert import flatten_params
    from headpose_tpu_torch.train import detector

    t = BLAZEFACE_FRONT.init(torch.Generator().manual_seed(0))
    ws = detector.warmstart_params(BLAZEFACE_BACK, BLAZEFACE_FRONT, t)
    imgs = np.random.default_rng(0).integers(0, 256, (16, 128, 128, 3),
                                             dtype=np.uint8)
    cfg = detector.DetectorDistillConfig(steps=20, batch_size=8,
                                         warmup_steps=2, steps_per_sync=10)
    got, hist = detector.distill_prefix(BLAZEFACE_BACK, 0, BLAZEFACE_FRONT,
                                        -1, t, imgs, cfg, init_params=ws)
    assert np.isfinite(hist["loss"]).all()
    a, b = flatten_params(got), flatten_params(ws)
    moved = {k for k in b if not np.array_equal(a[k], b[k])}
    assert moved and all(k.startswith(("stem/", "blocks/0/")) for k in moved)


# ------------------------------------------------ AOT programs on the card
_AOT_KERNELS = {"highest": ("cta_kernel",),
                "fast": ("cta_kernel", "mlp_head_kernel", "stem_kernel",
                         "chain_kernel"),
                "turbo": ("cta_kernel", "mlp_head_kernel",
                          "island_chain_kernel"),
                "max": ("cta_kernel", "mlp_head_kernel",
                        "island_block_kernel", "island_chain_kernel"),
                "se_fast": ("cta_kernel", "attend_kernel", "stem_kernel")}


def _kernel_names(fn, tries: int = 3) -> set:
    """The CUDA kernel names of warm fn() calls (torch.profiler), the
    union over `tries` profiled calls: the profiler drops an event now and
    then and never adds one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = set()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names |= {e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
    return names


@pytest.mark.parametrize("mode", ["highest", "fast", "turbo", "max",
                                  "se_fast"])
def test_aot_replay_runs_the_source_kernels(cuda, flagship, tmp_path, mode):
    """A program exported on the card holds one op node per counted launch
    of the source detect; its replay counts the same launches
    (ops/kernels/library.LAUNCHES), launches the mode's kernels by profiler
    name, and returns the source's slab bit for bit at the exported width;
    B=3 (chunked over 8, padded) gives the source's detection sets."""
    from headpose_tpu_torch.models.unified import UnifiedPoseModel
    from headpose_tpu_torch.ops.kernels import library
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.runtime.detector import FaceDetector
    from headpose_tpu_torch.tools.aot import export_detector, load_exported
    from headpose_tpu_torch.tools.convert import params_to_jax

    if mode == "se_fast":
        spec = UnifiedPoseModel(backbone=flagship.model.backbone,
                                head88=SETransformerHead(88),
                                head96=SETransformerHead(96))
        params = {"backbone": params_to_jax(
            flagship.model.backbone, flagship.net.backbone.state_dict())}
        for name, c in (("head88", 88), ("head96", 96)):
            head = _se_head(cuda, c, in_features=c)
            params[name] = params_to_jax(head.spec, head.state_dict())
        det = FaceDetector(spec, params, precision="fast")
    else:
        det = flagship_detector(precision=mode)
    imgs = _corpus(8)
    meta = export_detector(det, str(tmp_path), batch_sizes=(8,))
    aot = load_exported(str(tmp_path))

    def window(fn, x):
        torch.cuda.synchronize()
        before = dict(library.LAUNCHES)
        out = fn(x)
        torch.cuda.synchronize()
        return out, {k: library.LAUNCHES[k] - before[k] for k in before}

    want, source = window(det.detect, imgs)
    got, replay = window(aot.detect, imgs)
    assert replay == source
    ops = meta["programs"]["8"]["ops"]
    assert source["postprocess"] == ops.count("postprocess") == 1
    for op in ("backbone2_segment", "dense_block", "dense_chain", "mlp_head",
               "se_transformer"):
        assert ops.count(op) == source[op], op
    assert torch.equal(got.slab, want.slab)
    names = _kernel_names(lambda: aot.detect(imgs))
    for kernel in _AOT_KERNELS[mode]:
        assert any(kernel in n for n in names), (kernel, sorted(names))
    few = aot.detect(imgs[:3])
    assert torch.equal(few.valid, det.detect(imgs[:3]).valid)
