"""The port on the card: the CUDA postprocess kernel against its plain twin,
and FaceDetector.detect through the kernel against the same pipeline through
the twin, both bit for bit; the fused backbone and pose-head kernels against
their plain versions (rtol 1e-4 / atol 1e-5 and rtol = atol = 1e-5: the
kernels sum in another order than cuBLAS), and detect_fused against detect;
the split-bf16 segment kernel (apply_fused) against its plain version
(SPLIT_TOL) and an fp32 backbone (atol 5e-4), on the flagship and the back
model, and the "fast" detector against the "highest" one; the
SE-Transformer head kernel (se_transformer_forward) against its plain
version (rtol 1e-4 / atol 1e-5),
and the SE-Transformer model's detect_fused in both head profiles.

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

from headpose_tpu_torch.models import BlazeFace, BlazeFaceNet, MLPHead
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
