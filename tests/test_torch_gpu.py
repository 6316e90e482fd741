"""The port on the card: the CUDA postprocess kernel against its plain twin,
and FaceDetector.detect through the kernel against the same pipeline through
the twin.  Both are compared bit for bit.

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

from headpose_tpu_torch.models.anchors import generate_anchors
from headpose_tpu_torch.ops import detection as det
from headpose_tpu_torch.ops.image import preprocess
from headpose_tpu_torch.ops.kernels import postprocess as kern

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
        loc[0, 3, :] = np.nan
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
])
def test_kernel_matches_twin(cuda, case):
    case = dict(case)
    kw = dict(score_threshold=case.pop("thr"), iou_threshold=case.pop("iou"),
              max_faces=case.pop("mf"))
    args = [torch.from_numpy(x).to(cuda) for x in _inputs(**case)]
    anchors = torch.tensor(generate_anchors().astype(np.float32), device=cuda)
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
    decoded = torch.zeros((2, 16, 896), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kern.nms_slab_cuda(logits, decoded, pf, pb, 0.0, 0.3, 16)
    with pytest.raises(ValueError):
        kern.nms_slab_cuda(logits, loc.cpu(), pf, pb, 0.0, 0.3, 16)


def test_empty_batch_launches_nothing(cuda):
    args = [torch.from_numpy(x).to(cuda)[:0] for x in _inputs(1, 0)]
    anchors = torch.tensor(generate_anchors().astype(np.float32), device=cuda)
    before = kern.postprocess_kernel.launches
    out = kern.postprocess_kernel(*args, anchors)
    assert out["valid"].shape == (0, 100)
    assert kern.postprocess_kernel.launches == before
