"""The port's plain postprocess (headpose_tpu_torch.ops.detection) against the
JAX package's two postprocess paths: vmap(ops.detection.postprocess) and the
Pallas kernel postprocess_pallas in interpret mode.

Tolerances: valid, boxes, keypoints and poses are compared BIT FOR BIT (the
selection, the decode and the extraction are exact in both frameworks: the
decode matmul has exact products and one rounding, the extraction copies).
Scores get atol 1e-6: torch's and XLA's CPU sigmoid differ by 1 ulp on a
fraction of inputs.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headpose_tpu.models.anchors import BACK_CONFIG, generate_anchors
from headpose_tpu.ops import detection as jdet
from headpose_tpu.ops.pallas.postprocess import postprocess_pallas
from headpose_tpu_torch.ops import detection as tdet
from headpose_tpu_torch.ops.kernels import library, postprocess_kernel

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")


def _inputs(b, seed, loc_std=8.0, bias=0.0, quantize=False, nonfinite=False):
    """The fuzz inputs of tests/test_pallas.py::TestFusedPostprocess._run,
    plus an optional sprinkle of NaN / +-inf logits and non-finite loc."""
    a = 896
    rng = np.random.default_rng(seed)
    logits = (rng.normal(0.0, 2.0, (b, a)) + bias).astype(np.float32)
    if quantize:
        logits = np.round(logits).astype(np.float32)   # exact score ties
    loc = rng.normal(0.0, loc_std, (b, a, 16)).astype(np.float32)
    pf = rng.normal(0, 0.5, (b, 16, 16, 3)).astype(np.float32)
    pb = rng.normal(0, 0.5, (b, 8, 8, 3)).astype(np.float32)
    if nonfinite:
        logits[0, 5] = np.nan
        logits[-1, 7] = -np.inf
        logits[0, 700] = np.inf
        loc[0, 3, :] = np.nan
        loc[-1, 11, 2] = np.inf
    return logits, loc, pf, pb


def _jax_vmap(logits, loc, pf, pb, anchors, thr, iou, mf, input_size=128):
    fn = jax.jit(jax.vmap(lambda s, l, f, bk: jdet.postprocess(
        s, l, f, bk, jnp.asarray(anchors), score_threshold=thr,
        iou_threshold=iou, input_size=input_size, max_faces=mf)))
    return {k: np.asarray(v) for k, v in fn(logits, loc, pf, pb).items()}


def _torch(logits, loc, pf, pb, anchors, thr, iou, mf, input_size=128,
           fn=tdet.postprocess):
    out = fn(torch.from_numpy(logits), torch.from_numpy(loc),
             torch.from_numpy(pf), torch.from_numpy(pb),
             torch.from_numpy(anchors), score_threshold=thr,
             iou_threshold=iou, input_size=input_size, max_faces=mf)
    return {k: v.numpy() for k, v in out.items()}


def _assert_same(got, want):
    for k in FIELDS:
        assert got[k].shape == want[k].shape, k
        if k == "scores":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


ANCHORS = generate_anchors().astype(np.float32)

# the cases of tests/test_pallas.py:213-228, plus non-finite inputs
CASES = [
    dict(b=8, thr=0.4, iou=0.3, mf=16, seed=1),
    dict(b=3, thr=0.4, iou=0.3, mf=100, seed=3),               # odd batch
    dict(b=8, thr=0.99, iou=0.3, mf=16, seed=5, bias=-8.0),     # all empty
    dict(b=4, thr=0.0, iou=0.3, mf=100, seed=6),                # keep all
    dict(b=8, thr=0.4, iou=0.01, mf=32, seed=8),                # heavy NMS
    dict(b=2, thr=0.0, iou=0.01, mf=100, seed=99),   # all 896 admitted
    dict(b=8, thr=0.4, iou=0.3, mf=16, seed=9, loc_std=0.5),    # clusters
    dict(b=4, thr=1.0, iou=0.3, mf=16, seed=2),      # keep-NONE endpoint
    dict(b=8, thr=0.4, iou=0.3, mf=32, seed=11, quantize=True),  # ties
    dict(b=4, thr=0.0, iou=0.01, mf=100, seed=12, quantize=True,
         loc_std=0.5),   # ties + defeated suppression + clustered boxes
    dict(b=3, thr=0.4, iou=0.3, mf=16, seed=13, nonfinite=True),
    dict(b=1, thr=0.0, iou=0.3, mf=100, seed=14, nonfinite=True),
]


def _split(case):
    case = dict(case)
    thr, iou, mf = case.pop("thr"), case.pop("iou"), case.pop("mf")
    return _inputs(**case), thr, iou, mf


@pytest.mark.parametrize("case", CASES)
def test_bit_exact_vs_jax_postprocess(case):
    (logits, loc, pf, pb), thr, iou, mf = _split(case)
    want = _jax_vmap(logits, loc, pf, pb, ANCHORS, thr, iou, mf)
    got = _torch(logits, loc, pf, pb, ANCHORS, thr, iou, mf)
    _assert_same(got, want)


@pytest.mark.parametrize("case", [CASES[1], CASES[5], CASES[8], CASES[10]])
def test_bit_exact_vs_pallas_interpret(case):
    """The TPU kernel itself, run as tests/test_pallas.py runs it on the
    CPU (interpret mode; slow, so four cases)."""
    (logits, loc, pf, pb), thr, iou, mf = _split(case)
    want = postprocess_pallas(
        jnp.asarray(logits), jnp.asarray(loc), jnp.asarray(pf),
        jnp.asarray(pb), jnp.asarray(ANCHORS), score_threshold=thr,
        iou_threshold=iou, max_faces=mf, interpret=True)
    got = _torch(logits, loc, pf, pb, ANCHORS, thr, iou, mf)
    _assert_same(got, {k: np.asarray(v) for k, v in want.items()})


def test_back_camera_config_bit_exact():
    """The 256-input anchor table and input_size decode the same way."""
    anchors = generate_anchors(BACK_CONFIG).astype(np.float32)
    logits, loc, pf, pb = _inputs(4, 21, loc_std=16.0)
    want = _jax_vmap(logits, loc, pf, pb, anchors, 0.4, 0.3, 16,
                     input_size=256)
    got = _torch(logits, loc, pf, pb, anchors, 0.4, 0.3, 16, input_size=256)
    _assert_same(got, want)


def test_max_faces_256_uncapped():
    """A slab wider than the reference's 100 holds every survivor."""
    logits, loc, pf, pb = _inputs(2, 99)
    want = _jax_vmap(logits, loc, pf, pb, ANCHORS, 0.0, 0.3, 256)
    got = _torch(logits, loc, pf, pb, ANCHORS, 0.0, 0.3, 256)
    assert got["valid"].sum(axis=1).max() > 100
    _assert_same(got, want)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_parity_with_reference_goldens(case):
    """tests/golden/postprocess.npz (the reference decode + tf NMS + pose
    lookup) at the tolerances of tests/test_detection.py:113-116."""
    g = np.load(os.path.join(GOLDEN, "postprocess.npz"))
    out = _torch(g[f"cls{case}"][None], g[f"loc{case}"][None],
                 g[f"pose_front{case}"][None], g[f"pose_back{case}"][None],
                 ANCHORS, 0.4, 0.3, 100)
    valid = out["valid"][0]
    n = int(valid.sum())
    assert valid[:n].all() and not valid[n:].any()
    assert n == len(g[f"scores{case}"])
    for k in ("scores", "boxes", "keypoints", "poses"):
        np.testing.assert_allclose(out[k][0, :n], g[f"{k}{case}"], atol=1e-5,
                                   err_msg=k)


def test_kernel_wrapper_on_cpu_is_the_twin():
    """On CPU tensors the wrapper runs the plain selection loop and launches
    nothing."""
    (logits, loc, pf, pb), thr, iou, mf = _split(CASES[0])
    before = library.launches()["postprocess"]
    got = _torch(logits, loc, pf, pb, ANCHORS, thr, iou, mf,
                 fn=postprocess_kernel)
    want = _torch(logits, loc, pf, pb, ANCHORS, thr, iou, mf)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert library.launches()["postprocess"] == before


def test_threshold_zero_drops_sigmoid_underflow():
    """score_threshold=0 keeps the reference's STRICT prob > 0 filter: a
    logit whose f32 sigmoid underflows to 0 is dropped."""
    logits = np.full((1, 896), -200.0, np.float32)
    logits[0, 3] = 2.0
    loc = np.zeros((1, 896, 16), np.float32)
    pf = np.zeros((1, 16, 16, 3), np.float32)
    pb = np.zeros((1, 8, 8, 3), np.float32)
    out = _torch(logits, loc, pf, pb, ANCHORS, 0.0, 0.3, 16)
    assert int(out["valid"].sum()) == 1


@pytest.mark.parametrize("bad", ["scores", "loc", "pose_back", "dtype"])
def test_rejects_malformed_inputs(bad):
    logits, loc, pf, pb = (torch.from_numpy(x) for x in _inputs(2, 0))
    if bad == "scores":
        logits = logits[:, :800]
    elif bad == "loc":
        loc = loc[..., :12]
    elif bad == "pose_back":
        pb = pb[:, :4, :4]
    else:
        loc = loc.double()
    with pytest.raises((ValueError, TypeError)):
        tdet.postprocess(logits, loc, pf, pb, torch.from_numpy(ANCHORS))
