"""The port's feature extraction (headpose_tpu_torch.tools.extract_features)
against the JAX package's extractor on the CPU, and the framework's whole
loop on the port: images → extract_dataset → train → join → detect.

Tolerance: the port's fp32 network and JAX's differ by float rounding
(at most 2.5e-6 on features up to 2.3 on these frames); features are held
at atol 2e-5, scores at 2e-6, `found` exactly.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headpose_tpu.ops.detection import nms_static
from headpose_tpu.tools.extract_features import (
    FeatureExtractor as JaxFeatureExtractor)
from headpose_tpu_torch.data import load_dataset
from headpose_tpu_torch.models import join_models
from headpose_tpu_torch.runtime.detector import FaceDetector
from headpose_tpu_torch.tools.evaluate import predict
from headpose_tpu_torch.tools.extract_features import (FeatureExtractor,
                                                       best_face,
                                                       extract_dataset)
from headpose_tpu_torch.train import config_96, fit

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FEATURE_TOL = 2e-5
SCORE_TOL = 2e-6


@pytest.fixture(scope="module")
def extractor():
    return FeatureExtractor(score_threshold=0.05, device="cpu")


@pytest.fixture(scope="module")
def jax_extractor():
    return JaxFeatureExtractor(score_threshold=0.05)


def noise_frames(n=24, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 128, 128, 3)).astype(np.uint8)


def assert_same_extraction(got, want):
    np.testing.assert_array_equal(got.found, want.found)
    np.testing.assert_allclose(got.features88, want.features88,
                               atol=FEATURE_TOL, rtol=0)
    np.testing.assert_allclose(got.features96, want.features96,
                               atol=FEATURE_TOL, rtol=0)
    np.testing.assert_allclose(got.scores, want.scores, atol=SCORE_TOL,
                               rtol=0)


@pytest.mark.parametrize("frames", ["e2e", "noise"])
def test_extractor_matches_jax(extractor, jax_extractor, frames):
    """e2e.npz's two frames (256 and 480 square: the bicubic resize) and 24
    seeded noise frames at threshold 0.05."""
    if frames == "e2e":
        g = np.load(os.path.join(GOLDEN, "e2e.npz"))
        batches = [g["img0"], g["img1"]]
    else:
        batches = [noise_frames()]
    for imgs in batches:
        got = extractor.extract(imgs)
        assert got.found.sum() >= 1
        assert_same_extraction(got, jax_extractor.extract(imgs))


def test_no_face_returns_what_jax_returns():
    """Nothing above the threshold: anchor 0 stands in, found False."""
    img = np.zeros((1, 128, 128, 3), np.uint8)
    got = FeatureExtractor(score_threshold=0.9, device="cpu").extract(img)
    want = JaxFeatureExtractor(score_threshold=0.9).extract(img)
    assert not got.found[0]
    assert_same_extraction(got, want)


def test_saturated_ties_pick_the_lowest_index():
    """fp32 sigmoid is 1.0 above about 17, so two distinct logits tie: the
    pick is the lower index (JAX's nms_static), not the larger logit; NaN
    and sub-threshold logits are never picked."""
    logits = np.full((3, 896), -30.0, np.float32)
    logits[0, [700, 40]] = [25.0, 18.0]      # a back anchor above, tied
    logits[1, [3, 600]] = [np.nan, 2.0]
    logits[2, 5] = -3.0                      # below the threshold
    thr = float(np.log(0.05 / 0.95))
    best, score, found = best_face(torch.tensor(logits), thr)
    assert best.tolist() == [40, 600, 0] and found.tolist() == [True, True,
                                                                False]
    probs = jax.nn.sigmoid(jnp.asarray(logits))
    for b in range(3):
        sel, keep = nms_static(jnp.zeros((896, 4)), probs[b],
                               jnp.asarray(logits[b]) > thr, max_out=1)
        assert int(sel[0]) == best[b] and bool(keep[0]) == found[b]
        np.testing.assert_allclose(score[b].item(), float(probs[b, sel[0]]),
                                   rtol=1e-6)


def test_extracted_vector_reproduces_the_detect_pose(extractor):
    """The shipped head applied to the extracted vector gives detect's
    best-face pose: both read the same feature-map cell."""
    img = np.load(os.path.join(GOLDEN, "e2e.npz"))["img0"]
    det = FaceDetector(extractor.model, extractor.params,
                       score_threshold=0.05, device="cpu")
    best_pose = det.detect_single(img).poses[0]
    r = extractor.extract(img)
    assert r.found[0]
    spec, params = extractor.model, extractor.params
    err = min(np.abs(predict(spec.head88, params["head88"], r.features88,
                             "cpu")[0] - best_pose).max(),
              np.abs(predict(spec.head96, params["head96"], r.features96,
                             "cpu")[0] - best_pose).max())
    assert err < 1e-3


def test_threshold_is_read_per_call(extractor):
    img = np.load(os.path.join(GOLDEN, "e2e.npz"))["img0"]
    assert extractor.extract(img).found[0]
    old = extractor.score_threshold
    try:
        extractor.score_threshold = 0.999999
        assert not extractor.extract(img).found[0]
    finally:
        extractor.score_threshold = old


def test_full_framework_loop(tmp_path, extractor):
    """images → extract_dataset → fit → join_models → FaceDetector.detect on
    the CPU (tests/test_extract.py::test_full_framework_loop for the port),
    the extracted datasets equal to JAX's extraction of the same images."""
    images = noise_frames(24, seed=1)
    poses = np.random.default_rng(2).uniform(-60, 60, (24, 3)).astype(
        np.float32)
    p88, p96 = str(tmp_path / "ds88.npz"), str(tmp_path / "ds96.npz")
    found = extract_dataset(images, poses, out_88=p88, out_96=p96,
                            batch_size=8, extractor=extractor)
    assert found.sum() > 8
    want = JaxFeatureExtractor(score_threshold=0.05).extract(images)
    np.testing.assert_array_equal(found, want.found)
    ds, ds88 = load_dataset(p96), load_dataset(p88)
    assert ds.num_features == 96 and ds88.num_features == 88
    np.testing.assert_allclose(ds.features, want.features96[want.found],
                               atol=FEATURE_TOL, rtol=0)
    np.testing.assert_array_equal(ds.poses, poses[found])

    result = fit(config_96(num_filters=8, total_epochs=5, batch_size=8,
                           checkpoint_dir=str(tmp_path / "ck"),
                           run_name="loop"), ds, device="cpu")
    result88 = fit(config_96(in_features=88, num_filters=8, total_epochs=5,
                             batch_size=8,
                             checkpoint_dir=str(tmp_path / "ck88"),
                             run_name="loop88"), ds88, device="cpu")
    model, params = join_models(
        extractor.model.backbone, extractor.params["backbone"],
        result88.spec, result88.params, result.spec, result.params)
    det = FaceDetector(model, params, score_threshold=0.05, device="cpu")
    out = det.detect_single(images[0])
    assert len(out) > 0 and np.isfinite(out.poses).all()
