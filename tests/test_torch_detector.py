"""The port's FaceDetector on the CPU against the JAX detector and the
reference detections captured from the original pipeline."""
import os

import numpy as np
import pytest

from headpose_tpu_torch.pretrained import best_detector, flagship_detector

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")


@pytest.fixture(scope="module")
def det():
    return flagship_detector(device="cpu")


@pytest.fixture(scope="module")
def production():
    return np.load(os.path.join(GOLDEN, "e2e_production.npz"))


@pytest.fixture(scope="module")
def corpus():
    return dict(np.load(os.path.join(GOLDEN, "parity_corpus.npz")))


def _np(batch):
    return {k: getattr(batch, k).numpy() for k in FIELDS}


def test_matches_jax_detector(det, production, corpus):
    """e2e_production.npz (256x256: the resize path) and the first 6 corpus
    images (128x128) through both detectors at production thresholds:
    identical detection sets, boxes atol 1e-4, poses atol 2e-3."""
    from headpose_tpu.pretrained import flagship_detector as jax_flagship

    jdet = jax_flagship()
    for imgs in (production["img"][None], corpus["imgs"][:6]):
        got = _np(det.detect(imgs))
        want = {k: np.asarray(getattr(jdet.detect(imgs), k)) for k in FIELDS}
        np.testing.assert_array_equal(got["valid"], want["valid"])
        assert got["valid"].sum() >= len(imgs)
        np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-4)
        np.testing.assert_allclose(got["keypoints"], want["keypoints"],
                                   atol=1e-4)
        np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5)
        np.testing.assert_allclose(got["poses"], want["poses"], atol=2e-3)


def test_matches_corpus_reference(det, corpus):
    """The reference detections of the first 6 corpus images at the
    tolerances of tests/test_certification.py:108-115."""
    n = 6
    per = det.detect(corpus["imgs"][:n]).trim()
    for i in range(n):
        c = int(corpus["counts"][i])
        assert len(per[i]) == c
        np.testing.assert_allclose(per[i].scores, corpus["scores"][i, :c],
                                   atol=1e-5)
        np.testing.assert_allclose(per[i].boxes, corpus["boxes"][i, :c],
                                   atol=1e-4)
        np.testing.assert_allclose(per[i].poses, corpus["poses"][i, :c],
                                   atol=2e-3)


def test_production_golden(det, production):
    """tests/golden/e2e_production.npz at the tolerances of
    tests/test_detection.py:280-282."""
    res = det.detect_single(production["img"])
    assert len(res) == len(production["scores"]) > 0
    np.testing.assert_allclose(res.scores, production["scores"], atol=1e-4)
    np.testing.assert_allclose(res.boxes, production["boxes"], atol=1e-4)
    np.testing.assert_allclose(res.poses, production["poses"], atol=5e-4)


@pytest.mark.parametrize("case", [0, 1])
def test_e2e_golden_at_capture_threshold(case):
    """tests/golden/e2e.npz (256x256 and 480x480 frames, captured at score
    threshold 0.05) at the tolerances of tests/test_detection.py:147-151."""
    g = np.load(os.path.join(GOLDEN, "e2e.npz"))
    det = flagship_detector(device="cpu", score_threshold=0.05)
    res = det.detect_single(g[f"img{case}"])
    assert len(res) == len(g[f"scores{case}"])
    for k, tol in (("scores", 1e-4), ("boxes", 1e-4), ("keypoints", 1e-4),
                   ("poses", 5e-4)):
        np.testing.assert_allclose(getattr(res, k), g[f"{k}{case}"],
                                   atol=tol, err_msg=k)


def test_stress_overflow_order_and_uncapped_sets():
    """Overflow images of tests/golden/stress_corpus.npz (>100 mutually
    surviving faces): the reference's emission order at the 100-face cap,
    position by position, and its full survivor set at max_faces=256."""
    d = dict(np.load(os.path.join(GOLDEN, "stress_corpus.npz")))
    ov = d["ov_idx"][:4]
    assert (d["axis"][ov] == "overflow").all()
    capped = flagship_detector(device="cpu").detect(d["imgs"][ov]).trim()
    uncapped = flagship_detector(device="cpu", max_faces=256).detect(
        d["imgs"][ov]).trim()
    for j, i in enumerate(ov):
        c = int(d["counts"][i])
        assert len(capped[j]) == c == 100
        np.testing.assert_allclose(capped[j].boxes, d["boxes"][i, :c],
                                   atol=1e-4)
        np.testing.assert_allclose(capped[j].scores, d["scores"][i, :c],
                                   atol=1e-4)
        n = int(d["ov_counts"][j])
        assert len(uncapped[j]) == n > 100
        np.testing.assert_allclose(uncapped[j].boxes, d["ov_boxes"][j, :n],
                                   atol=1e-4)
        np.testing.assert_allclose(uncapped[j].scores, d["ov_scores"][j, :n],
                                   atol=1e-4)
        np.testing.assert_allclose(uncapped[j].poses, d["ov_poses"][j, :n],
                                   atol=2e-3)


def test_threshold_mutation_takes_effect(production):
    det = flagship_detector(device="cpu")
    img = production["img"]
    n = len(det.detect_single(img))
    assert n > 3
    det.max_faces = 3
    assert len(det.detect_single(img)) == 3
    assert det.detect(img).valid.shape == (1, 3)
    det.max_faces = 100
    det.iou_threshold = 0.9          # looser NMS keeps more boxes
    assert len(det.detect_single(img)) > n
    det.iou_threshold = 0.3
    det.score_threshold = 0.999
    assert len(det.detect_single(img)) < n


def test_best_detector_has_the_flagship_detections(det, corpus):
    """Same backbone and SSD heads: identical detection sets, boxes and
    scores; only the poses differ."""
    imgs = corpus["imgs"][:2]
    got = _np(best_detector(device="cpu").detect(imgs))
    want = _np(det.detect(imgs))
    for k in ("valid", "boxes", "keypoints", "scores"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.abs(got["poses"] - want["poses"])[want["valid"]].max() > 1e-3


def test_channel_order_and_input_forms(det, corpus):
    img = corpus["imgs"][0]
    bgr = _np(det.detect(img))
    rgb = flagship_detector(device="cpu", channel_order="rgb")
    for form in (img[..., ::-1], img[..., ::-1].astype(np.float32)):
        got = _np(rgb.detect(form))
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], bgr[k], err_msg=k)
    # read-only inputs (np.broadcast_to) are accepted
    wide = _np(det.detect(np.broadcast_to(img, (2, *img.shape))))
    np.testing.assert_array_equal(wide["boxes"][1], bgr["boxes"][0])


def test_trim_is_the_slab(det, corpus):
    batch = det.detect(corpus["imgs"][:3])
    per = batch.trim()
    for b, r in enumerate(per):
        m = batch.valid[b].numpy()
        assert len(r) == int(m.sum()) == int(batch.counts[b])
        np.testing.assert_array_equal(r.boxes, batch.boxes[b].numpy()[m])
        np.testing.assert_array_equal(r.keypoints,
                                      batch.keypoints[b].numpy()[m])
        np.testing.assert_array_equal(r.scores, batch.scores[b].numpy()[m])
        np.testing.assert_array_equal(r.poses, batch.poses[b].numpy()[m])


@pytest.mark.parametrize("kw", [dict(precision="bfloat16"),
                                dict(head_eval="bogus"),
                                dict(channel_order="bgra"),
                                dict(device="mps"),
                                dict(precision="bf16")])
def test_unserved_options_raise(kw):
    with pytest.raises(ValueError):
        flagship_detector(**{"device": "cpu", **kw})
