"""The plain reference against the detections captured from the original
TensorFlow pipeline (tests/golden/parity_corpus.npz: 112 real-scene
128x128 images, 451 faces at threshold 0.4), the TF bicubic resize and the
MediaPipe anchor tables.  This holds the yardstick to the original, apart
from the program it judges."""
import json
import os

import numpy as np
import pytest

from perfbench.reference import image, postprocess
from perfbench.reference.detector import Reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def _config(name):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def corpus():
    return dict(np.load(os.path.join(GOLDEN, "parity_corpus.npz")))


@pytest.fixture(scope="module")
def flagship_results(corpus):
    cfg = _config("flagship.fast")
    ref = Reference(cfg, os.path.join(ROOT, cfg["weights"]))
    return ref.detect(corpus["imgs"], block=56)


def test_corpus_detection_sets(corpus, flagship_results):
    counts = [len(r["scores"]) for r in flagship_results]
    np.testing.assert_array_equal(counts, corpus["counts"])
    assert sum(counts) == 451


@pytest.mark.parametrize("field,atol", [("boxes", 1e-4), ("keypoints", 1e-4),
                                        ("scores", 1e-5), ("poses", 2e-3)])
def test_corpus_fields(corpus, flagship_results, field, atol):
    """The tolerances of the repository's certification tests: the TF
    pipeline computed in another order, on another backend."""
    for i, r in enumerate(flagship_results):
        n = int(corpus["counts"][i])
        np.testing.assert_allclose(r[field], corpus[field][i, :n], atol=atol,
                                   err_msg=f"image {i}")


def test_mlp_heads_are_the_plain_chain(corpus):
    """The flagship's pose heads, built by their kind's module, give bitwise
    what a Dense + activation chain written here gives on the network's
    taps, over 8 parity images."""
    import torch

    cfg = _config("flagship.fast")
    ref = Reference(cfg, os.path.join(ROOT, cfg["weights"]))
    frames = corpus["imgs"][:8]
    out = ref.outputs(frames)
    z = np.load(os.path.join(ROOT, cfg["weights"]))
    acts = {"linear": lambda x: x, "tanh": torch.tanh,
            "softsign": lambda x: x / (1.0 + x.abs())}
    with torch.no_grad():
        taps = ref.net.taps(image.preprocess(torch.from_numpy(frames),
                                             ref.size))
    for name, tap, key in (("head88", taps[0], "pose_front"),
                           ("head96", taps[1], "pose_back")):
        x = tap.permute(0, 2, 3, 1)
        for j, (_, act) in enumerate(cfg["spec"][name]["layers"]):
            w = torch.from_numpy(z[f"{name}/layers/{j}/w"].astype(np.float32))
            b = torch.from_numpy(z[f"{name}/layers/{j}/b"].astype(np.float32))
            x = acts[act](x @ w + b)
        np.testing.assert_array_equal(out[key], x.numpy())


@pytest.mark.parametrize("k", [0, 1, 2])
def test_bicubic_resize_matches_tf(k):
    import torch

    z = np.load(os.path.join(GOLDEN, "resize_bicubic.npz"))
    got = image.resize(torch.from_numpy(z[f"img{k}"][None]), 128)[0].numpy()
    np.testing.assert_allclose(got, z[f"resized{k}"], atol=2e-4)


@pytest.mark.parametrize("config,golden", [("flagship.fast", "anchors"),
                                           ("back256.fast", "anchors_back")])
def test_anchor_tables(config, golden):
    want = np.load(os.path.join(GOLDEN, golden + ".npz"))["anchors"]
    np.testing.assert_allclose(postprocess.anchors(_config(config)["anchors"]),
                               want, atol=1e-12)


def test_nms_lowest_index_wins_a_tie():
    """Two identical boxes of equal score: the lower anchor index is kept,
    the other suppressed; a disjoint box survives."""
    A = 896
    scores = np.full((1, A), -20.0, np.float32)
    loc = np.zeros((1, A, 16), np.float32)
    for i in (40, 7, 300):
        scores[0, i] = 3.0
        loc[0, i, 2:4] = 20.0                 # a 20-pixel box on the anchor
        loc[0, i, 4] = i                      # marks the anchor
    anchors = np.zeros((A, 4))
    anchors[300, :2] = 0.9                    # far from the other two
    out = {"scores": scores, "loc": loc,
           "pose_front": np.zeros((1, 16, 16, 3), np.float32),
           "pose_back": np.zeros((1, 8, 8, 3), np.float32)}
    r = postprocess.postprocess(out, anchors, 128, score_threshold=0.4,
                                iou_threshold=0.3, max_faces=100)[0]
    assert len(r["scores"]) == 2
    np.testing.assert_allclose(r["boxes"][1, :2], 0.9 - 10 / 128, atol=1e-6)
    np.testing.assert_allclose(r["keypoints"][:, 0, 0],
                               [7 / 128, 0.9 + 300 / 128], atol=1e-6)


def test_pose_lookup_front_and_back_cells():
    pf = np.arange(16 * 16 * 3, dtype=np.float32).reshape(16, 16, 3)
    pb = -np.arange(8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    got = postprocess._poses(np.array([0, 1, 33, 512, 517, 518, 895]),
                             pf, pb, 896)
    want = [pf[0, 0], pf[0, 0], pf[1, 0], pb[0, 0], pb[0, 0], pb[0, 1],
            pb[7, 7]]
    np.testing.assert_array_equal(got, want)
