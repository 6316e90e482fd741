"""The port's edge pipeline (headpose_tpu_torch/runtime/edge.py with
native/postprocess.cpp, ops/bicubic.py::resize_bicubic_np): the native
postprocess against JAX's postprocess and the port's plain chain on the
fuzz of tests/test_edge.py (boxes, keypoints and poses bit for bit, scores
within a sigmoid ulp), the numpy resize bitwise JAX's, EdgeDetector against
JAX's EdgeDetector over one .tflite (front and back models, camera-sized
frames) and against the port's FaceDetector, serving through PoseServer in
a process with jax and headpose_tpu blocked, and the demo's tflite=
source.  The port's counterpart of tests/test_edge.py."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headpose_tpu.ops.detection import postprocess as jax_postprocess
from headpose_tpu_torch.models.anchors import FRONT_CONFIG, generate_anchors
from headpose_tpu_torch.ops.detection import postprocess as plain_postprocess
from headpose_tpu_torch.runtime.edge import NativePostprocess, native_available

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")

pytestmark = [
    pytest.mark.skipif(not native_available(),
                       reason="g++ unavailable on this host"),
    pytest.mark.heavy,        # TFLite round trips + a subprocess
]

ANCHORS = np.asarray(generate_anchors(FRONT_CONFIG), np.float32)


def _jax_post(logits, loc, pf, pb, **kw):
    fn = jax.jit(jax.vmap(lambda s, l, a, b: jax_postprocess(
        s, l, a, b, jnp.asarray(ANCHORS), **kw)))
    return jax.tree.map(np.asarray, fn(jnp.asarray(logits), jnp.asarray(loc),
                                       jnp.asarray(pf), jnp.asarray(pb)))


def _plain_post(logits, loc, pf, pb, **kw):
    out = plain_postprocess(*(torch.from_numpy(a) for a in (logits, loc, pf,
                                                            pb)),
                            torch.from_numpy(ANCHORS), **kw)
    return {k: v.numpy() for k, v in out.items()}


def _assert_matches(native_results, want):
    for i, res in enumerate(native_results):
        c = int(want["valid"][i].sum())
        assert len(res) == c, f"image {i}: count {len(res)} != {c}"
        np.testing.assert_array_equal(res.boxes, want["boxes"][i, :c])
        np.testing.assert_array_equal(res.keypoints, want["keypoints"][i, :c])
        np.testing.assert_array_equal(res.poses, want["poses"][i, :c])
        np.testing.assert_allclose(res.scores, want["scores"][i, :c],
                                   rtol=0, atol=2e-7)       # sigmoid ulp


def _check(native, logits, loc, pf, pb, **kw):
    got = native(logits, loc, pf, pb)
    _assert_matches(got, _jax_post(logits, loc, pf, pb, **kw))
    _assert_matches(got, _plain_post(logits, loc, pf, pb, **kw))
    return got


class TestNativePostprocessParity:
    def test_fuzz_random_inputs(self):
        """200 random images of varying density, as JAX's test draws
        them."""
        rng = np.random.default_rng(0)
        B = 200
        logits = rng.normal(-3.0, 2.5, (B, 896)).astype(np.float32)
        loc = rng.normal(0.0, 20.0, (B, 896, 16)).astype(np.float32)
        pf = rng.normal(0, 30, (B, 16, 16, 3)).astype(np.float32)
        pb = rng.normal(0, 30, (B, 8, 8, 3)).astype(np.float32)
        got = _check(NativePostprocess(ANCHORS), logits, loc, pf, pb)
        assert sum(len(r) for r in got) > 100

    def test_nonfinite_and_ties(self):
        rng = np.random.default_rng(1)
        B = 8
        logits = rng.normal(0.0, 1.0, (B, 896)).astype(np.float32)
        logits[0, :10] = np.nan
        logits[1, 5] = np.inf
        logits[2, :] = -np.inf
        logits[3, 100] = logits[3, 200] = 4.0   # tie: lower index wins
        loc = rng.normal(0.0, 10.0, (B, 896, 16)).astype(np.float32)
        loc[1, 5, :4] = [np.nan, np.inf, -np.inf, np.nan]
        pf = rng.normal(0, 5, (B, 16, 16, 3)).astype(np.float32)
        pb = rng.normal(0, 5, (B, 8, 8, 3)).astype(np.float32)
        _check(NativePostprocess(ANCHORS), logits, loc, pf, pb)

    def test_threshold_endpoints_and_empty(self):
        rng = np.random.default_rng(2)
        logits = rng.normal(-1.0, 1.0, (4, 896)).astype(np.float32)
        logits[0, 7] = -200.0
        cut = np.float32(np.log(0.0135 / (1 - 0.0135)))
        logits[1, 50] = cut                                    # dropped
        logits[1, 51] = np.nextafter(cut, np.float32(np.inf))  # kept
        loc = rng.normal(0.0, 10.0, (4, 896, 16)).astype(np.float32)
        pf = np.zeros((4, 16, 16, 3), np.float32)
        pb = np.zeros((4, 8, 8, 3), np.float32)
        for t in (0.0, 0.0135, 0.999999):
            _check(NativePostprocess(ANCHORS, score_threshold=t), logits,
                   loc, pf, pb, score_threshold=t)

    def test_max_faces_cap(self):
        rng = np.random.default_rng(3)
        logits = rng.normal(3.0, 0.5, (2, 896)).astype(np.float32)
        loc = rng.normal(0.0, 40.0, (2, 896, 16)).astype(np.float32)
        pf = rng.normal(0, 5, (2, 16, 16, 3)).astype(np.float32)
        pb = rng.normal(0, 5, (2, 8, 8, 3)).astype(np.float32)
        got = _check(NativePostprocess(ANCHORS, max_faces=7), logits, loc,
                     pf, pb, max_faces=7)
        assert all(len(r) == 7 for r in got)

    def test_max_face_num_overflow_truncation(self):
        """The 100-face cap with over 100 mutually-surviving candidates:
        the same survivors in the same order as the uncapped greedy's
        first 100."""
        rng = np.random.default_rng(11)
        logits = rng.uniform(1.0, 3.0, (2, 896)).astype(np.float32)
        loc = np.zeros((2, 896, 16), np.float32)
        loc[..., 2:4] = 12.0
        pf = rng.normal(0, 5, (2, 16, 16, 3)).astype(np.float32)
        pb = rng.normal(0, 5, (2, 8, 8, 3)).astype(np.float32)
        uncapped = _plain_post(logits, loc, pf, pb, max_faces=896)
        assert (uncapped["valid"].sum(1) > 100).all()
        got = _check(NativePostprocess(ANCHORS, max_faces=100), logits, loc,
                     pf, pb, max_faces=100)
        assert all(len(r) == 100 for r in got)
        for i, r in enumerate(got):
            np.testing.assert_array_equal(r.boxes, uncapped["boxes"][i, :100])

    def test_layout_rejected(self):
        native = NativePostprocess(ANCHORS)
        with pytest.raises(ValueError, match="layout|\\(B, A"):
            native(np.zeros((1, 896), np.float32),
                   np.zeros((1, 896, 16), np.float32),
                   np.zeros((1, 4, 4, 3), np.float32),   # wrong grid
                   np.zeros((1, 8, 8, 3), np.float32))

    def test_corpus_model_outputs(self):
        """The flagship's outputs on 16 corpus frames (the port's CPU
        network) postprocess as JAX's and the plain chain do."""
        from headpose_tpu_torch.ops.image import preprocess
        from headpose_tpu_torch.pretrained import flagship_detector

        det = flagship_detector(device="cpu")
        imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:16]
        with torch.no_grad():
            out = det.net(preprocess(torch.from_numpy(imgs)))
        logits, loc = out["scores"].numpy(), out["loc"].numpy()
        pf, pb = out["pose_front"].numpy(), out["pose_back"].numpy()
        got = _check(NativePostprocess(ANCHORS), logits, loc, pf, pb)
        assert sum(len(r) for r in got) >= 16


@pytest.mark.parametrize("shape,out", [((2, 480, 480, 3), (128, 128)),
                                       ((333, 333, 3), (128, 128)),
                                       ((1, 480, 640, 3), (256, 256)),
                                       ((2, 128, 128, 3), (128, 128))])
def test_resize_bicubic_np_is_jax(shape, out):
    """resize_bicubic_np bitwise JAX's numpy twin, and within float
    rounding of the torch resize."""
    from headpose_tpu.ops.bicubic import resize_bicubic_np as jax_resize
    from headpose_tpu_torch.ops import resize_bicubic_np
    from headpose_tpu_torch.ops.image import resize_bicubic

    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    got = resize_bicubic_np(x, out)
    np.testing.assert_array_equal(got, jax_resize(x, out))
    np.testing.assert_allclose(got, resize_bicubic(torch.from_numpy(x),
                                                   out).numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The port's flagship as a unified .tflite (tools.tflite)."""
    from headpose_tpu_torch.pretrained import load_flagship
    from headpose_tpu_torch.tools.tflite import export_unified_tflite

    path = str(tmp_path_factory.mktemp("edge") / "flagship.tflite")
    export_unified_tflite(*load_flagship(), path)
    return path


@pytest.fixture(scope="module")
def corpus():
    return np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"]


def _same_results(got, want):
    assert len(got) == len(want)
    for k in ("boxes", "keypoints", "scores", "poses"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)


class TestEdgeDetector:
    def test_matches_jax_edge_detector(self, artifact, corpus):
        """One .tflite through both EdgeDetectors: the same Results bit for
        bit on corpus frames, camera-sized (480, 333) and non-square
        frames."""
        from headpose_tpu.runtime.edge import EdgeDetector as JaxEdge
        from headpose_tpu_torch.runtime.edge import EdgeDetector

        ours = EdgeDetector(artifact, score_threshold=0.05)
        theirs = JaxEdge(artifact, score_threshold=0.05)
        up = np.repeat(np.repeat(corpus[:2], 4, axis=1), 5, axis=2)
        frames = list(corpus[:6]) + [up[0, :480, :480], up[1, :333, :333],
                                     up[0, :480]]
        found = 0
        for f in frames:
            got = ours.detect_single(f)
            _same_results(got, theirs.detect_single(f))
            found += len(got)
        assert found > 6

    def test_end_to_end_matches_facedetector(self, artifact, corpus):
        """The edge pipeline against the port's FaceDetector at the
        golden-capture threshold: counts identical, numerics within the
        TFLite forward's error (JAX's tolerances)."""
        from headpose_tpu_torch.pretrained import flagship_detector
        from headpose_tpu_torch.runtime.edge import EdgeDetector

        edge = EdgeDetector(artifact, score_threshold=0.05)
        det = flagship_detector(device="cpu", score_threshold=0.05)
        imgs = corpus[:6]
        want = det.detect(imgs).trim()
        for i in range(len(imgs)):
            got = edge.detect_single(imgs[i])
            assert len(got) == len(want[i])
            np.testing.assert_allclose(got.boxes, want[i].boxes, atol=1e-4)
            np.testing.assert_allclose(got.poses, want[i].poses, atol=5e-4)
            np.testing.assert_allclose(got.scores, want[i].scores,
                                       atol=1e-4)
        batch = edge.detect(imgs[:2]).trim()     # rows run one by one
        for i, g in enumerate(batch):
            _same_results(g, edge.detect_single(imgs[i]))

    def test_back_camera_edge_pipeline(self, tmp_path):
        """The 256-input back model: its .tflite through both
        EdgeDetectors bit for bit, and against the port's FaceDetector."""
        from headpose_tpu.runtime.edge import EdgeDetector as JaxEdge
        from headpose_tpu_torch.pretrained import load_pretrained
        from headpose_tpu_torch.runtime.detector import FaceDetector
        from headpose_tpu_torch.runtime.edge import EdgeDetector
        from headpose_tpu_torch.tools.tflite import export_unified_tflite

        model, params = load_pretrained("unified-back-distilled")
        path = str(tmp_path / "back.tflite")
        export_unified_tflite(model, params, path)
        frame = np.random.default_rng(0).integers(
            0, 255, (256, 256, 3), np.uint8)
        want = FaceDetector(model, params, score_threshold=0.05,
                            device="cpu").detect(frame[None]).trim()[0]
        edge = EdgeDetector(path, score_threshold=0.05)
        assert edge.input_size == 256 and edge.frame_shape == (256, 256, 3)
        with pytest.raises(ValueError, match="baked"):
            EdgeDetector(path, input_size=128)
        got = edge.detect_single(frame)
        _same_results(got, JaxEdge(path, score_threshold=0.05)
                      .detect_single(frame))
        assert len(got) == len(want) and len(got) > 0
        np.testing.assert_allclose(got.boxes, want.boxes, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=5e-4)

    def test_nonimage_frame_rejected(self):
        from headpose_tpu_torch.runtime.edge import EdgeDetector

        with pytest.raises(ValueError, match="\\(H, W, 3\\)"):
            EdgeDetector.__new__(EdgeDetector)._preprocess(
                np.zeros((128, 128), np.uint8))

    def test_demo_over_tflite(self, artifact, tmp_path, monkeypatch):
        """run_demo(tflite=...) runs the loop over the edge pipeline from
        160x160 frames (the bicubic resize to the baked 128), and refuses
        serving options baked into the artifact."""
        cv2 = pytest.importorskip("cv2")
        from headpose_tpu_torch.runtime.demo import run_demo

        video = str(tmp_path / "in.mp4")
        w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                            (160, 160))
        rng = np.random.default_rng(3)
        for _ in range(3):
            w.write(rng.integers(0, 256, (160, 160, 3)).astype(np.uint8))
        w.release()
        monkeypatch.chdir(tmp_path)
        assert run_demo(tflite=artifact, source=video, display=False,
                        max_frames=2) == 2
        with pytest.raises(ValueError, match="artifact"):
            run_demo(tflite=artifact, source=video, display=False,
                     precision="turbo")
        with pytest.raises(ValueError, match="exclusive"):
            run_demo(tflite=artifact, server="http://nope", source=video,
                     display=False)


_BLOCKED_SCRIPT = """\
import sys

sys.path.insert(0, {repo!r})


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "headpose_tpu"):
            raise ImportError(f"{{name}} blocked")
        return None


sys.meta_path.insert(0, _Block())

import numpy as np

from headpose_tpu_torch.runtime import EdgeDetector, PoseClient, PoseServer

io = np.load({io_path!r})
edge = EdgeDetector({artifact!r}, score_threshold=0.05)
got = edge.detect_single(io["imgs"][0])
np.testing.assert_array_equal(got.boxes, io["boxes"])
np.testing.assert_array_equal(got.poses, io["poses"])
np.testing.assert_array_equal(got.scores, io["scores"])
trimmed = edge.detect(io["imgs"]).trim()
assert len(trimmed) == 2 and len(trimmed[0]) == len(got)
want1 = edge.detect_single(io["imgs"][1])
with PoseServer(edge, port=0, max_batch=4) as srv:
    assert srv.batcher.frame_shape == (128, 128, 3)
    with PoseClient(srv.url) as client:
        res = client.detect(io["imgs"][1])
        np.testing.assert_array_equal(res.poses, want1.poses)
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "headpose_tpu")]
assert not leaked, leaked
print("OK")
"""


def test_edge_serving_without_jax(artifact, corpus, tmp_path):
    """EdgeDetector and PoseServer over it in a process with jax and
    headpose_tpu import-blocked: the parent's edge results bit for bit,
    and a PoseClient round trip."""
    from headpose_tpu_torch.runtime.edge import EdgeDetector

    imgs = corpus[:2]
    want = EdgeDetector(artifact, score_threshold=0.05).detect_single(imgs[0])
    assert len(want) > 0
    io_path = str(tmp_path / "io.npz")
    np.savez(io_path, imgs=imgs, boxes=want.boxes, poses=want.poses,
             scores=want.scores)
    script = _BLOCKED_SCRIPT.format(repo=REPO, io_path=io_path,
                                    artifact=artifact)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout
