"""The reference drop-in (headpose_tpu_torch.compat), drawing
(runtime.viz), profiling (utils.profiling), the annotated copy of
process_video and the live demo, each against the JAX package's."""
import os

import numpy as np
import pytest
import torch

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIXTURES = os.path.join(os.path.dirname(__file__), "golden_torch")


@pytest.fixture(scope="module")
def corpus():
    return np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"]


def test_detect_faces_matches_jax(corpus):
    """blazeFaceDetector().detectFaces against JAX's compat on 6 corpus
    frames (identical counts, boxes within 1e-4, poses within 2e-3 deg),
    its reference attributes, and the H5 path through from_h5."""
    from headpose_tpu import compat as J
    from headpose_tpu_torch import compat as T

    ours = T.blazeFaceDetector(0.5, 0.3, device="cpu")
    theirs = J.blazeFaceDetector(0.5, 0.3)
    for img in corpus[:6]:
        a, b = ours.detectFaces(img), theirs.detectFaces(img)
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-4)
        np.testing.assert_allclose(a.poses, b.poses, atol=2e-3)
    for attr in ("inputWidth", "inputHeight", "channels",
                 "sigmoidScoreThreshold", "scoreThreshold", "iouThreshold"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert [a.to_string() for a in ours.anchors] == \
        [a.to_string() for a in theirs.anchors]
    assert ours.updateFps() >= 0 and isinstance(ours.fps, int)
    h5 = T.blazeFaceDetector(0.5, 0.3, device="cpu", model_path=os.path.join(
        FIXTURES, "flagship_joined.h5"))
    assert torch.equal(h5._detector.detect(corpus[:2]).slab,
                       ours._detector.detect(corpus[:2]).slab)


def test_reference_helpers_match_jax():
    """EMAFilter, SsdAnchorsCalculatorOptions/gen_anchors, EulerToMatrix and
    the constants against JAX's."""
    from headpose_tpu import compat as J
    from headpose_tpu_torch import compat as T

    for name in ("KEY_POINT_SIZE", "MAX_FACE_NUM", "INPUT_FRONT",
                 "INPUT_BACK"):
        assert getattr(T, name) == getattr(J, name)
    xs = np.random.default_rng(0).normal(size=20)
    a, b = T.EMAFilter(0.15), J.EMAFilter(0.15)
    assert [a.update(x) for x in xs] == [b.update(x) for x in xs]
    with pytest.raises(ValueError):
        T.EMAFilter(0.0)
    kw = dict(input_size_width=128, input_size_height=128, min_scale=0.1484375,
              max_scale=0.75, num_layers=4, feature_map_width=[],
              feature_map_height=[], strides=[8, 16, 16, 16],
              aspect_ratios=[1.0], fixed_anchor_size=True)
    ours = T.gen_anchors(T.SsdAnchorsCalculatorOptions(**kw))
    theirs = J.gen_anchors(J.SsdAnchorsCalculatorOptions(**kw))
    assert len(ours) == 896
    assert [x.to_string() for x in ours] == [x.to_string() for x in theirs]
    for args in ((0, 0, 0), (10.0, -20.0, 30.0), (-45, 80, 5)):
        np.testing.assert_array_equal(T.EulerToMatrix(*args),
                                      J.EulerToMatrix(*args))
    with pytest.raises(ValueError):
        T.SsdAnchorsCalculatorOptions(**{**kw, "num_layers": 3})


def test_drawing_is_pixel_equal_to_jax(corpus):
    """draw_detections, drawAxis_simo and the reference's draw_axis draw
    the same pixels as JAX's from the same inputs."""
    pytest.importorskip("cv2")
    from headpose_tpu import compat as J
    from headpose_tpu.runtime.viz import draw_detections as jax_draw
    from headpose_tpu_torch import compat as T
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.runtime.viz import draw_detections

    res = flagship_detector(device="cpu").detect_single(corpus[3])
    assert len(res) > 0
    for kw in ({}, {"fps": 31.7}, {"draw_axes": False, "draw_angles": False}):
        a = draw_detections(corpus[3].copy(), res, **kw)
        b = jax_draw(corpus[3].copy(), res, **kw)
        np.testing.assert_array_equal(a, b)
        assert (a != corpus[3]).any()
    img = np.zeros((200, 200, 3), np.uint8)
    np.testing.assert_array_equal(
        T.drawAxis_simo(img.copy(), (10.0, -25.0, 15.0), 100, 90, 60),
        J.drawAxis_simo(img.copy(), (10.0, -25.0, 15.0), 100, 90, 60))
    det = T.blazeFaceDetector(device="cpu")
    np.testing.assert_array_equal(
        det.draw_axis(img.copy(), 20, -10, 5, 100, 100),
        J.blazeFaceDetector.draw_axis(None, img.copy(), 20, -10, 5, 100, 100))
    np.testing.assert_array_equal(det.drawDetections(corpus[3].copy(), res),
                                  jax_draw(corpus[3].copy(), res, fps=0))


def test_fps_counter_and_timer():
    """FpsCounter updates every `update_every` ticks; Timer accumulates
    sections; the same report keys as JAX's."""
    from headpose_tpu.utils.profiling import Timer as JaxTimer
    from headpose_tpu_torch.utils.profiling import FpsCounter, Timer

    fps = FpsCounter(update_every=3)
    assert fps.tick() == 0.0 and fps.tick() == 0.0
    assert fps.tick() > 0.0
    t, jt = Timer(), JaxTimer()
    for timer in (t, jt):
        for _ in range(3):
            with timer.section("a"):
                pass
        with timer.section("b"):
            pass
    assert t.report().keys() == jt.report().keys()
    assert t.report()["a"]["count"] == 3
    assert t.report()["a"].keys() == jt.report()["a"].keys()


def test_staged_frames_and_sustained_timing(tmp_path):
    """staged_uint8_frames stages JAX's frames (the same seeded draws);
    sustained_seconds_per_dispatch times a detect loop; trace writes a
    torch.profiler trace."""
    from headpose_tpu.utils.profiling import staged_uint8_frames as jax_stage
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.utils.profiling import (
        staged_uint8_frames, sustained_seconds_per_dispatch, trace)

    ours = staged_uint8_frames(2, n_buffers=3, seed=4, device="cpu")
    theirs = jax_stage(2, n_buffers=3, seed=4)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    det = flagship_detector(device="cpu")
    s = sustained_seconds_per_dispatch(det.detect, ours, iters=3)
    assert 0.0 < s < 60.0
    with trace(str(tmp_path / "trace")) as prof:
        det.detect(ours[0])
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    assert len(prof.key_averages()) > 0


def _clip(tmp_path, frames):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             frames.shape[2:0:-1])
    for frame in frames:
        writer.write(frame)
    writer.release()
    return path


def _decode(path):
    import cv2

    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return np.stack(out)


def test_process_video_out_path_matches_jax(tmp_path, corpus):
    """process_video(out_path) on an 8-frame clip written here: the
    annotated copy has every frame, drawn, and decodes to JAX's copy (the
    few pixels a 2e-3 degree pose difference can move aside)."""
    from headpose_tpu.pretrained import flagship_detector as jax_flagship
    from headpose_tpu.runtime.offline import process_video as jax_video
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.runtime.offline import process_video

    clip = _clip(tmp_path, corpus[:8])
    ours_path, theirs_path = (str(tmp_path / "ours.mp4"),
                              str(tmp_path / "theirs.mp4"))
    got = process_video(flagship_detector(device="cpu"), clip, ours_path,
                        batch_size=4)
    want = jax_video(jax_flagship(), clip, theirs_path, batch_size=4)
    np.testing.assert_array_equal(got.valid, want.valid)
    ours, theirs, source = (_decode(ours_path), _decode(theirs_path),
                            _decode(clip))
    assert ours.shape == theirs.shape == source.shape == (8, 128, 128, 3)
    assert all((ours[t] != source[t]).any() for t in range(8))
    assert (ours != theirs).any(axis=-1).mean() < 0.01


def _capture_draws(monkeypatch, module):
    drawn = []

    def draw(img, results, fps=None, **kw):
        drawn.append(results)
        return img

    monkeypatch.setattr(module, "draw_detections", draw)
    return drawn


def test_run_demo_local_and_server_match_jax(tmp_path, corpus, monkeypatch):
    """run_demo on a file source with a frame limit (EMA over IoU tracks),
    the port's against JAX's: the same frames, each frame's smoothed faces
    within 2e-3 deg; then through server= against an in-process PoseServer
    on the port's CPU detector: the same faces as the local run; tflite=
    and server= together are refused (tflite= itself runs in
    tests/test_torch_edge.py)."""
    import headpose_tpu.runtime.demo as J
    import headpose_tpu_torch.runtime.demo as T
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.runtime import PoseServer

    clip = _clip(tmp_path, corpus[:10])
    ours = _capture_draws(monkeypatch, T)
    theirs = _capture_draws(monkeypatch, J)
    assert T.run_demo(source=clip, max_frames=6, display=False,
                      device="cpu") == 6
    assert J.run_demo(source=clip, max_frames=6, display=False) == 6
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a.poses, b.poses, atol=2e-3)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-4)
    local = list(ours)
    ours.clear()
    with PoseServer(flagship_detector(device="cpu"), port=0) as srv:
        assert T.run_demo(source=clip, max_frames=6, display=False,
                          server=srv.url) == 6
    for a, b in zip(ours, local):
        assert len(a) == len(b)
        np.testing.assert_allclose(a.poses, b.poses, atol=1e-4)
    assert T.run_demo(source=clip, max_frames=3, display=False,
                      use_ema=False, tracking=False, device="cpu") == 3
    with pytest.raises(ValueError, match="exclusive"):
        T.run_demo(source=clip, tflite="edge.tflite", server="http://x",
                   display=False)
    with pytest.raises(ValueError, match="server"):
        T.run_demo(source=clip, server="http://x", precision="fast",
                   display=False)
