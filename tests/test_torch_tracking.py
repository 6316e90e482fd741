"""The port's smoothing and IoU tracking (runtime.smoothing, runtime.tracking)
and its offline timeline (runtime.offline.process_frames) against the JAX
package's, on the CPU.

Seeded numpy timelines go through both: track slots must be exactly equal,
values within 1e-6.  The timelines are built to reach every branch of the
greedy association: exact IoU ties (duplicate and quantized boxes), slot
overflow (-1), stealing the stalest track when no slot is free, and expiry
after max_missed frames; each case asserts that its branch was taken."""
import os

import numpy as np
import pytest
import torch

from headpose_tpu.runtime import smoothing as jsm
from headpose_tpu.runtime import tracking as jtr
from headpose_tpu_torch.runtime import smoothing as tsm
from headpose_tpu_torch.runtime import tracking as ttr

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# 1e-6 absolute, and 1e-6 of the value: one fp32 ulp of a 41-degree pose is
# 3.8e-6, and jitted XLA may round alpha*x + (1-alpha)*y once (a fused
# multiply-add) where the port rounds each product
TOL = dict(rtol=1e-6, atol=1e-6)

# name -> (timeline, tracker) arguments; each reaches the branch it names
CASES = {
    "ties": (dict(seed=0, faces=4, quantize=True, duplicates=True),
             dict(num_slots=None, max_missed=10)),
    "overflow": (dict(seed=1, faces=6, p_face=0.9),
                 dict(num_slots=3, max_missed=10)),
    "steal": (dict(seed=2, faces=8, p_face=0.5),
              dict(num_slots=5, max_missed=50)),
    "expiry": (dict(seed=3, faces=5, p_face=0.4),
               dict(num_slots=None, max_missed=1)),
    # a negative threshold matches pairs that do not overlap at all
    "permissive": (dict(seed=4, faces=10, p_face=0.3),
                   dict(num_slots=None, max_missed=10, iou_threshold=-0.5)),
}


def _timeline(seed, faces, N=16, F=6, p_face=0.6, quantize=False,
              duplicates=False):
    """(boxes (N, F, 4), valid (N, F), poses (N, F, 3)): `faces` moving
    faces, each present in a frame with probability p_face, in random
    detection order, jittered; invalid rows hold junk, as slabs may."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (faces, 2))
    half = rng.uniform(0.05, 0.12, (faces, 1))
    drift = rng.normal(0.0, 0.01, (faces, 2))
    base_pose = rng.normal(0.0, 30.0, (faces, 3))
    boxes = rng.uniform(0.0, 1.0, (N, F, 4)).astype(np.float32)
    poses = rng.normal(0.0, 30.0, (N, F, 3)).astype(np.float32)
    valid = np.zeros((N, F), bool)
    for t in range(N):
        present = [k for k in range(faces) if rng.random() < p_face][:F]
        rng.shuffle(present)
        for f, k in enumerate(present):
            c = centers[k] + t * drift[k] + rng.normal(0, 0.005, 2)
            box = np.concatenate([c - half[k], c + half[k]])
            if quantize:
                box = np.round(box * 32) / 32
            boxes[t, f] = box
            poses[t, f] = base_pose[k] + rng.normal(0, 2.0, 3)
            valid[t, f] = True
        if duplicates and len(present) >= 2 and t % 3 == 1:
            boxes[t, 1] = boxes[t, 0]           # two detections, one box
    return boxes, valid, poses


def _iou(a, b):
    """Row-wise IoU of two (N, 4) box arrays."""
    wh = np.clip(np.minimum(a[:, 2:], b[:, 2:])
                 - np.maximum(a[:, :2], b[:, :2]), 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area = (a[:, 2:] - a[:, :2]).prod(1) + (b[:, 2:] - b[:, :2]).prod(1)
    return inter / (area - inter)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_state_equal(got, want):
    a = np.asarray
    np.testing.assert_array_equal(a(got.active), a(want.active))
    np.testing.assert_array_equal(a(got.age), a(want.age))
    np.testing.assert_allclose(a(got.boxes), a(want.boxes), **TOL)
    for k in want.ema.value:
        np.testing.assert_array_equal(a(got.ema.initialized[k]),
                                      a(want.ema.initialized[k]))
        np.testing.assert_allclose(a(got.ema.value[k]),
                                   a(want.ema.value[k]), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_associate_and_tracks_update_match_jax(case):
    """Frame by frame from the same state: associate's slots and new-track
    flags exactly equal, then tracks_update's state and smoothed signals."""
    import jax.numpy as jnp

    tl, trk = CASES[case]
    boxes, valid, poses = _timeline(**tl)
    slots = trk["num_slots"] or 2 * boxes.shape[1]
    sig = {"poses": poses, "boxes": boxes}
    jst = jtr.tracks_init({k: jnp.asarray(v[0]) for k, v in sig.items()},
                          slots)
    tst = ttr.tracks_init({k: _t(v[0]) for k, v in sig.items()}, slots)
    thr = trk.get("iou_threshold", 0.3)
    seen = dict.fromkeys(CASES, 0)
    for t in range(len(boxes)):
        jslot, jnew = jtr.associate(jst.boxes, jst.active, jst.age,
                                    jnp.asarray(boxes[t]),
                                    jnp.asarray(valid[t]), thr)
        tslot, tnew = ttr.associate(tst.boxes, tst.active, tst.age,
                                    _t(boxes[t]), _t(valid[t]), thr)
        jslot, jnew = np.asarray(jslot), np.asarray(jnew)
        v = valid[t]
        np.testing.assert_array_equal(tslot.numpy()[v], jslot[v])
        np.testing.assert_array_equal(tnew.numpy(), jnew)
        active = np.asarray(jst.active)
        # a valid detection with no slot overflowed; a fresh track on an
        # active slot stole it; two valid detections with one box tie
        seen["overflow"] += int(np.any(v & (jslot < 0)))
        seen["steal"] += int(np.any(jnew & active[np.clip(jslot, 0, None)]))
        seen["ties"] += int(len(set(map(tuple, boxes[t][v]))) < v.sum())
        matched = v & (jslot >= 0) & ~jnew
        seen["permissive"] += int(np.any(_iou(
            boxes[t][matched], np.asarray(jst.boxes)[jslot[matched]]) == 0))
        jst, jout = jtr.tracks_update(jst, jnp.asarray(boxes[t]),
                                      jnp.asarray(v),
                                      {k: jnp.asarray(a[t])
                                       for k, a in sig.items()},
                                      alpha=0.3, iou_threshold=thr,
                                      max_missed=trk["max_missed"])
        tst, tout = ttr.tracks_update(tst, _t(boxes[t]), _t(v),
                                      {k: _t(a[t]) for k, a in sig.items()},
                                      alpha=0.3, iou_threshold=thr,
                                      max_missed=trk["max_missed"])
        seen["expiry"] += int(np.any(active & ~np.asarray(jst.active)))
        _assert_state_equal(tst, jst)
        for k in sig:
            np.testing.assert_allclose(tout[k].numpy()[v],
                                       np.asarray(jout[k])[v], **TOL)
    assert seen[case] > 0, seen


@pytest.mark.parametrize("case", sorted(CASES))
def test_track_sequence_one_pass_and_chunked_match_jax(case):
    """track_sequence over the timeline in one pass, and in two chunks with
    the state carried, against JAX's one scan: smoothed signals within
    1e-6 on valid rows, final states equal."""
    tl, trk = CASES[case]
    boxes, valid, poses = _timeline(**tl)
    sig = {"poses": poses, "boxes": boxes}
    kw = dict(alpha=0.25, max_missed=trk["max_missed"],
              num_slots=trk["num_slots"],
              iou_threshold=trk.get("iou_threshold", 0.3))
    want, wst = jtr.track_sequence(boxes, valid, sig, return_state=True,
                                   **kw)
    one, ost = ttr.track_sequence(_t(boxes), _t(valid),
                                  {k: _t(v) for k, v in sig.items()},
                                  return_state=True, **kw)
    h = len(boxes) // 2 + 1
    a, st = ttr.track_sequence(boxes[:h], valid[:h],
                               {k: v[:h] for k, v in sig.items()},
                               return_state=True, **kw)
    b, cst = ttr.track_sequence(boxes[h:], valid[h:],
                                {k: v[h:] for k, v in sig.items()},
                                state=st, return_state=True, **kw)
    for got, gst in ((one, ost), ({k: torch.cat([a[k], b[k]]) for k in a},
                                  cst)):
        _assert_state_equal(gst, wst)
        for k in sig:
            np.testing.assert_allclose(got[k].numpy()[valid],
                                       np.asarray(want[k])[valid], **TOL)


def _frames_against_jax(boxes, valid, sig, slots, thr, frames):
    """tracks_update frame by frame from the same state in JAX and in the
    port: states and smoothed signals of every row (valid or not) within
    TOL, NaN where JAX has NaN; associate's slots equal on every row."""
    import jax.numpy as jnp

    jst = jtr.tracks_init({k: jnp.asarray(v[0]) for k, v in sig.items()},
                          slots)
    tst = ttr.tracks_init({k: _t(v[0]) for k, v in sig.items()}, slots)
    for t in frames:
        jslot, jnew = jtr.associate(jst.boxes, jst.active, jst.age,
                                    jnp.asarray(boxes[t]),
                                    jnp.asarray(valid[t]), thr)
        tslot, tnew = ttr.associate(tst.boxes, tst.active, tst.age,
                                    _t(boxes[t]), _t(valid[t]), thr)
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
        jst, jout = jtr.tracks_update(
            jst, jnp.asarray(boxes[t]), jnp.asarray(valid[t]),
            {k: jnp.asarray(a[t]) for k, a in sig.items()}, alpha=0.3,
            iou_threshold=thr)
        tst, tout = ttr.tracks_update(
            tst, _t(boxes[t]), _t(valid[t]),
            {k: _t(a[t]) for k, a in sig.items()}, alpha=0.3,
            iou_threshold=thr)
        _assert_state_equal(tst, jst)
        for k in sig:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       **TOL)
    return tst


def test_threshold_below_minus_one_is_refused():
    """Below -1 the reference matches pairs it marks ineligible or retired
    (-1 clears the threshold) and runs all of its min(F, T) greedy steps;
    the port no longer refuses such a threshold and runs the same steps:
    slots (invalid rows included), states and smoothed signals as JAX's
    over a timeline at iou_threshold=-1.5."""
    boxes, valid, poses = _timeline(seed=0, faces=3)
    st = _frames_against_jax(boxes, valid, {"poses": poses, "boxes": boxes},
                             slots=4, thr=-1.5, frames=range(6))
    assert bool(st.active.any())


@pytest.mark.parametrize("what", ["nan_row", "inf_row", "invalid_nan_row"])
def test_nonfinite_signals_spread_as_in_jax(what):
    """A NaN or inf in one detection row (valid, or invalid and so weighted
    0) goes through JAX's one-hot products, where 0 * NaN and 0 * inf are
    NaN: every track's measurement of that channel turns NaN, and so does
    every detection's smoothed value from then on.  The port's elementwise
    one-hot sums give the same NaN pattern and the same finite values
    (TOL)."""
    boxes, valid, poses = _timeline(seed=5, faces=3, p_face=0.9)
    poses = poses.copy()
    row = int(np.flatnonzero(valid[2] if what != "invalid_nan_row"
                             else ~valid[2])[0])
    poses[2, row, 1] = np.inf if what == "inf_row" else np.nan
    st = _frames_against_jax(boxes, valid, {"poses": poses, "boxes": boxes},
                             slots=12, thr=0.3, frames=range(5))
    assert bool(torch.isnan(st.ema.value["poses"][:, 1]).any())


def test_iou_track_smoother_matches_jax():
    """The stateful live-stream trackers, frame by frame, with overflow
    (two slots for up to six faces)."""
    boxes, valid, poses = _timeline(seed=5, faces=6, p_face=0.8)
    jt = jtr.IoUTrackSmoother(alpha=0.4, num_slots=2, max_missed=3)
    tt = ttr.IoUTrackSmoother(alpha=0.4, num_slots=2, max_missed=3)
    for t in range(len(boxes)):
        sig = {"poses": poses[t], "boxes": boxes[t]}
        want = jt(boxes[t], valid[t], sig)
        got = tt(boxes[t], valid[t], sig)
        v = valid[t]
        for k in sig:
            np.testing.assert_allclose(got[k].numpy()[v],
                                       np.asarray(want[k])[v], **TOL)
    _assert_state_equal(tt._state, jt._state)


def test_ema_update_and_smooth_sequence_match_jax():
    """ema_update step by step with a validity mask, smooth_sequence in one
    pass and in carried chunks, on a tree with a list and nested dict."""
    rng = np.random.default_rng(7)
    T, F = 10, 5
    tree = {"poses": rng.normal(0, 30, (T, F, 3)).astype(np.float32),
            "nested": {"kp": [rng.normal(0, 1, (T, F, 6, 2)).astype(
                np.float32)]}}
    valid = rng.random((T, F)) < 0.6
    want, wst = jsm.smooth_sequence(tree, 0.2, valid=valid,
                                    return_state=True)
    got = tsm.smooth_sequence(tree, 0.2, valid=valid)
    a, st = tsm.smooth_sequence({k: _slice(v, 0, 4) for k, v in
                                 tree.items()}, 0.2, valid=valid[:4],
                                return_state=True)
    b, cst = tsm.smooth_sequence({k: _slice(v, 4, T) for k, v in
                                  tree.items()}, 0.2, valid=valid[4:],
                                 state=st, return_state=True)
    chunked = {"poses": torch.cat([a["poses"], b["poses"]]),
               "nested": {"kp": [torch.cat([a["nested"]["kp"][0],
                                            b["nested"]["kp"][0]])]}}
    for g in (got, chunked):
        np.testing.assert_allclose(g["poses"].numpy(),
                                   np.asarray(want["poses"]), **TOL)
        np.testing.assert_allclose(g["nested"]["kp"][0].numpy(),
                                   np.asarray(want["nested"]["kp"][0]), **TOL)
    np.testing.assert_array_equal(
        cst.initialized["poses"].numpy(), np.asarray(wst.initialized["poses"]))

    # one ema_update on its own, and the stateful TrackSmoother
    jstate = jsm.ema_init({"p": tree["poses"][0]})
    tstate = tsm.ema_init({"p": tree["poses"][0]})
    js, tt = jsm.TrackSmoother(0.3), tsm.TrackSmoother(0.3)
    for t in range(T):
        jstate, jv = jsm.ema_update(jstate, {"p": tree["poses"][t]}, 0.3,
                                    valid=valid[t])
        tstate, tv = tsm.ema_update(tstate, {"p": tree["poses"][t]}, 0.3,
                                    valid=valid[t])
        np.testing.assert_allclose(tv["p"].numpy(), np.asarray(jv["p"]),
                                   **TOL)
        np.testing.assert_array_equal(tstate.initialized["p"].numpy(),
                                      np.asarray(jstate.initialized["p"]))
        np.testing.assert_allclose(
            tt({"p": tree["poses"][t]}, valid[t])["p"].numpy(),
            np.asarray(js({"p": tree["poses"][t]}, valid[t])["p"]), **TOL)


def _slice(v, a, b):
    if isinstance(v, dict):
        return {k: _slice(x, a, b) for k, x in v.items()}
    if isinstance(v, list):
        return [_slice(x, a, b) for x in v]
    return v[a:b]


def test_process_frames_matches_jax():
    """12 corpus frames as one timeline (batch_size=12, one XLA compile)
    through the port's CPU flagship and the JAX package's process_frames:
    valid identical, smoothed poses within 2e-3 deg and boxes within 1e-4
    (the detectors' own agreement, tests/test_torch_detector.py)."""
    from headpose_tpu.pretrained import flagship_detector as jax_flagship
    from headpose_tpu.runtime.offline import process_frames as jax_process
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.runtime.offline import process_frames

    frames = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:12]
    want = jax_process(jax_flagship(), frames, batch_size=12)
    got = process_frames(flagship_detector(device="cpu"), frames,
                         batch_size=12)
    np.testing.assert_array_equal(got.valid, want.valid)
    v = want.valid
    assert v.sum() > 12
    np.testing.assert_allclose(got.poses[v], want.poses[v], atol=2e-3)
    np.testing.assert_allclose(got.boxes[v], want.boxes[v], atol=1e-4)
    np.testing.assert_allclose(got.keypoints[v], want.keypoints[v],
                               atol=1e-4)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5)


def test_process_video_matches_jax(tmp_path):
    """A 10-frame video read in chunks of 4 (the smoothing state carried
    across chunks) through the port's process_video and the JAX package's:
    valid identical, smoothed poses within 2e-3 deg; it equals the port's
    process_frames over the decoded frames in one pass; with out_path the
    same slabs come back and the annotated copy has every frame."""
    cv2 = pytest.importorskip("cv2")
    from headpose_tpu.pretrained import flagship_detector as jax_flagship
    from headpose_tpu.runtime.offline import process_video as jax_video
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.runtime.offline import (process_frames,
                                                    process_video)

    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (128, 128))
    for frame in np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][
            :10]:
        writer.write(frame)
    writer.release()
    cap = cv2.VideoCapture(path)
    decoded = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        decoded.append(frame)
    cap.release()
    assert len(decoded) == 10

    det = flagship_detector(device="cpu")
    got = process_video(det, path, batch_size=4)
    want = jax_video(jax_flagship(), path, batch_size=4)
    one = process_frames(det, np.stack(decoded), batch_size=4)
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.valid, one.valid)
    v = got.valid
    assert v.sum() >= 10
    np.testing.assert_allclose(got.poses[v], want.poses[v], atol=2e-3)
    np.testing.assert_allclose(got.boxes[v], want.boxes[v], atol=1e-4)
    for field in ("boxes", "keypoints", "scores", "poses"):
        np.testing.assert_allclose(getattr(got, field)[v],
                                   getattr(one, field)[v], **TOL)
    drawn = process_video(det, path, out_path=str(tmp_path / "out.mp4"),
                          batch_size=4)
    np.testing.assert_array_equal(drawn.poses, got.poses)
    cap = cv2.VideoCapture(str(tmp_path / "out.mp4"))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 10
