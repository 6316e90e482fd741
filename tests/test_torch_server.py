"""The port's DynamicBatcher (headpose_tpu_torch.runtime.server) against the
JAX package's, on the CPU: the width ladder and the dispatch widths of one
submission sequence (stub detectors of each package, no XLA compile), the
served CPU flagship against its own direct `detect`, and the contract —
cancellation, the shape pin, empty frames, the close() race and a failing
detector resolving every waiter."""
from __future__ import annotations

import os
import time
from concurrent.futures import Future

import numpy as np
import pytest

from headpose_tpu.runtime import results as jres
from headpose_tpu.runtime.server import DynamicBatcher as JaxBatcher
from headpose_tpu_torch.runtime import results as tres
from headpose_tpu_torch.runtime.server import DynamicBatcher
from test_torch_http import StubDetector, stub_faces, stub_frames

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TIMEOUT = 60


@pytest.mark.parametrize("granularity", [1, 2, 3, 8])
def test_ladder_matches_jax(granularity):
    for max_batch in (1, 2, 5, 8, 9, 100, 128, 129):
        with JaxBatcher(StubDetector(jres, granularity),
                        max_batch=max_batch) as want, \
                DynamicBatcher(StubDetector(tres, granularity),
                               max_batch=max_batch) as got:
            assert got.widths == want.widths, max_batch
            assert got.max_batch == want.max_batch
    assert DynamicBatcher(StubDetector(tres), max_batch=8).widths == \
        (1, 2, 4, 8)
    with pytest.raises(ValueError, match="max_batch"):
        DynamicBatcher(StubDetector(tres), max_batch=0)


def _bursts(batcher_cls, results, sizes, max_batch):
    """Each burst submitted at once, then awaited: the dispatch widths and
    the counters."""
    stub = StubDetector(results)
    frames = stub_frames(max(sizes), seed=5)
    out = []
    with batcher_cls(stub, max_batch=max_batch, max_delay=0.5) as b:
        for n in sizes:
            futs = [b.submit(f) for f in frames[:n]]
            out.append([f.result(TIMEOUT) for f in futs])
        counters = (b.dispatches, b.frames_served)
    return stub.widths, counters, out


def test_dispatch_widths_match_jax():
    """The same sequence of bursts gives the same padded dispatch widths,
    counters and per-request results on both batchers; each request gets
    its own frame's detections."""
    sizes, max_batch = (3, 1, 9, 16, 17, 5), 8
    want = _bursts(JaxBatcher, jres, sizes, max_batch)
    got = _bursts(DynamicBatcher, tres, sizes, max_batch)
    assert got[0] == want[0] == [4, 1, 8, 1, 8, 8, 8, 8, 1, 8]
    assert got[1] == want[1] == (10, sum(sizes))
    frames = stub_frames(max(sizes), seed=5)
    for burst_got, burst_want in zip(got[2], want[2]):
        for i, (g, w) in enumerate(zip(burst_got, burst_want)):
            for k, field in enumerate(("boxes", "keypoints", "scores",
                                       "poses")):
                np.testing.assert_array_equal(getattr(g, field),
                                              getattr(w, field))
                np.testing.assert_array_equal(getattr(g, field),
                                              stub_faces(frames[i])[k])


def test_results_match_direct_detect():
    """12 corpus frames submitted at once through the port's CPU flagship:
    each request's Results equal the detector's own direct detect of the
    12 (sets identical, boxes 1e-5, poses 1e-4), in fewer dispatches than
    requests."""
    from headpose_tpu_torch.pretrained import flagship_detector

    det = flagship_detector(device="cpu")
    frames = list(np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"]
                  [:12])
    direct = det.detect(np.stack(frames)).trim()
    with DynamicBatcher(det, max_batch=16, max_delay=0.25) as b:
        futs = [b.submit(f) for f in frames]
        got = [f.result(TIMEOUT) for f in futs]
        assert b.frames_served == 12 and b.dispatches < 12
    for g, w in zip(got, direct):
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(g.boxes, w.boxes, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.keypoints, w.keypoints, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.scores, w.scores, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.poses, w.poses, rtol=1e-4, atol=1e-4)


def test_contract_errors():
    """A batch, RGBA channels and an empty (0, 0, 3) frame are refused
    without pinning the shape; the first frame pins it and another size is
    refused; a constructor pin takes (H, W); a closed batcher refuses."""
    frames = stub_frames(2, seed=6, size=16)
    b = DynamicBatcher(StubDetector(tres), max_batch=4, max_delay=0.01)
    try:
        for bad in (np.stack(frames), np.zeros((16, 16, 4), np.uint8),
                    np.zeros((0, 0, 3), np.uint8)):
            with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
                b.submit(bad)
        assert b.frame_shape is None
        b.submit(frames[0]).result(TIMEOUT)
        assert b.frame_shape == (16, 16, 3)
        with pytest.raises(ValueError, match="one shape"):
            b.submit(frames[0][:8])
    finally:
        assert b.close() is True
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(frames[0])
    with DynamicBatcher(StubDetector(tres), frame_shape=(8, 8)) as pinned:
        assert pinned.frame_shape == (8, 8, 3)
        with pytest.raises(ValueError, match="one shape"):
            pinned.submit(frames[0])
    with pytest.raises(ValueError, match="frame_shape"):
        DynamicBatcher(StubDetector(tres), frame_shape=(8, 8, 4))


def test_cancelled_future_does_not_kill_dispatcher():
    """A cancelled request is neither dispatched nor resolved, and the
    dispatcher serves on."""
    frames = stub_frames(2, seed=7)
    stub = StubDetector(tres)
    with DynamicBatcher(stub, max_batch=4, max_delay=0.2) as b:
        doomed = b.submit(frames[0])
        assert doomed.cancel()
        res = b.detect(frames[1], timeout=TIMEOUT)
        assert len(res) == len(stub_faces(frames[1])[2])
        assert b.frames_served == 1 and stub.widths == [1]


def test_close_flushes_queued_work():
    stub = StubDetector(tres, delay=0.05)
    b = DynamicBatcher(stub, max_batch=4, max_delay=0.01)
    futs = [b.submit(f) for f in stub_frames(6, seed=8)]
    assert b.close(timeout=TIMEOUT) is True
    assert all(f.result(timeout=1) is not None for f in futs)
    assert b.frames_served == 6


def test_close_race_resolves_stragglers():
    """A request that slipped into the queue after the dispatcher exited
    (a submit racing with close) is resolved with RuntimeError, not left
    hanging."""
    b = DynamicBatcher(StubDetector(tres), max_batch=4, max_delay=0.01)
    b._closed.set()
    b._thread.join(TIMEOUT)
    assert not b._thread.is_alive()
    straggler: Future = Future()
    b._q.put((stub_frames(1)[0], straggler, time.monotonic()))
    assert b.close(timeout=TIMEOUT) is True
    with pytest.raises(RuntimeError, match="raced"):
        straggler.result(timeout=1)


def test_failing_detector_resolves_every_waiter():
    """Every waiter of a failed dispatch gets the detector's exception;
    the dispatcher thread lives on and serves the next request."""
    stub = StubDetector(tres, fail=RuntimeError("kernel launch failed"))
    frames = stub_frames(5, seed=9)
    with DynamicBatcher(stub, max_batch=8, max_delay=0.2) as b:
        futs = [b.submit(f) for f in frames]
        for f in futs:
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                f.result(TIMEOUT)
        assert b.dispatches == 0 and b.frames_served == 0
        stub.fail = None
        assert len(b.detect(frames[0], timeout=TIMEOUT)) == \
            len(stub_faces(frames[0])[2])
        assert b._thread.is_alive() and b.dispatches == 1
