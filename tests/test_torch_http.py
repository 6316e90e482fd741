"""The port's PoseServer (headpose_tpu_torch.runtime.http) against the JAX
package's, on the CPU.

The JAX server is pure host code around a `detect` callable, so a stub
detector that returns one fixed set of detections makes it the wire-level
oracle with no XLA compile: the same requests go to both servers, each in
front of the stub of its own package, and every route, error code and fuzz
body must give the same status and the same bytes (uptime and latencies
masked, and the port's queue waits, which the JAX server does not report,
left out).  Then the port's server on its CPU flagship against the JAX
flagship's `detect`, and `_build_detector`.

The stubs here are shared with tests/test_torch_server.py and
tests/test_torch_client.py."""
from __future__ import annotations

import http.client
import importlib.util
import io
import json
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from headpose_tpu.runtime import http as jhttp
from headpose_tpu.runtime import results as jres
from headpose_tpu_torch.runtime import http as thttp
from headpose_tpu_torch.runtime import results as tres

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TIMEOUT = 60


def stub_faces(frame: np.ndarray):
    """Detections derived from the frame's content (0-3 faces), so a result
    routed to the wrong request shows: (boxes, keypoints, scores, poses)."""
    rng = np.random.default_rng(int(frame.astype(np.int64).sum()))
    n = int(frame.reshape(-1)[0]) % 4
    xy = rng.uniform(0.0, 0.6, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(0.1, 0.3, (n, 2))],
                           1).astype(np.float32)
    keypoints = rng.uniform(0.0, 1.0, (n, 6, 2)).astype(np.float32)
    scores = np.sort(rng.uniform(0.4, 1.0, n))[::-1].astype(np.float32)
    poses = rng.normal(0.0, 40.0, (n, 3)).astype(np.float32)
    return boxes, keypoints, scores, poses


class StubDetector:
    """`.detect(batch) -> BatchResults` of one package (`results`, that
    package's runtime.results module) from `stub_faces`; records each
    dispatch's width.  `delay` sleeps in detect; `fail` raises from it."""

    def __init__(self, results, batch_granularity: int = 1,
                 delay: float = 0.0, fail: Exception | None = None):
        self.results = results
        self.batch_granularity = batch_granularity
        self.delay = delay
        self.fail = fail
        self.widths: list[int] = []

    def detect(self, batch):
        self.widths.append(len(batch))
        if self.delay:
            time.sleep(self.delay)
        if self.fail is not None:
            raise self.fail
        ragged = [self.results.Results(*stub_faces(f)) for f in batch]
        return self.results.BatchResults.from_ragged(ragged)


def stub_frames(n: int, seed: int = 0, size: int = 16) -> list:
    rng = np.random.default_rng(seed)
    return list(rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8))


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def call(url: str, method: str, route: str, body: bytes | None = None):
    """(status, the headers that matter, body bytes); never raises on an
    HTTP error status."""
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
    try:
        conn.request(method, route, body=body)
        resp = conn.getresponse()
        heads = {k: resp.headers.get(k)
                 for k in ("Content-Type", "Content-Length", "Connection")}
        return resp.status, heads, resp.read()
    finally:
        conn.close()


_MASKS = [
    (re.compile(rb', "queue_wait_ms": \{[^}]*\}'), b""),
    (re.compile(rb'"uptime_s": [0-9.e+-]+'), b'"uptime_s": 0'),
    (re.compile(rb'"(p50|p99)": [0-9.e+-]+'), rb'"\1": 0'),
    (re.compile(rb"(headpose_uptime_seconds) [0-9.]+"), rb"\1 0"),
    (re.compile(rb'(quantile="0\.\d+"\}) [0-9.]+'), rb"\1 0"),
]


def masked(body: bytes) -> bytes:
    for pattern, repl in _MASKS:
        body = pattern.sub(repl, body)
    return body


def _same(jsrv, tsrv, method, route, body=None, mask=False):
    want = call(jsrv.url, method, route, body)
    got = call(tsrv.url, method, route, body)
    if mask:
        want = (want[0], {**want[1], "Content-Length": None},
                masked(want[2]))
        got = (got[0], {**got[1], "Content-Length": None}, masked(got[2]))
    assert got == want, (route, got, want)
    return got


@pytest.fixture()
def servers():
    """(JAX server, port server), each over its package's stub."""
    kw = dict(port=0, max_batch=8, max_delay=0.05)
    with jhttp.PoseServer(StubDetector(jres), **kw) as jsrv, \
            thttp.PoseServer(StubDetector(tres), **kw) as tsrv:
        yield jsrv, tsrv


def test_routes_match_jax_byte_for_byte(servers):
    """Every route, in one sequence on both servers: health, stats before
    and after work, detect, detect_batch, /metrics, and 404 on GET and
    POST."""
    jsrv, tsrv = servers
    frames = stub_frames(6, seed=1)
    assert _same(jsrv, tsrv, "GET", "/v1/health")[0] == 200
    assert _same(jsrv, tsrv, "GET", "/v1/stats", mask=True)[0] == 200
    assert _same(jsrv, tsrv, "GET", "/metrics", mask=True)[0] == 200
    counts = set()
    for f in frames:
        status, _, body = _same(jsrv, tsrv, "POST", "/v1/detect", npy(f))
        assert status == 200
        counts.add(json.loads(body)["count"])
    assert len(counts) > 1                       # the stub varies
    status, _, body = _same(jsrv, tsrv, "POST", "/v1/detect_batch",
                            npy(np.stack(frames)))
    assert status == 200 and json.loads(body)["count"] == len(frames)
    for route in ("/v1/stats", "/metrics"):
        status, _, body = _same(jsrv, tsrv, "GET", route, mask=True)
        assert status == 200 and b"0" in body
    assert _same(jsrv, tsrv, "GET", "/v1/nope")[0] == 404
    assert _same(jsrv, tsrv, "POST", "/v1/nope", b"x")[0] == 404


def test_metrics_match_jax_line_for_line(servers):
    jsrv, tsrv = servers
    for f in stub_frames(3, seed=2):
        _same(jsrv, tsrv, "POST", "/v1/detect", npy(f))
    want = masked(call(jsrv.url, "GET", "/metrics")[2]).decode()
    got = masked(call(tsrv.url, "GET", "/metrics")[2]).decode()
    assert got.splitlines() == want.splitlines()
    assert "headpose_frames_served_total 3" in got
    assert 'headpose_request_latency_seconds{quantile="0.99"} 0' in got


def test_error_codes_match_jax(servers, monkeypatch):
    """400 (empty, garbage, corrupt image, a batch on /v1/detect, a frame
    on /v1/detect_batch, too many rows, a second frame shape), 413, 415,
    then 503 once the batchers are closed; the errors count in /v1/stats
    alike."""
    jsrv, tsrv = servers
    frame = stub_frames(1, seed=3)[0]
    cases = [
        ("/v1/detect", b"", 400),
        ("/v1/detect", b"not-npy", 400),
        # a corrupt JPEG: undecodable (400), or 415 on a host without OpenCV
        ("/v1/detect", b"\xff\xd8\xff-corrupt",
         400 if importlib.util.find_spec("cv2") else 415),
        ("/v1/detect", npy(np.stack([frame, frame])), 400),
        ("/v1/detect_batch", npy(frame), 400),
        ("/v1/detect_batch", b"\x89PNG\r\n\x1a\nxx", 400),
        ("/v1/detect_batch",
         npy(np.zeros((jhttp.MAX_BATCH_ROWS + 1, 1, 2, 3), np.uint8)), 400),
        ("/v1/detect", npy(frame), 200),
        ("/v1/detect", npy(frame[:8]), 400),     # the pinned shape
    ]
    for route, body, code in cases:
        assert _same(jsrv, tsrv, "POST", route, body)[0] == code, route
    for mod in (jhttp, thttp):
        monkeypatch.setattr(mod, "MAX_BODY_BYTES", 256)
    assert _same(jsrv, tsrv, "POST", "/v1/detect", npy(frame))[0] == 413
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> error
    assert _same(jsrv, tsrv, "POST", "/v1/detect",
                 b"\x89PNG\r\n\x1a\n" + bytes(64))[0] == 415
    monkeypatch.undo()
    for srv in servers:
        assert srv.batcher.close(timeout=TIMEOUT) is True
    assert _same(jsrv, tsrv, "POST", "/v1/detect", npy(frame))[0] == 503
    _, _, body = _same(jsrv, tsrv, "GET", "/v1/stats", mask=True)
    assert json.loads(body)["errors"] == len(cases) + 2


# a failing detect: a RuntimeError (what torch raises for a CUDA fault and
# utils.build for a failed nvcc, and JAX for a device fault) is 503, as the
# JAX server answers it; any other exception (ctypes' OSError for a library
# that does not load) 500; a detector slower than request_timeout 504
FAILURES = {
    "runtime_error": (dict(fail=RuntimeError("CUDA error: launch failed")),
                      503, {}),
    "other_error": (dict(fail=OSError("libpostprocess.so: cannot open")),
                    500, {}),
    "timeout": (dict(delay=0.5), 504, dict(request_timeout=0.1)),
}


@pytest.mark.parametrize("failure", sorted(FAILURES))
def test_failing_detector_matches_jax(failure):
    """A failing or slow detector gives the JAX server's status and body on
    both routes, closes the connection, and the server serves on: no
    retry, on the CPU or anywhere else."""
    stub, code, kw = FAILURES[failure]
    with jhttp.PoseServer(StubDetector(jres, **stub), port=0, max_batch=4,
                          max_delay=0.01, **kw) as jsrv, \
            thttp.PoseServer(StubDetector(tres, **stub), port=0, max_batch=4,
                             max_delay=0.01, **kw) as tsrv:
        frame = stub_frames(1, seed=4)[0]
        status, heads, body = _same(jsrv, tsrv, "POST", "/v1/detect",
                                    npy(frame))
        assert status == code and heads["Connection"] == "close"
        assert _same(jsrv, tsrv, "POST", "/v1/detect_batch",
                     npy(np.stack([frame] * 3)))[0] == code
        assert _same(jsrv, tsrv, "GET", "/v1/health")[0] == 200
        assert len(tsrv.batcher.detector.widths) >= 1


def test_fuzz_bodies_match_jax(servers):
    """The adversarial bodies of tests/test_http.py: random bytes,
    truncated npy/JPEG/PNG magic, wrong dtypes, shapes and ndim — the same
    4xx and the same JSON error from both, and both serve real work
    after."""
    jsrv, tsrv = servers
    rng = np.random.default_rng(0)
    bodies = [rng.bytes(rng.integers(1, 4096)) for _ in range(20)]
    for magic in (b"\x93NUMPY", b"\xff\xd8\xff", b"\x89PNG\r\n\x1a\n"):
        bodies += [magic, magic + rng.bytes(64), magic + b"\x00" * 100]
    for arr in (np.zeros((4,), np.float32),          # wrong ndim
                np.zeros((2, 2), np.uint8),          # wrong ndim
                np.zeros((8, 8, 4), np.uint8),       # wrong channels
                np.zeros((0, 0, 3), np.uint8),       # empty dims
                np.zeros((2, 3, 4, 3), np.uint8)):   # a batch
        bodies.append(npy(arr))
    for body in bodies:
        status = _same(jsrv, tsrv, "POST", "/v1/detect", body)[0]
        assert 400 <= status < 500
    assert _same(jsrv, tsrv, "POST", "/v1/detect",
                 npy(stub_frames(1)[0]))[0] == 200
    _, _, body = _same(jsrv, tsrv, "GET", "/v1/stats", mask=True)
    assert json.loads(body)["errors"] == len(bodies)


def test_served_flagship_matches_jax_flagship():
    """The port's PoseServer on its CPU flagship, 12 corpus frames from 12
    concurrent clients, against the JAX flagship's detect of the same 12
    frames (one batch shape, one XLA compile): sets identical, boxes 1e-4,
    poses 2e-3 deg (tests/test_torch_detector.py's tolerances)."""
    from headpose_tpu.pretrained import flagship_detector as jax_flagship
    from headpose_tpu_torch.pretrained import flagship_detector

    frames = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:12]
    want = jax_flagship().detect(frames).trim()
    got = [None] * len(frames)
    with thttp.PoseServer(flagship_detector(device="cpu"), port=0,
                          max_batch=16, max_delay=0.25) as srv:
        def client(i):
            got[i] = json.loads(call(srv.url, "POST", "/v1/detect",
                                     npy(frames[i]))[2])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(frames))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        stats = json.loads(call(srv.url, "GET", "/v1/stats")[2])
    assert stats["frames_served"] == 12 and stats["errors"] == 0
    assert stats["dispatches"] < 12
    for g, w in zip(got, want):
        assert g["count"] == len(w) > 0
        for k, face in enumerate(g["faces"]):
            np.testing.assert_allclose(face["box"], w.boxes[k], atol=1e-4)
            np.testing.assert_allclose(face["keypoints"], w.keypoints[k],
                                       atol=1e-4)
            np.testing.assert_allclose(face["score"], w.scores[k], atol=1e-5)
            np.testing.assert_allclose(face["pose"], w.poses[k], atol=2e-3)


def test_build_detector(tmp_path):
    """A registry name, a native model directory, an H5 file (through
    FaceDetector.from_h5, as the JAX server builds it) and None (the
    flagship) build detectors; a file that is no H5 raises; an AOT artifact
    directory is refused, naming what is not ported; an unknown name is not
    found."""
    from headpose_tpu_torch.pretrained import FLAGSHIP, flagship_path

    best = thttp._build_detector("unified-best-distilled", device="cpu",
                                 precision="fast")
    assert best.precision == "fast" and best.device.type == "cpu"
    native = thttp._build_detector(flagship_path(), device="cpu",
                                   head_eval="survivors")
    assert native.head_eval == "survivors"
    flagship = thttp._build_detector(None, device="cpu")
    assert flagship.model == native.model
    assert os.path.basename(flagship_path()) == FLAGSHIP
    joined = os.path.join(os.path.dirname(__file__), "golden_torch",
                          "flagship_joined.h5")
    from_h5 = thttp._build_detector(joined, device="cpu", precision="fast")
    assert from_h5.model == native.model and from_h5.precision == "fast"
    h5 = tmp_path / "model.h5"
    h5.write_bytes(b"\x89HDF\r\n\x1a\n")
    with pytest.raises(OSError):
        thttp._build_detector(str(h5), device="cpu")
    aot = tmp_path / "artifact"
    aot.mkdir()
    (aot / "aot.json").write_text("{}")
    with pytest.raises(ValueError, match="tools.aot"):
        thttp._build_detector(str(aot), device="cpu")
    with pytest.raises(FileNotFoundError):
        thttp._build_detector("no-such-model", device="cpu")


def test_without_a_card_it_raises_and_never_serves_on_the_cpu(monkeypatch):
    """No device given means the card: without one _build_detector and the
    CLI raise instead of serving on the CPU; the CLI's precisions are JAX's
    four modes ("high" and "default", which _build_detector serves, are no
    choice of it), and _build_detector refuses what FaceDetector does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in (None, "unified-best-distilled"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thttp._build_detector(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thttp.main(["--port", "0"])
    for precision in ("high", "default"):
        with pytest.raises(SystemExit):
            thttp.main(["--port", "0", "--precision", precision])
    for precision in ("bfloat16", "bf16"):
        with pytest.raises(SystemExit):
            thttp.main(["--port", "0", "--precision", precision])
        with pytest.raises(ValueError, match="not served"):
            thttp._build_detector(None, device="cpu", precision=precision)
