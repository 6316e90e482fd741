"""The port's PoseClient (headpose_tpu_torch.runtime.client) and
BatchResults.from_ragged against the JAX package's, on the CPU: each client
against the other package's server (stub detectors, no XLA compile),
detect_batch's chunking, the stale-connection retry, detect_many's order
and persistent pool, the error mapping, and from_ragged field by field."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from headpose_tpu.runtime import client as jclient
from headpose_tpu.runtime import http as jhttp
from headpose_tpu.runtime import results as jres
from headpose_tpu_torch.runtime import client as tclient
from headpose_tpu_torch.runtime import http as thttp
from headpose_tpu_torch.runtime import results as tres
from test_torch_http import StubDetector, stub_faces, stub_frames

FIELDS = ("boxes", "keypoints", "scores", "poses")
TIMEOUT = 60


def _assert_equal(got, want):
    assert len(got) == len(want)
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b)


@pytest.fixture()
def server():
    with thttp.PoseServer(StubDetector(tres), port=0, max_batch=16,
                          max_delay=0.05) as srv:
        yield srv


@pytest.mark.parametrize("pair", ["port_client_jax_server",
                                  "jax_client_port_server"])
def test_clients_and_servers_interoperate(pair):
    """Each package's client against the other's server: detect,
    detect_batch and detect_many give equal Results, equal to the stub's
    detections for each frame, and the Results class is the client's."""
    client_mod, server_mod, stub_res = (
        (tclient, jhttp, jres) if pair == "port_client_jax_server"
        else (jclient, thttp, tres))
    frames = stub_frames(6, seed=11)
    with server_mod.PoseServer(StubDetector(stub_res), port=0, max_batch=8,
                               max_delay=0.05) as srv, \
            client_mod.PoseClient(srv.url, timeout=TIMEOUT) as c:
        single = [c.detect(f) for f in frames]
        batch = c.detect_batch(np.stack(frames))
        many = c.detect_many(frames, concurrency=4)
        assert c.health() == {"status": "ok"}
        assert c.stats()["frames_served"] == 3 * len(frames)
    results_cls = (tres if client_mod is tclient else jres).Results
    for f, s, b, m in zip(frames, single, batch, many):
        assert isinstance(s, results_cls)
        want = results_cls(*stub_faces(f))
        for got in (s, b, m):
            _assert_equal(got, want)


def test_detect_batch_chunks_transparently(server):
    """Past the row or byte budget a batch splits into several requests and
    still returns one ordered list."""
    frames = stub_frames(6, seed=12)
    with tclient.PoseClient(server.url, timeout=TIMEOUT) as c:
        c._CHUNK_ROWS = 2                      # 3 chunks
        got = c.detect_batch(np.stack(frames))
        assert c.stats()["requests"] == 3
        c._CHUNK_ROWS = 512
        c._CHUNK_BYTES = frames[0].nbytes * 2 + 1
        got4 = c.detect_batch(np.stack(frames[:4]))
        assert c.stats()["requests"] == 3 + 2
        with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
            c.detect_batch(frames[0])
    for f, g in zip(frames, got):
        _assert_equal(g, tres.Results(*stub_faces(f)))
    for f, g in zip(frames, got4):
        _assert_equal(g, tres.Results(*stub_faces(f)))


def test_stale_connection_retry(server):
    """A connection dropped under the client is rebuilt and the request
    retried once, invisibly."""
    frame = stub_frames(1, seed=13)[0]
    with tclient.PoseClient(server.url, timeout=TIMEOUT) as c:
        first = c.detect(frame)
        c._local.conn.sock.close()            # an idle reap or a restart
        _assert_equal(c.detect(frame), first)
        assert c.stats()["requests"] == 2


def test_detect_many_order_and_pool(server):
    """Results come back in input order; the pool persists across calls and
    grows once for a wider call; close() stops it."""
    frames = stub_frames(12, seed=14)
    with tclient.PoseClient(server.url, timeout=TIMEOUT) as c:
        got = c.detect_many(frames, concurrency=8)
        pool = c._pool
        c.detect_many(frames[:3], concurrency=3)
        assert c._pool is pool
        c.detect_many(frames[:2], concurrency=16)
        assert c._pool is not pool
        assert c.detect_many([]) == []
    assert c._pool is None
    for f, g in zip(frames, got):
        _assert_equal(g, tres.Results(*stub_faces(f)))


def test_error_mapping_and_url_forms(server):
    """400 -> ValueError, 503 -> RuntimeError; the client serves on after
    an error reply closed its connection; URL forms as the JAX client's;
    a closed client refuses."""
    frame = stub_frames(1, seed=15)[0]
    c = tclient.PoseClient(f"{server.host}:{server.port}", timeout=TIMEOUT)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        c.detect(np.zeros((2, 4, 4, 3), np.uint8))
    _assert_equal(c.detect(frame), tres.Results(*stub_faces(frame)))
    server.batcher.close(timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="503"):
        c.detect(frame)
    c.close()
    with pytest.raises(RuntimeError, match="closed"):
        c.health()
    for url in ("http://example.com", "example.com",
                "http://example.com:8123"):
        assert tclient.PoseClient(url)._port == jclient.PoseClient(url)._port
    for url, match in (("https://example.com", "http"),
                       ("http://example.com:8000/pose", "prefix")):
        with pytest.raises(ValueError, match=match):
            tclient.PoseClient(url)


@pytest.mark.parametrize("max_faces", [1, 2, 100])
def test_from_ragged_matches_jax(max_faces):
    """from_ragged of the same ragged results: every field equal to JAX's
    (top rows kept past max_faces, the rest zero), and trim() its
    inverse."""
    frames = stub_frames(8, seed=16)
    ragged = [stub_faces(f) for f in frames]
    assert max(len(r[2]) for r in ragged) > 2     # truncation is reached
    assert min(len(r[2]) for r in ragged) == 0
    want = jres.BatchResults.from_ragged([jres.Results(*r) for r in ragged],
                                         max_faces=max_faces)
    got = tres.BatchResults.from_ragged([tres.Results(*r) for r in ragged],
                                        max_faces=max_faces)
    assert got.slab.device.type == "cpu"
    for k in (*FIELDS, "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    for g, w in zip(got.trim(), want.trim()):
        _assert_equal(g, w)
    if max_faces == 100:
        for g, r in zip(got.trim(), ragged):
            _assert_equal(g, tres.Results(*r))


def test_importing_the_client_loads_no_detector_or_model():
    """runtime.client needs runtime.results alone: a remote-only host does
    not import the detector, the models or the kernels' wrappers."""
    script = ("import json, sys\n"
              "import headpose_tpu_torch.runtime.client\n"
              "print(json.dumps([m for m in sys.modules\n"
              "                  if m.startswith('headpose_tpu_torch')]))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, check=True, cwd=repo).stdout
    loaded = json.loads(out)
    assert "headpose_tpu_torch.runtime.client" in loaded
    for heavy in ("runtime.detector", "models", "ops.kernels",
                  "runtime.fused"):
        assert not any(m.startswith(f"headpose_tpu_torch.{heavy}")
                       for m in loaded), (heavy, loaded)
