"""Client SDK for the PoseServer HTTP endpoint (`runtime/http.py`).

Port of headpose_tpu/runtime/client.py; it speaks to either package's
server.  The wire protocol is deliberately trivial (np.save'd frame in, JSON
faces out — see runtime/http.py), so any language can speak it with no SDK
at all.  This module is the first-class Python client: typed `Results` back
(the same ragged contract `FaceDetector.detect_single` returns, so swapping
local inference for remote inference changes one constructor), HTTP/1.1
keep-alive connection reuse (no TCP handshake per frame), transparent
reconnect when the server drops a kept-alive connection (its error replies
close the socket by design), and a concurrent `detect_many` whose in-flight
requests are exactly what the server's DynamicBatcher coalesces into wide
dispatches on the card.

    with PoseClient("http://host:8000") as c:
        faces = c.detect(frame)               # one frame -> Results
        all_faces = c.detect_many(frames)     # concurrent fan-out

Importing it loads `runtime.results` and nothing of the detector or the
models.
"""
from __future__ import annotations

import http.client
import io
import json
import socket
import threading
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .results import Results

__all__ = ["PoseClient"]


def _results_from_json(body: dict) -> Results:
    """JSON faces (runtime/http.py's response contract) -> ragged Results."""
    faces = body["faces"]
    n = len(faces)
    return Results(
        boxes=np.array([f["box"] for f in faces],
                       np.float32).reshape(n, 4),
        keypoints=np.array([f["keypoints"] for f in faces],
                           np.float32).reshape(n, 6, 2),
        scores=np.array([f["score"] for f in faces], np.float32),
        poses=np.array([f["pose"] for f in faces],
                       np.float32).reshape(n, 3),
    )


class PoseClient:
    """One PoseServer endpoint, many calls.

    Connections are per-thread (http.client connections are not
    thread-safe), created lazily and kept alive across calls; a stale or
    server-closed connection is rebuilt and the request retried once —
    POSTs here are idempotent (pure inference), so the retry is safe.

    Server error replies map back to the exception the failure deserves:
    400/413 -> ValueError (bad frame), 503 -> RuntimeError (server
    closed), 504 -> TimeoutError, anything else -> RuntimeError.
    """

    def __init__(self, url: str, *, timeout: float = 120.0):
        parsed = urllib.parse.urlsplit(url if "//" in url else f"//{url}")
        if parsed.scheme not in ("", "http"):
            raise ValueError(f"only http:// endpoints supported, got {url!r}")
        if not parsed.hostname:
            raise ValueError(f"no host in {url!r}")
        if parsed.path.strip("/"):
            raise ValueError(
                f"path prefixes are not supported ({url!r}): the endpoint's "
                "routes live at the root (/v1/detect); point the client at "
                "host:port and put prefix rewriting in the fronting proxy")
        # explicit scheme + no port = the scheme's standard port; a bare
        # host:port string without either falls back to the CLI's default
        self._host = parsed.hostname
        self._port = parsed.port or (80 if parsed.scheme == "http" else 8000)
        self._timeout = timeout
        self._local = threading.local()
        self._pool: ThreadPoolExecutor | None = None
        self._pool_size = 0
        self._pool_lock = threading.Lock()
        self._closed = False

    # -- transport ---------------------------------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self._host, self._port,
                                              timeout=self._timeout)
            # http.client sends headers and body in separate send()s; with
            # Nagle on, the body waits for the server's delayed ACK — a flat
            # +40 ms per request (the Linux delayed-ACK timer)
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.conn = conn
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def _request(self, method: str, route: str,
                 body: bytes | None = None) -> dict:
        if self._closed:
            raise RuntimeError("PoseClient is closed")
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request(method, route, body=body)
                resp = conn.getresponse()
                payload = json.loads(resp.read().decode())
                status = resp.status
                if resp.headers.get("Connection", "").lower() == "close":
                    # the server's error replies end the connection; drop
                    # ours too or the next request writes into a dead socket
                    self._drop_connection()
            except TimeoutError:
                # a live-but-slow server, not a dead socket: re-sending the
                # request would duplicate inference on an already-overloaded
                # server and double the caller's wait — surface it
                self._drop_connection()  # mid-request socket is undefined
                raise
            except (http.client.HTTPException, ConnectionError, OSError):
                # stale keep-alive (server restarted, idle reap, error-path
                # close that raced our send): rebuild once and retry —
                # safe, the POST is pure inference (idempotent)
                self._drop_connection()
                if attempt:
                    raise
                continue
            return self._raise_for_status(status, payload)
        raise AssertionError("unreachable")

    @staticmethod
    def _raise_for_status(status: int, payload: dict) -> dict:
        if status == 200:
            return payload
        msg = payload.get("error", f"HTTP {status}")
        if status in (400, 404, 413):
            raise ValueError(msg)
        if status == 504:
            raise TimeoutError(msg)
        raise RuntimeError(f"HTTP {status}: {msg}")

    # -- API ----------------------------------------------------------------

    def detect(self, frame: np.ndarray) -> Results:
        """One (H, W, 3) uint8 BGR frame -> ragged Results (remote)."""
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(frame))
        return _results_from_json(
            self._request("POST", "/v1/detect", buf.getvalue()))

    # Per-request ceilings mirroring the server's (runtime/http.py:
    # MAX_BODY_BYTES 64 MB, MAX_BATCH_ROWS 1024), with headroom so a
    # default client never trips a default server's limits: ~48 MB of
    # frame bytes (the npy header adds ~100 B) and 512 rows per request.
    _CHUNK_BYTES = 48 * 1024 * 1024
    _CHUNK_ROWS = 512

    def detect_batch(self, frames) -> list[Results]:
        """A whole (B, H, W, 3) batch in as few round trips as the server's
        body limits allow — the efficient remote path for offline work
        (ordinary batches fit one request; bigger ones are split into
        ≤48 MB / ≤512-row chunks transparently).  detect_many trades more
        round trips for lower per-frame latency; this trades latency for
        wire efficiency."""
        batch = np.ascontiguousarray(frames)
        if batch.ndim != 4:
            raise ValueError(f"detect_batch takes a (B, H, W, 3) array, "
                             f"got shape {batch.shape}")
        per_row = max(1, batch[0].nbytes)
        rows = max(1, min(self._CHUNK_ROWS, self._CHUNK_BYTES // per_row))
        out: list[Results] = []
        for start in range(0, batch.shape[0], rows):
            buf = io.BytesIO()
            np.save(buf, batch[start:start + rows])
            body = self._request("POST", "/v1/detect_batch", buf.getvalue())
            out.extend(_results_from_json(r) for r in body["results"])
        return out

    def detect_many(self, frames, *, concurrency: int = 16) -> list[Results]:
        """Concurrent fan-out: results in input order.

        The in-flight window (up to `concurrency` requests) is what the
        server batches into shared device dispatches — a sequential loop
        over `detect` would serve every frame at batch 1.  The worker pool
        (and each worker's keep-alive connection) persists across calls,
        so a streaming loop pays the TCP handshakes once, not per call.
        """
        frames = list(frames)
        if not frames:
            return []
        return list(self._workers(max(1, concurrency)).map(self.detect,
                                                           frames))

    def _workers(self, concurrency: int) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None or self._pool_size < concurrency:
                if self._pool is not None:
                    self._pool.shutdown(wait=False)
                self._pool = ThreadPoolExecutor(
                    max_workers=concurrency,
                    thread_name_prefix="pose-client")
                self._pool_size = concurrency
            return self._pool

    def health(self) -> dict:
        return self._request("GET", "/v1/health")

    def stats(self) -> dict:
        return self._request("GET", "/v1/stats")

    def close(self) -> None:
        """Drop this thread's connection, stop the fan-out pool, and refuse
        further calls.  Per-thread sockets opened by user threads are
        reclaimed with those threads."""
        self._closed = True
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None
        self._drop_connection()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
