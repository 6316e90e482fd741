"""HTTP serving front end: detection-as-a-service over the DynamicBatcher.

Port of headpose_tpu/runtime/http.py, wire for wire: for the same detections
every route answers with the same status and the same bytes.  It puts a
stdlib HTTP/1.1 endpoint in front of `runtime.server.DynamicBatcher`, so
concurrent requests — each carrying one frame — coalesce into wide
dispatches of `FaceDetector.detect` on the card (each request is handled on
its own thread by `ThreadingHTTPServer`; those threads block in
`batcher.detect`, which IS the coalescing mechanism — no extra queueing
layer).

Wire protocol (deliberately dependency-free — stdlib `urllib` + numpy on the
client side is enough):

  POST /v1/detect     body = one frame, either serialized with `np.save`
                      (the `.npy` container: dtype + shape + raw bytes),
                      shape (H, W, 3) uint8, BGR like the reference's cv2
                      frames — or a JPEG/PNG file (sniffed by magic bytes,
                      decoded server-side with OpenCV to the same BGR
                      contract), so `curl --data-binary @face.jpg` works
                      with no client code at all.  Response: 200 JSON
                      {"count": N, "faces": [{"box": [x1,y1,x2,y2],
                      "score": s, "pose": [yaw,pitch,roll],
                      "keypoints": [[x,y] * 6]}]} — boxes/keypoints
                      normalized to [0,1], pose in degrees (the ragged
                      `Results` contract of runtime/results.py).
  POST /v1/detect_batch
                      body = one np.save'd (B, H, W, 3) uint8 array.
                      Response: 200 JSON {"count": B, "results":
                      [<faces-object per frame, same schema as /v1/detect>]}.
                      One round trip for B frames — the efficient remote
                      path for offline jobs (the rows enter the batcher as
                      B submissions, so they share device dispatches with
                      every other client's frames).  Per request: at most
                      MAX_BATCH_ROWS rows and MAX_BODY_BYTES bytes —
                      PoseClient.detect_batch chunks larger batches
                      transparently.
  GET  /v1/health     200 {"status": "ok"} once the server accepts work.
  GET  /v1/stats      200 serving counters: frames served, device dispatches,
                      frames/dispatch (the coalescing ratio — the number that
                      says whether batching is earning its keep), request-
                      latency p50/p99 over the last 1000 requests, uptime.
  GET  /metrics       the same counters in Prometheus text exposition
                      format (text/plain; version=0.0.4), so a standard
                      scraper monitors the endpoint with zero glue.

Errors are JSON too: 400 malformed/ill-shaped payloads, 404 unknown routes,
413 oversized bodies, 415 image bodies on a server without OpenCV, 503
after `close()` and for any RuntimeError of `detect` (a CUDA fault, a
kernel that fails to build: the JAX server answers its device faults, also
RuntimeErrors, so), 504 past the request timeout, 500 for any other failure
of `detect`.  A failed dispatch is never retried, on the CPU or on a
kernel's plain version.

Serve the shipped flagship on the card from the command line:

    python -m headpose_tpu_torch.runtime.http --model unified-best-distilled \
        --precision fast --port 8000

Client round trip (or `runtime.client.PoseClient`):

    buf = io.BytesIO(); np.save(buf, frame)
    req = urllib.request.Request("http://host:8000/v1/detect",
                                 data=buf.getvalue(), method="POST")
    faces = json.load(urllib.request.urlopen(req))["faces"]
"""
from __future__ import annotations

import collections
import io
import json
import threading
import time
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .server import DynamicBatcher

__all__ = ["PoseServer"]

# One uncompressed 1080p BGR frame is ~6 MB; 64 MB rejects runaway bodies
# without ever touching a legitimate frame.  PoseClient.detect_batch chunks
# its requests to stay under this (client.py keeps its chunk budget below
# this value — change them together).
MAX_BODY_BYTES = 64 * 1024 * 1024
# Rows one /v1/detect_batch request may carry.  Bounds what a single small
# body can enqueue (a (10M, 1, 2, 3) array passes every byte/shape check but
# would flood the batcher with millions of futures); generous vs any real
# dispatch ladder (max_batch caps at 128-ish) while still O(seconds) of work.
MAX_BATCH_ROWS = 1024


class _UnsupportedMedia(Exception):
    """Image body on a host without OpenCV -> 415 (the media type is the
    problem, not the request)."""


def _faces_json(res) -> dict:
    """One ragged Results -> the wire's faces object (shared by /v1/detect
    and each row of /v1/detect_batch)."""
    return {
        "count": len(res),
        "faces": [{
            "box": [float(v) for v in res.boxes[i]],
            "score": float(res.scores[i]),
            "pose": [float(v) for v in res.poses[i]],
            "keypoints": [[float(x), float(y)]
                          for x, y in res.keypoints[i]],
        } for i in range(len(res))],
    }


def _quantile(sorted_vals: list, q: float) -> float:
    """Nearest-rank quantile of an ascending list (one definition shared by
    /v1/stats and /metrics, so the two surfaces can never drift)."""
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 keep-alive: a client streaming frames reuses its connection
    # instead of paying a TCP handshake per frame.
    protocol_version = "HTTP/1.1"
    # http.server writes headers and body in separate send()s; with Nagle on,
    # the second waits for the peer's delayed ACK — a flat +40 ms (the Linux
    # delayed-ACK timer) per response.
    disable_nagle_algorithm = True
    # Reap idle kept-alive connections: without a socket timeout every
    # abandoned-but-open connection pins a handler thread forever
    # (rfile.readline blocks indefinitely).  300 s outlives any legitimate
    # between-frames pause while bounding thread/fd growth.
    timeout = 300

    # The server object (set by PoseServer) carries the batcher + counters.
    server: "_Httpd"

    def log_message(self, fmt, *args):  # quiet by default; stats endpoint
        pass                            # replaces access-log archaeology

    # -- helpers ---------------------------------------------------------
    def _reply(self, code: int, payload: dict, *,
               close: bool = False) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if close:
            # error paths may leave an unread body in the pipe (e.g. 413
            # rejects before draining); under keep-alive those bytes would
            # be parsed as the next request — drop the connection instead
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0:
            raise ValueError("missing request body (np.save'd frame or "
                             "JPEG/PNG image)")
        if length > MAX_BODY_BYTES:
            raise OverflowError(f"body {length} B exceeds {MAX_BODY_BYTES} B")
        return self.rfile.read(length)

    @staticmethod
    def _load_npy(raw: bytes) -> np.ndarray:
        """Decode an np.save'd body (shared by both POST routes so any
        future hardening of the npy path covers them together)."""
        try:
            return np.load(io.BytesIO(raw), allow_pickle=False)
        except Exception as e:
            raise ValueError(f"body is not a .npy array: {e}") from None

    def _read_batch(self) -> np.ndarray:
        raw = self._read_body()
        if raw[:6] != b"\x93NUMPY":
            raise ValueError("detect_batch takes one np.save'd "
                             "(B, H, W, 3) array (images don't batch)")
        batch = self._load_npy(raw)
        if batch.ndim != 4 or batch.shape[-1] != 3 or batch.shape[0] < 1:
            raise ValueError(f"detect_batch takes a non-empty (B, H, W, 3) "
                             f"array, got shape {batch.shape}")
        if batch.shape[0] > MAX_BATCH_ROWS:
            raise ValueError(
                f"detect_batch accepts at most {MAX_BATCH_ROWS} rows per "
                f"request, got {batch.shape[0]} — split the batch "
                f"(PoseClient.detect_batch chunks automatically)")
        return batch

    def _read_frame(self) -> np.ndarray:
        raw = self._read_body()
        if raw[:6] == b"\x93NUMPY":
            frame = self._load_npy(raw)
        elif raw[:3] == b"\xff\xd8\xff" or raw[:8] == b"\x89PNG\r\n\x1a\n":
            # an encoded image: decode server-side to the same BGR (H, W, 3)
            # contract cv2 frames carry — `curl --data-binary @face.jpg`
            # needs no client code at all
            try:
                import cv2
            except ImportError:
                raise _UnsupportedMedia(
                    "server lacks OpenCV for image decoding; send an "
                    "np.save'd frame instead") from None
            frame = cv2.imdecode(np.frombuffer(raw, np.uint8),
                                 cv2.IMREAD_COLOR)
            if frame is None:
                raise ValueError("undecodable JPEG/PNG body")
        else:
            raise ValueError("body is neither a .npy array nor a JPEG/PNG "
                             "image (sniffed by magic bytes)")
        # Shape/dtype errors below this point surface as the batcher's own
        # ValueError (same (H, W, 3) contract) — mapped to 400 by do_POST.
        return frame

    # -- routes ----------------------------------------------------------
    def do_GET(self) -> None:
        srv = self.server
        if self.path == "/v1/health":
            self._reply(200, {"status": "ok"})
        elif self.path == "/v1/stats":
            snap = srv.snapshot()
            stats = {
                "frames_served": snap["frames_served"],
                "dispatches": snap["dispatches"],
                "frames_per_dispatch": round(
                    snap["frames_served"] / max(snap["dispatches"], 1), 2),
                "requests": snap["requests"],
                "errors": snap["errors"],
                "uptime_s": round(snap["uptime_s"], 1),
            }
            shape = srv.batcher.frame_shape
            stats["frame_shape"] = list(shape) if shape else None
            lats = snap["latencies"]
            if lats:  # body-read -> response-ready, over the last window
                stats["latency_ms"] = {
                    "p50": round(_quantile(lats, 0.5) * 1e3, 1),
                    "p99": round(_quantile(lats, 0.99) * 1e3, 1),
                    "window": len(lats),
                }
            self._reply(200, stats)
        elif self.path == "/metrics":
            self._reply_metrics()
        else:
            self._reply(404, {"error": f"unknown route {self.path!r}"})

    def _reply_metrics(self) -> None:
        """Prometheus text exposition (version 0.0.4) of the serving
        counters — a standard scraper monitors the endpoint with no glue."""
        snap = self.server.snapshot()
        lines = [
            "# HELP headpose_frames_served_total Frames answered.",
            "# TYPE headpose_frames_served_total counter",
            f"headpose_frames_served_total {snap['frames_served']}",
            "# HELP headpose_dispatches_total Device dispatches issued.",
            "# TYPE headpose_dispatches_total counter",
            f"headpose_dispatches_total {snap['dispatches']}",
            "# HELP headpose_requests_total HTTP detect requests.",
            "# TYPE headpose_requests_total counter",
            f"headpose_requests_total {snap['requests']}",
            "# HELP headpose_errors_total Failed requests.",
            "# TYPE headpose_errors_total counter",
            f"headpose_errors_total {snap['errors']}",
            "# HELP headpose_uptime_seconds Seconds since serving began.",
            "# TYPE headpose_uptime_seconds gauge",
            f"headpose_uptime_seconds {snap['uptime_s']:.1f}",
        ]
        lats = snap["latencies"]
        if lats:
            lines += [
                "# HELP headpose_request_latency_seconds Request latency "
                "over the last %d requests." % len(lats),
                "# TYPE headpose_request_latency_seconds summary",
                'headpose_request_latency_seconds{quantile="0.5"} '
                f"{_quantile(lats, 0.5):.4f}",
                'headpose_request_latency_seconds{quantile="0.99"} '
                f"{_quantile(lats, 0.99):.4f}",
            ]
        body = ("\n".join(lines) + "\n").encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:
        srv = self.server
        if self.path not in ("/v1/detect", "/v1/detect_batch"):
            # _fail (not _reply): the unread request body must not be parsed
            # as the next request on a kept-alive connection
            self._fail(404, f"unknown route {self.path!r}")
            return
        batch_route = self.path.endswith("_batch")
        with srv.lock:
            srv.requests += 1
        t0 = time.monotonic()
        try:
            if batch_route:
                frames = self._read_batch()
                # submit every row before waiting on any: the in-flight set
                # is what coalesces (a submit-wait loop would dispatch each
                # row alone)
                futs = [srv.batcher.submit(f) for f in frames]
                try:
                    deadline = time.monotonic() + srv.request_timeout
                    ragged = [f.result(max(0.0, deadline - time.monotonic()))
                              for f in futs]
                except BaseException:
                    # nobody will read the remaining rows' results — shed
                    # the not-yet-dispatched ones (the dispatcher honors
                    # cancellation via set_running_or_notify_cancel) instead
                    # of burning device time on abandoned work
                    for f in futs:
                        f.cancel()
                    raise
            else:
                frame = self._read_frame()
                res = srv.batcher.detect(frame, timeout=srv.request_timeout)
        except OverflowError as e:
            self._fail(413, str(e))
            return
        except _UnsupportedMedia as e:
            self._fail(415, str(e))
            return
        except ValueError as e:
            self._fail(400, str(e))
            return
        except RuntimeError as e:          # batcher closed mid-flight, or
            # a RuntimeError of detect (a CUDA fault): 503, as in JAX
            self._fail(503, str(e))
            return
        except futures.TimeoutError:       # Future.result past request_timeout
            # (on 3.10 futures.TimeoutError is NOT the builtin; catching the
            # futures name covers both, since 3.11+ makes them aliases)
            self._fail(504, f"no result within {srv.request_timeout} s")
            return
        except Exception as e:             # any other failure of detect
            self._fail(500, f"{type(e).__name__}: {e}")
            return
        with srv.lock:
            srv.latencies.append(time.monotonic() - t0)
        if batch_route:
            self._reply(200, {"count": len(ragged),
                              "results": [_faces_json(r) for r in ragged]})
        else:
            self._reply(200, _faces_json(res))

    def _fail(self, code: int, msg: str) -> None:
        with self.server.lock:
            self.server.errors += 1
        self._reply(code, {"error": msg}, close=True)


class _Httpd(ThreadingHTTPServer):
    daemon_threads = True       # request threads die with the server
    # Concurrent clients ARE the batching width — never serialize accepts.
    request_queue_size = 128

    batcher: DynamicBatcher
    request_timeout: float
    started: float

    def __init__(self, addr):
        super().__init__(addr, _Handler)
        self.lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        # last-1000 successful request latencies (submit -> result), the
        # stats route's p50/p99 window
        self.latencies = collections.deque(maxlen=1000)

    def snapshot(self) -> dict:
        """One consistent read of every serving counter (shared by /v1/stats
        and /metrics).  frames_served is read BEFORE dispatches — the
        batcher increments dispatches first, so this order can only
        undercount frames/dispatch momentarily, never overshoot the
        coalescing ratio the number exists to report."""
        b = self.batcher
        frames = b.frames_served
        dispatches = b.dispatches
        with self.lock:
            return {
                "frames_served": frames,
                "dispatches": dispatches,
                "requests": self.requests,
                "errors": self.errors,
                "uptime_s": time.monotonic() - self.started,
                "latencies": sorted(self.latencies),
            }


class PoseServer:
    """Detection-as-a-service: an HTTP endpoint over one detector.

    `detector` is anything with `.detect(batch) -> BatchResults` — a
    FaceDetector, or a stub in tests.  Batching knobs are the DynamicBatcher's; requests
    arriving within `max_delay` of each other share one device dispatch.

    frame_shape pins the (H, W) or (H, W, 3) every request must carry;
    other shapes get 400 with the expected shape in the message.  If the
    detector declares its own `frame_shape`, that is the default pin.  With
    neither, the FIRST request decides the shape for the server's lifetime
    (the batcher serves one ladder of batch shapes per frame shape) — fine
    behind trusted clients,
    but pin explicitly on open endpoints: one odd-sized first request
    would otherwise 400 every later client.  `/v1/stats` reports the
    current pin as `frame_shape`.

    port=0 picks a free port (read it back from `.port` — the test/dev
    pattern).  Context-manager friendly; `close()` stops accepting, then
    drains the batcher.
    """

    def __init__(self, detector, host: str = "127.0.0.1", port: int = 0, *,
                 max_batch: int = 128, max_delay: float = 0.005,
                 request_timeout: float = 120.0,
                 frame_shape: tuple | None = None):
        if frame_shape is None:
            frame_shape = getattr(detector, "frame_shape", None)
        self._batcher = DynamicBatcher(detector, max_batch=max_batch,
                                       max_delay=max_delay,
                                       frame_shape=frame_shape)
        try:
            self._httpd = _Httpd((host, port))
        except BaseException:
            self._batcher.close()
            raise
        self._httpd.batcher = self._batcher
        self._httpd.request_timeout = request_timeout
        self._httpd.started = time.monotonic()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="pose-http", daemon=True)
        self._thread.start()

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def batcher(self) -> DynamicBatcher:
        return self._batcher

    def close(self, timeout: float = 120.0) -> bool:
        """Stop accepting connections, then drain in-flight work."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10.0)
        return self._batcher.close(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _build_detector(model_path, **kw):
    """--model value (registry name / native model dir / H5 file / AOT
    artifact dir / None) -> detector.

    `kw` goes to the FaceDetector (precision, head_eval, device, ...); with
    no `device` it serves on the card and raises without one.  An H5 file
    is imported through FaceDetector.from_h5.  An AOT artifact directory
    (tools.aot) is served by an ExportedDetector, with no model code on the
    import path; its serving config is baked into its programs, so a flag
    that would change it is refused."""
    import os

    if (model_path is not None and os.path.isdir(model_path)
            and os.path.exists(os.path.join(model_path, "aot.json"))):
        # fail loudly rather than silently ignore conflicting flags
        baked_ignored = {k: v for k, v in kw.items()
                         if v not in ("highest", "auto", None)}
        if baked_ignored:
            raise ValueError(
                f"{model_path} is an AOT artifact; its serving config is "
                f"baked in — re-export it instead of passing "
                f"{sorted(baked_ignored)} (python -m headpose_tpu_torch."
                "tools.aot)")
        from ..tools.aot import load_exported
        return load_exported(model_path)

    from ..pretrained import flagship_detector, resolve_model_path
    from .detector import FaceDetector

    model_path = resolve_model_path(model_path)
    if model_path is None:
        return flagship_detector(**kw)
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"no model at {model_path!r} (neither a "
                                "path nor a pretrained registry name)")
    if os.path.isdir(model_path):
        return FaceDetector.from_native(model_path, **kw)
    return FaceDetector.from_h5(model_path, **kw)


def main(argv=None) -> None:
    import argparse

    from .fused import PRECISIONS

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default=None,
                   help="H5, native model dir (spec.json + params.npz), AOT "
                        "artifact dir (from tools.aot: serves with no model "
                        "code) or pretrained registry name (e.g. "
                        "unified-best-distilled); default: shipped flagship")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--precision", default="highest", choices=PRECISIONS)
    p.add_argument("--head_eval", default="auto",
                   choices=["auto", "map", "survivors"])
    p.add_argument("--max_batch", type=int, default=128)
    p.add_argument("--max_delay", type=float, default=0.005,
                   help="flush deadline in seconds past the oldest "
                        "queued request")
    p.add_argument("--frame_shape", default=None,
                   help="pin the accepted frame shape, e.g. 480,640 — "
                        "otherwise the first request decides it for the "
                        "server's lifetime")
    args = p.parse_args(argv)
    frame_shape = (tuple(int(d) for d in args.frame_shape.split(","))
                   if args.frame_shape else None)

    detector = _build_detector(args.model, precision=args.precision,
                               head_eval=args.head_eval)
    with PoseServer(detector, host=args.host, port=args.port,
                    max_batch=args.max_batch, max_delay=args.max_delay,
                    frame_shape=frame_shape) as srv:
        print(f"serving on {srv.url}  (POST /v1/detect, GET /v1/health, "
              f"GET /v1/stats; ctrl-c to stop)", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            print("shutting down", flush=True)


if __name__ == "__main__":
    main()
