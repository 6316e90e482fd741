"""Dynamic-batching serving front end: many clients, one wide dispatch.

Port of headpose_tpu/runtime/server.py.  A production deployment serves many
independent request streams, each submitting single frames, while the card
earns its keep on wide batches.  `DynamicBatcher` coalesces concurrent
single-frame requests into batched `FaceDetector.detect` dispatches:

  * requests queue up; a dispatcher thread drains them into one batch of at
    most `max_batch`, waiting at most `max_delay` seconds past the OLDEST
    queued request before flushing (bounded added latency);
  * the batch is padded up to a fixed LADDER of widths (doublings of the
    detector's batch granularity up to `max_batch`, itself rounded up to a
    granularity multiple — see `__init__`), so the card sees a few batch
    shapes (cuDNN picks its algorithms per shape) instead of one per
    request count;
  * results come back per request as host-side ragged `Results` via the
    single synchronising device→host copy of `BatchResults.trim`.

The dispatcher thread is the one that launches the kernels: `detect` enqueues
the work on the card and returns without synchronising, and `trim()`, in the
same thread, is the one copy that waits for it.  Pure host-side
orchestration around the detector — no device code of its own.

Over a mesh detector of more than one rank (`FaceDetector(mesh=...)`, whose
`detect` is a collective), rank 0 owns the front end: before each `detect`
its dispatcher broadcasts the padded batch's shape and frames to the other
ranks, which run `follow(detector)` — receive a batch, `detect`, repeat —
until closing the batcher broadcasts the stop message.  This is the SPMD
form of JAX's single-process mesh serving.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from .results import Results

__all__ = ["DynamicBatcher", "follow"]

# frame dtypes a batch broadcast carries, by code
_DTYPES = (torch.uint8, torch.float32, torch.float64, torch.float16,
           torch.int32, torch.int64)


def _spmd_mesh(detector):
    """The detector's mesh where its `detect` is a collective of more than
    one rank, else None."""
    mesh = getattr(detector, "mesh", None)
    return mesh if mesh is not None and mesh.size() > 1 else None


def _transport(detector) -> torch.device:
    """Where a broadcast batch lives: the CPU under gloo, the detector's
    card under NCCL (which takes CUDA tensors only)."""
    import torch.distributed as dist

    return (torch.device("cpu") if dist.get_backend() == "gloo"
            else detector.device)


def _send(detector, batch: np.ndarray | None) -> None:
    """Rank 0: the header (1 and the batch's shape and dtype, or 0 to
    stop), then the frames, to every rank."""
    from ..parallel.distributed import broadcast_

    device = _transport(detector)
    header = torch.zeros(6, dtype=torch.int64)
    if batch is not None:
        frames = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
        header[0] = 1
        header[1:5] = torch.tensor(frames.shape)
        header[5] = _DTYPES.index(frames.dtype)
    broadcast_(header.to(device))
    if batch is not None:
        broadcast_(frames)


def follow(detector) -> int:
    """The loop of a rank other than 0 behind rank 0's DynamicBatcher over
    the mesh detector `detector`: receive each batch, run the collective
    `detect` on it, until the batcher closes.  Returns the batches
    served."""
    from ..parallel.distributed import broadcast_

    if _spmd_mesh(detector) is None:
        raise ValueError("follow() serves a mesh detector of more than one "
                         "rank")
    device = _transport(detector)
    served = 0
    while True:
        header = broadcast_(torch.zeros(6, dtype=torch.int64,
                                        device=device)).cpu()
        if int(header[0]) == 0:
            return served
        frames = torch.empty(tuple(int(d) for d in header[1:5]),
                             dtype=_DTYPES[int(header[5])], device=device)
        detector.detect(broadcast_(frames))
        served += 1


class DynamicBatcher:
    """Batch concurrent detect requests onto one detector.

    `detector` is anything with `.detect(batch) -> BatchResults` — a
    FaceDetector, or a stub in tests.

    All submitted frames must share one (H, W, 3) shape (one ladder of batch
    shapes; run one batcher per frame size).

    max_delay is the flush deadline measured from the OLDEST queued request:
    the latency a lone request pays on an idle server is ~max_delay + one
    dispatch; under load batches fill to max_batch sooner and flush early.
    """

    def __init__(self, detector, max_batch: int = 128,
                 max_delay: float = 0.002,
                 frame_shape: tuple | None = None):
        """frame_shape: optionally pin the (H, W) or (H, W, 3) every frame
        must have, up front.  Left None, the FIRST submission pins it —
        fine for a trusted in-process caller, but a network front end
        should pin explicitly (one odd-sized first request would otherwise
        decide the shape every later client must match)."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.detector = detector
        self.max_batch = max_batch
        self.max_delay = max_delay
        # pad ladder: powers of two up to max_batch (plus max_batch itself),
        # scaled by the detector's batch granularity — a detector that only
        # serves batches divisible by g starts the ladder there (e.g.
        # granularity 8: 8, 16, 32, ...) and max_batch rounds UP to the next
        # servable width
        self._spmd = _spmd_mesh(detector) is not None
        if self._spmd:
            import torch.distributed as dist

            if dist.get_rank() != 0:
                raise RuntimeError(
                    "a DynamicBatcher over a mesh detector runs on rank 0; "
                    "the other ranks run runtime.server.follow(detector)")
            if detector.mesh.size() != dist.get_world_size():
                raise ValueError("a DynamicBatcher's mesh detector must "
                                 "span every rank of the process group")
        g = max(1, int(getattr(detector, "batch_granularity", 1)))
        self.max_batch = max_batch = -(-max_batch // g) * g
        widths = []
        w = g
        while w < max_batch:
            widths.append(w)
            w *= 2
        widths.append(max_batch)
        self.widths = tuple(widths)
        self.dispatches = 0          # batches sent to the device
        self.frames_served = 0       # real (unpadded) frames in them
        # seconds from submit to dispatch of the last 1000 dispatched
        # requests (`queue_waits()`)
        self._waits: collections.deque = collections.deque(maxlen=1000)
        self._waits_lock = threading.Lock()
        if frame_shape is not None:
            frame_shape = tuple(int(d) for d in frame_shape)
            if len(frame_shape) == 2:
                frame_shape += (3,)
            if len(frame_shape) != 3 or frame_shape[-1] != 3:
                raise ValueError(f"frame_shape must be (H, W) or (H, W, 3), "
                                 f"got {frame_shape}")
        self._frame_shape = frame_shape
        self._shape_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="DynamicBatcher")
        self._thread.start()

    # ------------------------------------------------------------- client API
    @property
    def frame_shape(self) -> tuple | None:
        """The (H, W, 3) this batcher serves — None until the first submit
        pins it (or a `frame_shape` constructor pin)."""
        with self._shape_lock:
            return self._frame_shape

    def submit(self, frame) -> Future:
        """Enqueue one (H, W, 3) frame; resolves to a ragged `Results`."""
        if self._closed.is_set():
            raise RuntimeError("DynamicBatcher is closed")
        frame = np.asarray(frame)
        if (frame.ndim != 3 or frame.shape[-1] != 3
                or min(frame.shape[:2]) < 1):
            # the zero-dim check matters: an empty (0, 0, 3) frame would
            # pass the structural check, PIN the batcher's shape, and then
            # fail every dispatch (resize from nothing)
            raise ValueError(f"submit takes one non-empty (H, W, 3) frame, "
                             f"got shape {frame.shape}")
        # lock the check-then-set: two first submissions racing with
        # different shapes would otherwise both pass and poison the batch
        with self._shape_lock:
            if self._frame_shape is None:
                self._frame_shape = frame.shape
            elif frame.shape != self._frame_shape:
                raise ValueError(
                    f"all frames must share one shape per batcher "
                    f"(got {frame.shape}, serving {self._frame_shape}) — "
                    "run one DynamicBatcher per frame size")
        fut: Future = Future()
        self._q.put((frame, fut, time.monotonic()))
        return fut

    def detect(self, frame, timeout: float | None = None) -> Results:
        """Synchronous convenience: submit + wait."""
        return self.submit(frame).result(timeout)

    def queue_waits(self) -> list[float]:
        """Seconds each of the last 1000 dispatched requests waited in the
        queue, from its submit to its batch's dispatch, sorted."""
        with self._waits_lock:
            return sorted(self._waits)

    def close(self, timeout: float = 120.0) -> bool:
        """Flush queued work and stop the dispatcher thread (over a mesh
        detector, then stop the followers).

        Returns True if the dispatcher fully drained and exited within
        `timeout` (size it to cover a first dispatch, which may build a
        kernel); False if it is still flushing (daemon thread keeps
        running).  Requests enqueued by a submit() racing with close() are
        resolved with a RuntimeError rather than left hanging."""
        self._closed.set()
        self._thread.join(timeout)
        drained = not self._thread.is_alive()
        if drained and self._spmd:
            self._spmd = False            # the followers stop, once
            _send(self.detector, None)
        if drained:
            while True:  # a submit that raced past the dispatcher's exit
                try:
                    _, fut, _ = self._q.get_nowait()
                except queue.Empty:
                    break
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(RuntimeError(
                        "DynamicBatcher closed before this request was "
                        "dispatched (submit raced with close)"))
        return drained

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- dispatcher
    def _take_batch(self):
        """Block for the first request, then drain until max_batch or the
        oldest request's deadline passes."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        items = [first]
        deadline = first[2] + self.max_delay
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                if remaining <= 0:
                    items.append(self._q.get_nowait())
                else:
                    items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _loop(self) -> None:
        while not (self._closed.is_set() and self._q.empty()):
            items = self._take_batch()
            # claim the futures: a client-cancelled future must neither be
            # dispatched nor set_result (InvalidStateError would kill this
            # thread and hang every other client)
            live = [(f, fut, t) for f, fut, t in items
                    if fut.set_running_or_notify_cancel()]
            if not live:
                continue
            frames = [f for f, _, _ in live]
            futs = [fut for _, fut, _ in live]
            n = len(frames)
            now = time.monotonic()
            with self._waits_lock:
                self._waits.extend(now - t for _, _, t in live)
            try:  # EVERYTHING here resolves the waiters on failure — an
                # uncaught exception would end the dispatcher and hang all
                # pending and future requests
                width = next(w for w in self.widths if w >= n)
                batch = np.stack(frames + [frames[0]] * (width - n))
                if self._spmd:            # the followers' detect, the same
                    _send(self.detector, batch)
                # pad by repeating the first frame: rows are independent
                # through the whole pipeline (convs, per-image NMS), so pad
                # content only costs compute, never correctness.  detect
                # launches the kernels without waiting; trim() is the one
                # synchronising copy
                ragged = self.detector.detect(batch).trim()
            except Exception as e:
                for fut in futs:
                    fut.set_exception(e)
                continue
            self.dispatches += 1
            self.frames_served += n
            for fut, res in zip(futs, ragged[:n]):
                fut.set_result(res)
