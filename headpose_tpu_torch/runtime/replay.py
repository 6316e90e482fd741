"""`detect`'s device pipeline replayed as captured CUDA graphs.

On one CUDA device `FaceDetector._detect` hands each batch to
`PipelineGraphs`, which keys the call by everything a capture bakes in
(`graph_key`: the input's shape, dtype and device, every detector attribute
that `_pipeline` reads, the TF32 switches) and checks the weights' stamp
(`utils.weights.stamp`, taken once a call):

  first call at a key   eager: `_pipeline` op by op, the warm-up (nvcc and
                        dlopen, the weight packs, shared-memory limits, the
                        calling thread's cuBLAS and cuDNN handles);
  second call           captures `_pipeline` from a static input into a
                        static slab on a side stream, then replays once to
                        answer its own batch (on another thread than the
                        first call's it runs eager once more instead: a
                        capture cannot create a thread's handles);
  every later call      copies the batch into the static input on the
                        current stream, replays, and clones the static slab.

The clone gives each batch a slab of its own: `detect_stream` keeps two
batches in flight and downloads each on a side stream while the next replay
writes the static slab again.  A graph reads by address what it did not
allocate, so it must outlive none of it: the weight packs are rebuilt when
the weights change, and a stamp that differs from the capture's drops the
graph (the call is eager again, on the new weights); the key holds the
detector's network, model and anchor table, so none of them is freed while
a graph may read it; the graph holds the cached device constants its
capture looked up (`utils.constants.kept`: the resize matrices), which
their caches may evict.  A key whose capture raises runs eager while the
cache holds it.  At most `GRAPHS` keys are kept, the least recently used
dropped first: the serve path's pad ladder at its default `max_batch` of
128 has 8 widths.  Calls hold a lock, since a graph's static input and slab
serve one batch at a time.

A replay adds the launches its capture counted to `ops.kernels.library`'s
counts, so `launches()` advances as on an eager call.  `TOTALS.counts`
counts "detect.eager", "detect.capture", "detect.capture_failed" and
"detect.replay"; the span `detect.replay` holds the copy, the replay and
the clone, and `detect.capture` the capture.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import warnings
from typing import Callable

import torch

from ..ops.kernels import library
from ..utils.constants import kept
from ..utils.profiling import TOTALS, span

__all__ = ["GRAPHS", "OPTIONS", "graph_key", "PipelineGraphs"]

GRAPHS = 8
# every attribute of the detector that `_pipeline` reads, in it or in the
# methods it calls (tests/test_torch_replay.py walks their source for them)
OPTIONS = ("precision", "head_eval", "channel_order", "turbo_island",
           "score_threshold", "iou_threshold", "max_faces", "postprocess",
           "input_size", "model", "net", "anchors")
_VALUES = (str, int, float, tuple, type(None))


class _Same:
    """An object in a key, equal only to itself; the key keeps it alive."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __eq__(self, other):
        return isinstance(other, _Same) and other.obj is self.obj

    def __hash__(self):
        return id(self.obj)


def graph_key(detector, x: torch.Tensor, fused: bool | None) -> tuple:
    """What a capture of `detector._pipeline(x, fused)` bakes in beside the
    weights' values: x's shape, dtype and device, `fused`, the `OPTIONS`
    (strings, numbers and tuples by value, the model, the network and the
    anchor table by identity), and whether cuBLAS and cuDNN may use
    TF32."""
    options = [getattr(detector, name) for name in OPTIONS]
    return (tuple(x.shape), x.dtype, x.device, fused,
            *[v if isinstance(v, _VALUES) else _Same(v) for v in options],
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@dataclasses.dataclass(eq=False)
class _Graph:
    weights: tuple                          # the stamp it was seen with
    thread: int                             # that ran it eager
    graph: torch.cuda.CUDAGraph | None = None   # None: seen once, eager
    failed: bool = False                    # its capture raised: eager
    static_in: torch.Tensor | None = None
    static_out: torch.Tensor | None = None
    constants: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
    stream: torch.cuda.Stream | None = None     # of the last replay


class PipelineGraphs:
    """The captured graphs of one detector, by `graph_key`."""

    def __init__(self):
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._stream: torch.cuda.Stream | None = None
        self._lock = threading.Lock()

    def __call__(self, pipeline: Callable[[torch.Tensor], torch.Tensor],
                 x: torch.Tensor, key: tuple, weights: tuple) -> torch.Tensor:
        """pipeline(x), a fresh (B, F, 21) slab: eager, captured or
        replayed as the key's calls so far decide."""
        with self._lock:
            return self._run(pipeline, x, key, weights)

    def _run(self, pipeline, x, key, weights):
        entry = self._graphs.get(key)
        thread = threading.get_ident()
        if entry is None or (entry.weights != weights and not entry.failed):
            self._graphs[key] = _Graph(weights, thread)
            self._graphs.move_to_end(key)
            while len(self._graphs) > GRAPHS:
                self._graphs.popitem(last=False)
            return _eager(pipeline, x)
        self._graphs.move_to_end(key)
        if entry.failed:
            return _eager(pipeline, x)
        if entry.graph is None and entry.thread != thread:
            entry.thread = thread
            return _eager(pipeline, x)
        with torch.cuda.device(x.device):
            if entry.graph is None:
                return self._capture(entry, pipeline, x)
            with span("detect.replay"):
                TOTALS.count("detect.replay")
                library.add_launches(entry.launches)
                return _replay(entry, x)

    def _capture(self, entry: _Graph, pipeline, x):
        """Capture pipeline(static input) on a side stream, then replay it
        once on the current stream; a capture that raises marks the entry
        failed, and its launches are not counted."""
        with span("detect.capture"):
            if self._stream is None:
                self._stream = torch.cuda.Stream(x.device)
            static_in = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            graph = torch.cuda.CUDAGraph()
            before = library.launches()
            try:
                with torch.cuda.stream(self._stream), kept() as constants:
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        static_out = pipeline(static_in)
                    finally:
                        graph.capture_end()
            except Exception as err:        # the eager path still serves
                _end_generator_capture(x.device)
                library.LAUNCHES.update(before)
                entry.failed = True
                TOTALS.count("detect.capture_failed")
                warnings.warn(f"detect: no CUDA graph of this call could be "
                              f"captured ({err!r}); its key runs eager",
                              RuntimeWarning, stacklevel=4)
                return _eager(pipeline, x)
            TOTALS.count("detect.capture")
            after = library.launches()
            entry.launches = {k: after[k] - n for k, n in before.items()
                              if after[k] != n}
            entry.graph, entry.static_in, entry.static_out = (
                graph, static_in, static_out)
            entry.constants = constants
            return _replay(entry, x)


def _end_generator_capture(device: torch.device) -> None:
    """A capture that raised leaves the device's CUDA random generator in
    capture mode (PyTorch ends that mode only when `capture_end` succeeds),
    and every later random draw on the device then raises; one capture of
    a single kernel, on a fresh stream, ends it."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream(device)):
        graph.capture_begin(capture_error_mode="thread_local")
        torch.zeros(1, device=device)
        graph.capture_end()


def _eager(pipeline, x: torch.Tensor) -> torch.Tensor:
    TOTALS.count("detect.eager")
    return pipeline(x)


def _replay(entry: _Graph, x: torch.Tensor) -> torch.Tensor:
    """x into the static input, the graph, and a clone of the static slab,
    all on the current stream; a stream other than the last replay's first
    waits for that one, whose clone may still read the static slab."""
    stream = torch.cuda.current_stream(x.device)
    if entry.stream is not None and entry.stream != stream:
        stream.wait_stream(entry.stream)
    entry.stream = stream
    entry.static_in.copy_(x)
    entry.graph.replay()
    return entry.static_out.clone()
