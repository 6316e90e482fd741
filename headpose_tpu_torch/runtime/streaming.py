"""Streaming detection: overlap host→device transfer with device compute.

Port of headpose_tpu/runtime/streaming.py.  `detect` returns before the card
has finished, so the upload of batch k+1 can run while batch k computes.
On a CUDA detector each batch is staged through pinned host memory and
copied with `non_blocking=True` on a side stream; an event makes the compute
stream wait for that copy before the batch's detect, so a host-fed stream
(video decoder, RPC queue) keeps the card busy instead of serialising
transfer → compute → transfer.  Each batch's download to the host is started
as soon as its detect is queued (`BatchResults.start_download`, on a second
side stream, so an upload and a download never queue behind each other):
the copy runs beside the next batch's kernels, and the yielded batch's
`trim()` waits for its own copy alone, not for the next batch.  On the CPU
it is a plain loop.  The spans `stream.stage` (a batch's pinning and copy
issued), `results.download` (its download issued) and `stream.copy_wait`
(the host waiting for an upload) mark the card's path.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import torch

from ..utils.profiling import span
from .detector import host_tensor
from .results import BatchResults

__all__ = ["detect_stream"]


def detect_stream(detector, batches: Iterable,
                  prefetch: int = 2) -> Iterator[BatchResults]:
    """Yield BatchResults for an iterable of (B, H, W, 3) frame batches.

    Batches are staged onto the device `prefetch` ahead of the compute that
    consumes them, at most `prefetch` detects are in flight, and results are
    yielded in order.  All batches should share one shape (one set of
    cuDNN algorithm choices)."""
    depth = max(prefetch, 1)
    device = detector.device
    if device.type != "cuda":
        for batch in batches:
            yield detector.detect(batch)
        return

    copy_stream = torch.cuda.Stream(device)
    download_stream = torch.cuda.Stream(device)
    compute_stream = torch.cuda.current_stream(device)
    staged: deque = deque()
    it = iter(batches)

    def stage_next() -> bool:
        try:
            batch = next(it)
        except StopIteration:
            return False
        with span("stream.stage"):
            host = host_tensor(batch).pin_memory()
            with torch.cuda.stream(copy_stream):
                dev = host.to(device, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(copy_stream)
        staged.append((dev, copied, host))
        return True

    for _ in range(depth):
        if not stage_next():
            break

    pending: deque = deque()
    while staged or pending:
        # keep at most `depth` dispatches in flight, then yield the oldest —
        # bounded memory and incremental results even for unbounded streams
        while staged and len(pending) < depth:
            dev, copied, host = staged.popleft()
            compute_stream.wait_event(copied)
            # the staged tensor was allocated on the copy stream and is used
            # on the compute stream: keep its memory from being reused
            # before the compute stream is done with it
            dev.record_stream(compute_stream)
            result = detector.detect(dev)
            with span("results.download"):
                result.start_download(download_stream)
            pending.append((result, copied, host))
            stage_next()
        result, copied, host = pending.popleft()
        # the pinned source must outlive its copy: wait for the copy (not
        # the compute) before the last reference to it goes
        with span("stream.copy_wait"):
            copied.synchronize()
        del host
        yield result
