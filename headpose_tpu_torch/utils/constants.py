"""Device constants built once and cached by their arguments (the resize
matrices of ops/image.py), and the constants a CUDA graph's capture read.

A captured graph reads a constant by its address and runs no Python when it
is replayed.  Were the cache to evict the constant and the allocator to
reuse its memory, every later replay would read whatever lies there then.
So `kept()` gathers each constant looked up on the calling thread while it
is open, and a capture (runtime/replay.py) holds that list for the graph's
life."""
from __future__ import annotations

import contextlib
import functools
import threading

__all__ = ["device_constant", "kept"]

_open = threading.local()


def device_constant(maxsize: int):
    """`functools.lru_cache(maxsize)` for a function that builds a device
    tensor from hashable arguments; each value it returns is added to the
    list that `kept()` has open on the calling thread."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def lookup(*args):
            value = cached(*args)
            keep = getattr(_open, "keep", None)
            if keep is not None:
                keep.append(value)
            return value

        lookup.cache_info = cached.cache_info
        return lookup
    return wrap


@contextlib.contextmanager
def kept():
    """A list of every device constant looked up on this thread until the
    block ends."""
    outer = getattr(_open, "keep", None)
    _open.keep = keep = []
    try:
        yield keep
    finally:
        _open.keep = outer
