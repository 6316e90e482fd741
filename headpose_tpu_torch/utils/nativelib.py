"""Build-on-first-use of the port's C++ host libraries.

A library is compiled by `g++` from one source under
`headpose_tpu_torch/native/` into `build/headpose_tpu_torch/` beside the
package, named by a hash of its source and flags (an edited source or flag
rebuilds it, an unchanged one is reused), and loaded with `ctypes`.
Nothing is built at import time.  Failure is soft: without a compiler (or
a library it links, e.g. zlib) `load()` returns None and the caller falls
back, as the JAX package's native components do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable

from .build import BUILD_DIR

__all__ = ["NativeLibrary"]


class NativeLibrary:
    """A shared library built from one C++ source on first `load()`.

    `configure(lib)` runs once after loading to declare argtypes/restype;
    `flags` are extra g++ arguments (e.g. the libraries it links)."""

    def __init__(self, name: str, src: str, *, flags: tuple[str, ...] = (),
                 configure: Callable[[ctypes.CDLL], None] | None = None):
        self.name = name
        self.src = os.path.abspath(src)
        self.flags = ("-O3", "-shared", "-fPIC", *flags)
        self._configure = configure
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._failed = False
        self.build_log = ""   # g++'s output of a build this process ran

    def path(self) -> str:
        h = hashlib.sha256(" ".join(self.flags).encode())
        with open(self.src, "rb") as f:
            h.update(f.read())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def _build(self, path: str) -> bool:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        # the flags that name libraries go after the source, for the linker
        libs = [f for f in self.flags if f.startswith("-l")]
        opts = [f for f in self.flags if not f.startswith("-l")]
        try:
            proc = subprocess.run(["g++", *opts, "-o", tmp, self.src, *libs],
                                  capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            self.build_log = str(e)
            return False
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            return False
        os.replace(tmp, path)   # atomic: a concurrent build never sees half a file
        return True

    def load(self) -> ctypes.CDLL | None:
        """The loaded library, or None when it cannot be built or loaded."""
        with self._lock:
            if self._lib is None and not self._failed:
                path = self.path()
                try:
                    if not os.path.exists(path) and not self._build(path):
                        raise OSError(f"g++ failed to build {self.name}")
                    lib = ctypes.CDLL(path)
                except OSError:
                    self._failed = True
                    return None
                if self._configure is not None:
                    self._configure(lib)
                self._lib = lib
            return self._lib

    def available(self) -> bool:
        return self.load() is not None
