"""Build-on-first-use of the port's CUDA sources.

Each library is compiled by `nvcc` from `headpose_tpu_torch/csrc/*.cu` into a
shared library with a plain C interface and loaded with `ctypes` (no PyTorch
headers, so a build takes seconds).  The library lands in
`build/headpose_tpu_torch/` beside the package, named by a hash of its
sources and flags: editing a source or a flag rebuilds it, and an unchanged
one is reused.  Nothing is built at import time; a failed build raises with
nvcc's output.  Each build is timed as the section `kernels.build`, each
load (dlopen and configure) as `kernels.load` (utils.profiling.TOTALS).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Sequence

from .profiling import section

__all__ = ["CudaLibrary", "BUILD_DIR", "NVCC_FLAGS", "NVCC_FLAGS_FMA"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "headpose_tpu_torch")

# sm_90a: Hopper.  --fmad=false and no --use_fast_math keep the float
# arithmetic identical to the plain PyTorch twins (see csrc/postprocess.cu).
# -Xptxas -v reports registers and shared memory into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# For kernels held to their plain versions within a tolerance, not bit for
# bit: the same flags with FMA contraction allowed.  Still no
# --use_fast_math, so division stays IEEE and tanhf, expf, erff, log1pf are
# libdevice's accurate functions.
NVCC_FLAGS_FMA = tuple(f for f in NVCC_FLAGS if f != "--fmad=false")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = candidate if os.path.isfile(candidate) else None
    if found is None:
        raise RuntimeError("nvcc not found (searched PATH and CUDA_HOME); the "
                           "port's CUDA kernels are built with it on first use")
    return found


class CudaLibrary:
    """A shared library built from CUDA sources on first `load()`.

    `configure(lib)` runs once after loading to declare argtypes/restype;
    `flags` are nvcc's flags for this library (they key its hash)."""

    def __init__(self, name: str, sources: Sequence[str],
                 configure: Callable[[ctypes.CDLL], None],
                 flags: Sequence[str] = NVCC_FLAGS):
        self.name = name
        self.sources = tuple(os.path.abspath(s) for s in sources)
        self.flags = tuple(flags)
        self._configure = configure
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.build_log = ""   # nvcc's output of the build this process ran

    def path(self) -> str:
        h = hashlib.sha256(" ".join(self.flags).encode())
        for src in self.sources:
            with open(src, "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def _build(self, path: str) -> None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with section("kernels.build"):
            proc = subprocess.run([_nvcc(), *self.flags, "-o", tmp,
                                   *self.sources],
                                  capture_output=True, text=True, timeout=600)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.name} "
                               f"(exit {proc.returncode}):\n{self.build_log}")
        os.replace(tmp, path)   # atomic: a concurrent build never sees half a file

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path = self.path()
                if not os.path.exists(path):
                    self._build(path)
                with section("kernels.load"):
                    lib = ctypes.CDLL(path)
                    self._configure(lib)
                self._lib = lib
            return self._lib
