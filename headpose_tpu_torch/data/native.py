"""ctypes bindings for the native C++ npz loader.

Port of headpose_tpu/data/native.py with its own copy of the source
(`headpose_tpu_torch/native/npz_loader.cpp`), built by g++ on first use
into `build/headpose_tpu_torch/` (`utils.nativelib`).  `load_npz_native`
reads an archive with np.load's semantics; when the library cannot be
built (no g++ or zlib), `native_available()` is False and `data.datasets`
loads with numpy.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.nativelib import NativeLibrary

__all__ = ["native_available", "load_npz_native", "load_many", "LIBRARY"]


def _configure(lib: ctypes.CDLL) -> None:
    lib.npz_open.restype = ctypes.c_void_p
    lib.npz_open.argtypes = [ctypes.c_char_p]
    lib.npz_num_entries.restype = ctypes.c_int
    lib.npz_num_entries.argtypes = [ctypes.c_void_p]
    lib.npz_entry_name.restype = ctypes.c_char_p
    lib.npz_entry_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.npz_entry_info.restype = ctypes.c_int
    lib.npz_entry_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
    lib.npz_entry_bytes.restype = ctypes.c_long
    lib.npz_entry_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.npz_entry_fortran.restype = ctypes.c_int
    lib.npz_entry_fortran.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.npz_read.restype = ctypes.c_int
    lib.npz_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.npz_close.restype = None
    lib.npz_close.argtypes = [ctypes.c_void_p]


LIBRARY = NativeLibrary(
    "npzloader", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "npz_loader.cpp"),
    flags=("-lz",), configure=_configure)


def native_available() -> bool:
    return LIBRARY.available()


def load_npz_native(path: str) -> dict[str, np.ndarray]:
    """Read an npz archive via the C++ loader → {name: array}, as np.load
    gives it (entry names without their '.npy' suffix)."""
    lib = LIBRARY.load()
    if lib is None:
        raise RuntimeError("native npz loader unavailable (no g++/zlib)")
    handle = lib.npz_open(os.fsencode(path))
    if not handle:
        raise OSError(f"cannot open npz: {path}")
    try:
        out: dict[str, np.ndarray] = {}
        for i in range(lib.npz_num_entries(handle)):
            name = lib.npz_entry_name(handle, i).decode()
            if name.endswith(".npy"):
                name = name[:-4]
            dtype_buf = ctypes.create_string_buffer(16)
            shape = (ctypes.c_long * 16)()
            ndim = ctypes.c_int(16)
            lib.npz_entry_info(handle, i, dtype_buf, shape, ctypes.byref(ndim))
            if ndim.value > 16:
                raise OSError(f"npz entry {name} in {path}: rank "
                              f"{ndim.value} > 16")
            dt = np.dtype(dtype_buf.value.decode())
            order = "F" if lib.npz_entry_fortran(handle, i) else "C"
            arr = np.empty([shape[d] for d in range(ndim.value)], dtype=dt,
                           order=order)
            # npz_read copies entry_bytes into arr's buffer: they must agree
            if lib.npz_entry_bytes(handle, i) != arr.nbytes:
                raise OSError(
                    f"npz entry {name} in {path}: payload size "
                    f"{lib.npz_entry_bytes(handle, i)} != array {arr.nbytes}")
            if lib.npz_read(handle, i,
                            arr.ctypes.data_as(ctypes.c_void_p)) != 0:
                raise OSError(f"native read failed for {name} in {path}")
            out[name] = arr
        return out
    finally:
        lib.npz_close(handle)


def load_many(paths: list[str], max_workers: int = 8
              ) -> dict[str, dict[str, np.ndarray]]:
    """Load several npz files concurrently: ctypes calls release the GIL, so
    the C++ loader reads in real threads."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        results = pool.map(load_npz_native, paths)
    return dict(zip(paths, results))
