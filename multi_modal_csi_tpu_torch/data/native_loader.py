"""ctypes bindings for the C++ CSI window loader (``csrc/csi_loader.cpp``):
the port's counterpart of the JAX package's ``data/native_loader.py``.

``load_csi_windows_native`` gives the windows ``data/csi_io.py::
load_csi_windows`` gives, bit for bit: it parses the ``.npy`` headers in
C++ and preads each window's tail into its left-padded slot of one
zeroed batch buffer across a thread pool. The library is built with g++
at first use into ``kernels/_build/`` by the rule the CUDA kernels follow
(``kernels/build.py``: the file's name hashes the source and the flags, so
a changed source never loads a stale library). Where g++ is missing or
the build fails, the loader says so once on stderr and reads with numpy:
this is host code, and both paths give the same arrays.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "csi_loader.cpp"
# the JAX package's flags less -march=native: a build directory may be
# copied to a host with another CPU, and the hash does not cover the host
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> ctypes.CDLL:
    target = build.hashed_target("csi_loader", [SOURCE], GXX_FLAGS)
    if not target.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        build.compile_library(
            target, lambda out: [gxx, *GXX_FLAGS, str(SOURCE), "-o", out],
            "g++ for csi_loader.cpp")
    lib = ctypes.CDLL(str(target))
    lib.csi_load_batch.restype = ctypes.c_int
    lib.csi_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.csi_probe.restype = ctypes.c_int
    lib.csi_probe.argtypes = [ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int64)]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is None and not _build_failed:
        try:
            _lib = _load()
        except (RuntimeError, OSError) as e:
            _build_failed = True
            first = str(e).splitlines()[0]
            print(f"[native_loader] C++ loader unavailable ({first}); "
                  f"reading windows with numpy", file=sys.stderr)
    return _lib


def native_available() -> bool:
    """Whether the C++ loader is built and loaded (building it if need
    be)."""
    return _get_lib() is not None


def load_csi_windows_native(amp_dir: str, labels: Sequence[str],
                            length: int = 3000,
                            num_threads: int = 8,
                            trailing_shape=(3, 3, 30)) -> np.ndarray:
    """(N, length, *trailing_shape) float32 windows for ``labels``,
    left-padded with zeros, a window longer than ``length`` keeping its
    last ``length`` steps; files whose rows are not ``trailing_shape``'s
    size give (N, length, row size). Raises IOError when a file is
    missing or not a float32 ``.npy``. Without the library, the numpy
    loader's result."""
    lib = _get_lib()
    if lib is None:
        from .csi_io import load_csi_windows
        return load_csi_windows(amp_dir, labels, length, num_threads)

    paths = [os.path.join(amp_dir, f"{label}.npy").encode()
             for label in labels]
    n = len(paths)
    row_floats = int(np.prod(trailing_shape))
    if n:
        rows = ctypes.c_int64()
        rf = ctypes.c_int64()
        if lib.csi_probe(paths[0], ctypes.byref(rows), ctypes.byref(rf)) == 0:
            row_floats = rf.value
    out = np.zeros((n, length, row_floats), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*paths)
    failures = lib.csi_load_batch(
        arr, n, length, row_floats,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if failures:
        raise IOError(f"native loader failed on {failures}/{n} files")
    return (out.reshape(n, length, *trailing_shape)
            if row_floats == int(np.prod(trailing_shape)) else out)
