"""ctypes bindings for the native C++ batch loader
(``pangu_tpu_torch/csrc/fastloader.cpp``; port of
``pangu_tpu/data/native_loader.py``, the same code but for the paths).

Builds the shared library on first use (g++ -O3) into
``build/native/libfastloader.so`` of the checkout (gitignored, beside the
CUDA kernels' ``build/kernels/``) and exposes:

  * read_npy(path, out) — single-file read into a preallocated buffer
  * read_batch(paths, out2d, threads) — thread-pooled batch read/pack

Everything degrades to numpy when no compiler is available —
``native_available()`` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "pangu_tpu_torch", "csrc", "fastloader.cpp")
_LIB_DIR = os.path.join(_REPO_ROOT, "build", "native")
_LIB = os.path.join(_LIB_DIR, "libfastloader.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_ERRORS = {
    -1: "cannot open file", -2: "bad npy magic", -3: "bad npy header",
    -4: "unsupported dtype (need <f4/<f8)", -5: "fortran order unsupported",
    -6: "buffer too small", -7: "truncated file",
}


def _build() -> bool:
    os.makedirs(_LIB_DIR, exist_ok=True)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", _LIB]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        stale = (os.path.exists(_LIB) and os.path.exists(_SRC)
                 and os.path.getmtime(_SRC) > os.path.getmtime(_LIB))
        if stale and not _build():
            return None  # source changed but can't rebuild: don't run old .so
        if not os.path.exists(_LIB) and not (os.path.exists(_SRC) and _build()):
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.fl_read_npy.restype = ctypes.c_int64
        lib.fl_read_npy.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.fl_read_batch.restype = ctypes.c_int32
        lib.fl_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def read_npy(path: str, out: np.ndarray) -> int:
    """Read one .npy into a preallocated float32 C-contiguous buffer.
    Returns elements read; raises on error; numpy fallback if no library."""
    lib = _load()
    if lib is None:
        arr = np.load(path)
        flat = np.ascontiguousarray(arr, dtype=np.float32).ravel()
        out.ravel()[: flat.size] = flat
        return flat.size
    assert out.dtype == np.float32 and out.flags.c_contiguous
    rc = lib.fl_read_npy(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size,
    )
    if rc < 0:
        raise IOError(f"fastloader: {_ERRORS.get(rc, rc)}: {path}")
    return int(rc)


def read_batch(paths: Sequence[str], out: np.ndarray, threads: int = 8) -> None:
    """Read len(paths) equally-shaped .npy files into out[i] slots in
    parallel. out: (n, ...) float32 C-contiguous."""
    n = len(paths)
    assert out.shape[0] == n and out.dtype == np.float32 and out.flags.c_contiguous
    per = int(np.prod(out.shape[1:]))
    lib = _load()
    if lib is None:
        for i, p in enumerate(paths):
            out[i] = np.load(p).astype(np.float32, copy=False).reshape(out.shape[1:])
        return
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.fl_read_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), per, threads
    )
    if rc != 0:
        idx = -rc - 1
        raise IOError(
            f"fastloader: failed reading {paths[idx]} "
            f"(unreadable, or element count != expected {per})")
