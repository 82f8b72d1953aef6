"""Build the CUDA sources under ``pangu_tpu_torch/csrc/`` with ``nvcc`` and
load them with ``ctypes``.

Each source is a plain C interface (no PyTorch headers), so a build takes
seconds. The shared library goes to ``build/kernels/`` at the root of the
checkout, named by a hash of the source and the flags, and is built at
first use only. ``nvcc -Xptxas -v`` output (registers, shared memory,
spills) is kept beside it as ``<source>.ptxas.txt``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: seconds spent in nvcc by this process, per source
BUILD_SECONDS: Dict[str, float] = {}


def build_dir() -> str:
    return os.path.join(_REPO_ROOT, "build", "kernels")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content hash) and load it."""
    with _LOCK:
        if source in _LIBS:
            return _LIBS[source]
        src = os.path.join(CSRC, source)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        lib_path = os.path.join(out_dir, f"{os.path.splitext(source)[0]}-{digest}.so")
        if not os.path.exists(lib_path):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src],
                                  capture_output=True, text=True)
            BUILD_SECONDS[source] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
            with open(os.path.join(out_dir, f"{os.path.splitext(source)[0]}.ptxas.txt"), "w") as f:
                f.write(proc.stderr)
            os.replace(tmp, lib_path)
        _LIBS[source] = ctypes.CDLL(lib_path)
        return _LIBS[source]
