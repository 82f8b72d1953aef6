"""Build the CUDA sources under ``pangu_tpu_torch/csrc/`` with ``nvcc`` and
load them with ``ctypes``.

Each source is a plain C interface (no PyTorch headers), so a build takes
seconds. The shared library goes to ``build/kernels/`` at the root of the
checkout, named by a hash of the source, the headers of ``csrc/`` and the
flags, and is built at first use only; ``build_all`` starts one nvcc per
source at once. ``nvcc -Xptxas -v`` output (registers, shared memory,
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
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
#: every kernel source of the port, one shared library each
SOURCES = ("fused_earth_block.cu", "block_attention.cu", "fused_epilogue.cu", "fused_mlp.cu",
           "fused_block_train.cu", "bench_mxu_micro.cu", "bench_attn_fwd_ab.cu",
           "bench_attn_bwd_ab.cu", "cosine_window_attention.cu", "outer_dense.cu")

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


def _lib_path(source: str) -> str:
    """Where ``csrc/<source>`` is built: named by a hash of it, every header
    of ``csrc/`` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [source] + sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(build_dir(), f"{os.path.splitext(source)[0]}-{h.hexdigest()[:16]}.so")


def _compile(sources: Sequence[str]) -> None:
    """Run one nvcc per source that is not built yet, all at once."""
    os.makedirs(build_dir(), exist_ok=True)
    procs = []
    for source in sources:
        lib_path = _lib_path(source)
        if os.path.exists(lib_path):
            continue
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, source)]
        procs.append((source, lib_path, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)))
    failed = []
    for source, lib_path, tmp, t0, proc in procs:
        out, err = proc.communicate()
        BUILD_SECONDS[source] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source}:\n{out}\n{err}")
            continue
        with open(os.path.join(build_dir(), f"{os.path.splitext(source)[0]}.ptxas.txt"), "w") as f:
            f.write(err)
        os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all(sources: Sequence[str] = SOURCES) -> None:
    """Compile the sources (default: every kernel source) in parallel and
    load them."""
    with _LOCK:
        _compile([s for s in sources if s not in _LIBS])
    for source in sources:
        load_library(source)


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content hash) and load it."""
    with _LOCK:
        if source not in _LIBS:
            _compile([source])
            _LIBS[source] = ctypes.CDLL(_lib_path(source))
        return _LIBS[source]
