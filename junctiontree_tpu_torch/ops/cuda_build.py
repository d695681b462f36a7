"""Build and load the package's CUDA kernels.

The sources under ``junctiontree_tpu_torch/csrc/`` are compiled by ``nvcc``
into one shared library with a plain C interface at first use, and loaded
with ``ctypes`` (PyTorch's extension builder needs ``ninja`` and compiles
PyTorch's headers, which takes minutes).  The library lands in
``junctiontree_tpu_torch/_build/`` under a name keyed by a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.

The flags target Hopper (``sm_90a``) and deliberately leave out
``--use_fast_math`` and ``-ftz=true``: the serving program's message floor
``1e-38`` is subnormal in float32, and flushing it to zero would turn
impossible evidence into 0/0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(_PKG, "csrc", "factored_contract.cu")]
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
build_seconds = 0.0  # wall time of the build this process ran (0 if cached)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libjtt_kernels_{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
        capture_output=True, text=True,
    )
    build_seconds = time.perf_counter() - t0
    with open(so[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from source on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.jt_factored_contract.argtypes = [
            p, p, p, p, p, i32, i64, i64, i64, i64, i32, i32, i64, p,
        ]
        lib.jt_factored_contract.restype = i32
        lib.jt_error_string.argtypes = [i32]
        lib.jt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def build_log() -> str:
    """What ``nvcc -Xptxas -v`` reported for the current library (registers,
    shared memory, spills), or "" when it was built by another process."""
    log = library_path()[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()
