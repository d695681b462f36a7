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
            p, p, p, p, p, p, i32, i32, i64, i64, i64, i64,
            i32, i32, i32, i32, i32, i32, i32, i64, i64, p, p,
        ]
        lib.jt_factored_contract.restype = i32
        lib.jt_factored_contract_fma.argtypes = [
            p, p, p, p, p, p, i64, i64, i64, i64, i32, i32, i32, i64, i32, i32,
            p,
        ]
        lib.jt_factored_contract_fma.restype = i32
        lib.jt_split_pot.argtypes = [
            p, p, p, i32, i32, i64, i64, i64, i64, i64, i64, i64, i32, p,
        ]
        lib.jt_split_pot.restype = i32
        lib.jt_error_string.argtypes = [i32]
        lib.jt_error_string.restype = ctypes.c_char_p
        lib.jt_max_clusters.argtypes = [i32, i32, i32, i32]
        lib.jt_max_clusters.restype = i32
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


SASS_OPS = ("HMMA", "HGMMA", "IMMA", "DMMA", "QGMMA", "UTMALDG")
# the tensor-core kernel's template arguments, as mangled: its operands'
# source (bf16; f32 in six passes, "highest"; f32 in one, "default") and
# its epilogue
SRC_KINDS = (("SrcE0E", "bf16"), ("SrcE1E", "f32"), ("SrcE2E", "f32_default"))
EPI_KINDS = (("EpiE0E", "_by_c"), ("EpiE1E", "_fold"), ("EpiE2E", "_smem"),
             ("EpiE3E", "_fold_pairs"))
TENSOR_CORE_OPS = SASS_OPS[:5]


def sass_op_counts() -> dict:
    """Instructions of ``SASS_OPS`` (tensor-core products and ``UTMALDG``,
    the Tensor Memory Accelerator's load) in each compiled kernel of the
    current library, counted in ``cuobjdump -sass`` and keyed by source and
    epilogue of the tensor-core kernel (``bf16_by_c``, ``bf16_fold``,
    ``bf16_smem``, ``f32_*``, ``f32_default_*``), ``f32_narrow`` (the
    CUDA-core kernel of narrow float32 products), ``split`` (the float32
    potential's split into bf16 planes) and ``other`` (any other kernel:
    none since the contraction kernels add their own partials):
    ``{kind: {op: count}}``, summed over the kernels of a kind.  {} where
    the toolkit has no cuobjdump."""
    nvcc = _nvcc()
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run(
        [tool, "-sass", library_path()], capture_output=True, text=True,
        check=True,
    ).stdout
    counts: dict = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if "factored_contract_tc_kernel" in name:  # template <BN, Epi, Src>
            kind = (next(k for m, k in SRC_KINDS if m in name)
                    + next(k for m, k in EPI_KINDS if m in name))
        elif "factored_contract_fma_kernel" in name:
            kind = "f32_narrow"
        elif "split_pot_kernel" in name:
            kind = "split"
        else:
            kind = "other"
        mine = counts.setdefault(kind, dict.fromkeys(SASS_OPS, 0))
        for op in SASS_OPS:
            mine[op] += chunk.count(op)
    return counts


def tensor_core_op_counts() -> dict:
    """Tensor-core operations (``HMMA``, ``HGMMA``, ...) in each kind of
    kernel of :func:`sass_op_counts`."""
    return {kind: sum(ops[op] for op in TENSOR_CORE_OPS)
            for kind, ops in sass_op_counts().items()}
