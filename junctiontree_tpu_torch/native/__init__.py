"""Native (C++) host compiler: min-fill triangulation and the junction-tree
build of ``triangulate.py`` / ``treebuild.py`` in C++ (counterpart of
``junctiontree_tpu/native``).

``jt_compile.cpp`` is built with ``g++`` at first use into the package's
``_build/`` directory, under a name keyed by a hash of the source and the
flags (so an edited source is rebuilt and a stale library is never loaded),
and loaded with ``ctypes``.  Without ``g++`` the library is unavailable:
``native_compile`` returns None and ``compile_plan(backend="auto")`` runs
the Python compiler, while ``backend="native"`` raises."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "jt_compile.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_lib_failed = False


class _JtResult(ctypes.Structure):
    _fields_ = [
        ("num_cliques", ctypes.c_int32),
        ("clique_offsets", ctypes.POINTER(ctypes.c_int32)),
        ("clique_vars", ctypes.POINTER(ctypes.c_int32)),
        ("factor_to_clique", ctypes.POINTER(ctypes.c_int32)),
        ("elim_order", ctypes.POINTER(ctypes.c_int32)),
        ("num_fill_edges", ctypes.c_int32),
        ("fill_edges", ctypes.POINTER(ctypes.c_int32)),
        ("treewidth", ctypes.c_int32),
        ("num_seps", ctypes.c_int32),
        ("sep_offsets", ctypes.POINTER(ctypes.c_int32)),
        ("sep_vars", ctypes.POINTER(ctypes.c_int32)),
        ("edges", ctypes.POINTER(ctypes.c_int32)),
    ]


def library_path() -> str:
    """Where the library built from the current source lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libjtcompile_{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            [gxx, *GXX_FLAGS, _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return True


def get_lib():
    """The loaded native library, or None if it cannot be built."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.jt_compile.restype = ctypes.POINTER(_JtResult)
            lib.jt_compile.argtypes = [
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.jt_free_result.restype = None
            lib.jt_free_result.argtypes = [ctypes.POINTER(_JtResult)]
            _lib = lib
        except OSError:
            _lib_failed = True
    return _lib


def available() -> bool:
    return get_lib() is not None


def native_compile(
    int_factors: Sequence[Sequence[int]], int_sizes: Sequence[int]
) -> Optional[dict]:
    """Run the native compiler.  Returns a dict of plain-Python structures
    (same content as the Python triangulate + treebuild path) or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    num_vars = len(int_sizes)
    sizes_arr = np.asarray(int_sizes, dtype=np.int64)
    offsets = np.zeros(len(int_factors) + 1, dtype=np.int32)
    for i, f in enumerate(int_factors):
        offsets[i + 1] = offsets[i] + len(f)
    flat = np.asarray(
        [v for f in int_factors for v in f] or [0], dtype=np.int32
    )
    res = lib.jt_compile(
        num_vars,
        sizes_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(int_factors),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if not res:
        return None
    try:
        # marshal with bulk ndarray.tolist() rather than per-int Python loops
        r = res.contents
        n = r.num_cliques
        co = np.ctypeslib.as_array(r.clique_offsets, shape=(n + 1,))
        cv_list = np.ctypeslib.as_array(
            r.clique_vars, shape=(max(int(co[n]), 1),)
        ).tolist()
        co_list = co.tolist()
        maxcliques = [
            cv_list[co_list[c]:co_list[c + 1]] for c in range(n)
        ]
        f2c = np.ctypeslib.as_array(
            r.factor_to_clique, shape=(max(len(int_factors), 1),)
        )[: len(int_factors)].tolist()
        elim = np.ctypeslib.as_array(
            r.elim_order, shape=(max(num_vars, 1),)
        )[:num_vars].tolist()
        nf = int(r.num_fill_edges)
        fill_edges = list(
            map(
                tuple,
                np.ctypeslib.as_array(r.fill_edges, shape=(max(2 * nf, 1),))[
                    : 2 * nf
                ].reshape(nf, 2).tolist(),
            )
        )
        ns = int(r.num_seps)
        so_list = np.ctypeslib.as_array(
            r.sep_offsets, shape=(ns + 1,)
        ).tolist()
        sv_list = np.ctypeslib.as_array(
            r.sep_vars, shape=(max(so_list[ns], 1),)
        ).tolist()
        separators = [
            sv_list[so_list[s]:so_list[s + 1]] for s in range(ns)
        ]
        edges = list(
            map(
                tuple,
                np.ctypeslib.as_array(r.edges, shape=(max(3 * ns, 1),))[
                    : 3 * ns
                ].reshape(ns, 3).tolist(),
            )
        )
        return {
            "maxcliques": maxcliques,
            "factor_to_maxclique": f2c,
            "elimination_order": elim,
            "fill_edges": fill_edges,
            "treewidth": int(r.treewidth),
            "separators": separators,
            "edges": edges,
        }
    finally:
        lib.jt_free_result(res)
