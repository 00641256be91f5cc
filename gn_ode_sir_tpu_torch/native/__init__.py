"""Native host-side graph core, C++ through ctypes (port of
``gn_ode_sir_tpu.native``), with a numpy fallback.

``graphcore.cc`` (the port's own copy) is compiled at first use with
``g++ -O3 -shared -fPIC -std=c++17`` into ``gn_ode_sir_tpu_torch/_build/``
(git-ignored; never next to the source). The library's file name carries a
hash of the source and the flags, so an edited source is rebuilt, and the
build writes a temporary file that is renamed into place, so that processes
building at once do not read a half-written library. Every function returns
``None`` where the library is unavailable (no compiler, a failed build, or
``GN_ODE_SIR_NO_NATIVE`` set, which is read on every call) and the caller
takes its numpy path: this is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "graphcore.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgraphcore-{digest}.so"


def _build(path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)
    return True


def _load():
    global _lib, _tried
    if os.environ.get("GN_ODE_SIR_NO_NATIVE"):
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.gc_coalesce_undirected.restype = i64
        lib.gc_coalesce_undirected.argtypes = [i32p, i64, i64, i32p, i32p]
        lib.gc_csr_offsets.restype = i64
        lib.gc_csr_offsets.argtypes = [i32p, i64, i64, i64p]
        lib.gc_reverse_edge_index.restype = i64
        lib.gc_reverse_edge_index.argtypes = [i32p, i32p, i64, i64, i32p]
        lib.gc_degrees.restype = i64
        lib.gc_degrees.argtypes = [i32p, i64, i64, i32p]
        lib.gc_spmm_chunk_count.restype = i64
        lib.gc_spmm_chunk_count.argtypes = [i32p, i64, i64, i64]
        lib.gc_spmm_plan_fill.restype = i64
        lib.gc_spmm_plan_fill.argtypes = [i32p, i32p, f32p, i64, i64, i64, i32p, i32p, i32p,
                                          f32p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _as_i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _ptr64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ptrf(a):
    return (a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) if a is not None
            else ctypes.POINTER(ctypes.c_float)())


def coalesce_undirected(pairs: np.ndarray, n_nodes: int):
    """Raw (u, v) int pairs [m, 2] -> deduplicated symmetric COO sorted by
    (dst, src), as int32 (src, dst); None -> use the caller's fallback."""
    lib = _load()
    if lib is None:
        return None
    pairs = _as_i32(pairs).reshape(-1, 2)
    m = pairs.shape[0]
    out_src = np.empty(2 * max(m, 1), np.int32)
    out_dst = np.empty(2 * max(m, 1), np.int32)
    e = lib.gc_coalesce_undirected(_ptr32(pairs), m, n_nodes, _ptr32(out_src), _ptr32(out_dst))
    if e < 0:
        return None
    return out_src[:e].copy(), out_dst[:e].copy()


def csr_offsets(dst: np.ndarray, n_nodes: int):
    """int64 row offsets [n_nodes + 1] of a dst-sorted edge list."""
    lib = _load()
    if lib is None:
        return None
    dst = _as_i32(dst)
    offsets = np.empty(n_nodes + 1, np.int64)
    if lib.gc_csr_offsets(_ptr32(dst), dst.shape[0], n_nodes, _ptr64(offsets)) != 0:
        return None
    return offsets


def reverse_edge_index(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """int32 index of each directed edge's reverse edge, E where it has none."""
    lib = _load()
    if lib is None:
        return None
    src, dst = _as_i32(src), _as_i32(dst)
    cave = np.empty(src.shape[0], np.int32)
    if lib.gc_reverse_edge_index(_ptr32(src), _ptr32(dst), src.shape[0], n_nodes,
                                 _ptr32(cave)) != 0:
        return None
    return cave


def spmm_plan(src: np.ndarray, dst: np.ndarray, w, k_edges: int, r_rows: int):
    """Greedy (<= K edges, < R rows) chunk plan over a dst-sorted edge list,
    the host step of the JAX package's Pallas SpMM (``ops/pallas_spmm2.py``).
    The port's K1 plans with :class:`~gn_ode_sir_tpu_torch.ops.spmm2.CsrPlan`
    instead; this is kept for API parity and is on no path. Returns
    (src_padded [C*K] i32, dst_local [C, K] i32 with sentinel R padding,
    row_base [C] i32, w_padded [C*K] f32 or None); None -> caller fallback."""
    lib = _load()
    if lib is None:
        return None
    src, dst = _as_i32(src), _as_i32(dst)
    e = src.shape[0]
    c = lib.gc_spmm_chunk_count(_ptr32(dst), e, k_edges, r_rows)
    if c < 0:
        return None
    src_p = np.empty(c * k_edges, np.int32)
    dloc = np.empty((c, k_edges), np.int32)
    base = np.empty(max(c, 1), np.int32)
    w_in = None if w is None else np.ascontiguousarray(w, np.float32)
    w_out = None if w is None else np.empty(c * k_edges, np.float32)
    got = lib.gc_spmm_plan_fill(_ptr32(src), _ptr32(dst), _ptrf(w_in), e, k_edges, r_rows,
                                _ptr32(src_p), _ptr32(dloc.reshape(-1)), _ptr32(base),
                                _ptrf(w_out))
    if got != c:
        return None
    return src_p, dloc, base[:c], w_out


def degrees(dst: np.ndarray, n_nodes: int):
    """int32 count of each node's entries in ``dst``."""
    lib = _load()
    if lib is None:
        return None
    dst = _as_i32(dst)
    deg = np.empty(n_nodes, np.int32)
    if lib.gc_degrees(_ptr32(dst), dst.shape[0], n_nodes, _ptr32(deg)) != 0:
        return None
    return deg
