"""ctypes bindings for the native C++ host engine (native/hnsw_native.cpp).

The library is compiled on first use with g++ -O3 -march=native and
cached next to the source. If the toolchain is unavailable the caller
falls back to the pure-Python host path (core/host_build.py) — same
semantics, slower.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_METRIC_CODE = {"cosine": 0, "l2": 1, "sqeuclidean": 2, "dot": 3}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

def _find_src() -> Optional[str]:
    """Locate the C++ source: env override, repo layout (native/ next
    to the package), or the installed package copy (native_src/ ships
    as package data — pyproject.toml)."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    cands = [
        os.environ.get("HNSW_TPU_NATIVE_SRC", ""),
        os.path.join(os.path.dirname(pkg), "native", "hnsw_native.cpp"),
        os.path.join(pkg, "native_src", "hnsw_native.cpp"),
    ]
    for c in cands:
        if c and os.path.exists(c):
            return c
    return None


def _so_path(src: str) -> str:
    """Cache the compiled library next to the source when that
    directory is writable (the repo case), else under ~/.cache
    (installed site-packages may be read-only)."""
    d = os.path.dirname(src)
    if os.access(d, os.W_OK):
        return os.path.join(d, "libhnsw_native.so")
    cache = os.path.join(os.path.expanduser("~"), ".cache", "hnsw_tpu")
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, "libhnsw_native.so")


def _build() -> Optional[str]:
    src = _find_src()
    if src is None:
        return None
    so = _so_path(src)
    if os.path.exists(so) and (os.path.getmtime(so) >=
                               os.path.getmtime(os.path.realpath(src))):
        return so
    # -pthread: the engine spawns std::thread for batch fan-out; on
    # glibc < 2.34 a plain -shared build aborts the host process with
    # std::system_error at the first thread construction
    # compile to a private name and rename: both packages (and parallel
    # test workers) share this library path, and a reader must never
    # load a half-written file
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-pthread",
           "-std=c++17", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        i32, i64, f32p = ctypes.c_int32, ctypes.c_int64, ctypes.POINTER(
            ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.hnsw_insert_batch.restype = ctypes.c_int
        lib.hnsw_insert_batch.argtypes = [
            f32p, f32p, i32p, i32p, i64, i32, i32, i32, i32, i32, i32,
            i32, i32, i64p, i32p, i64, i32p, i32p]
        lib.hnsw_delete_batch.restype = i64
        lib.hnsw_delete_batch.argtypes = [
            f32p, f32p, i32p, i32p, i64, i32, i32, i32, i32, i32, i32,
            i32, i32, i64p, i64, i32p, i32p]
        lib.hnsw_search_batch.restype = ctypes.c_int
        lib.hnsw_search_batch.argtypes = [
            f32p, f32p, i32p, i32p, i64, i32, i32, i32, i32, i32, i32,
            f32p, i64, i32, i32, i32, i32, i64p, i64, i32, i64p, f32p]
        lib.hnsw_exact_scan.restype = ctypes.c_int
        lib.hnsw_exact_scan.argtypes = [
            ctypes.c_void_p, i32, f32p, f32p, i32p, ctypes.c_void_p,
            i64, i32, i32, f32p, f32p, f32p, i64, i32, i32, i64p, f32p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ct)


def _common_args(host):
    """(args tuple, cap) for the shared array header."""
    cfg = host.cfg
    nb = host.neighbors
    assert nb.flags["C_CONTIGUOUS"]
    cap = nb.shape[1]
    store = host.store
    return (
        _ptr(store.vectors[:cap], ctypes.POINTER(ctypes.c_float)),
        _ptr(store.sq_norms[:cap], ctypes.POINTER(ctypes.c_float)),
        _ptr(nb, ctypes.POINTER(ctypes.c_int32)),
        _ptr(host.levels, ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(cap),
        ctypes.c_int32(store.dim),
        ctypes.c_int32(nb.shape[0]),
        ctypes.c_int32(nb.shape[2]),
        ctypes.c_int32(cfg.m),
        ctypes.c_int32(cfg.m_base),
    ), cap


def insert_batch(host, slots: np.ndarray, slot_levels: np.ndarray) -> bool:
    """Native sequential insert on the host graph arrays. Caller must
    have ensured capacity for max(slot_levels) layers and all slots, and
    stored the vectors. Updates host.entry/top/count.

    Contract: a False return guarantees the host arrays are UNTOUCHED
    (the C++ validates the whole batch before mutating anything), so the
    caller's Python fallback re-run is safe."""
    lib = get_lib()
    if lib is None or host.metric not in _METRIC_CODE:
        return False  # custom metrics take the Python path
    # vectors/levels arrays must cover cap rows
    host.store.ensure_capacity(host.neighbors.shape[1])
    common, cap = _common_args(host)
    slots = np.ascontiguousarray(slots, np.int64)
    lv = np.ascontiguousarray(slot_levels, np.int32)
    entry = ctypes.c_int32(host.entry)
    top = ctypes.c_int32(host.top)
    rc = lib.hnsw_insert_batch(
        *common, ctypes.c_int32(host.cfg.ef_construction),
        ctypes.c_int32(_METRIC_CODE[host.metric]),
        ctypes.c_int32(1 if host.cfg.diversify else 0),
        _ptr(slots, ctypes.POINTER(ctypes.c_int64)),
        _ptr(lv, ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(slots)),
        ctypes.byref(entry), ctypes.byref(top))
    if rc != 0:
        return False
    host.entry = int(entry.value)
    host.top = int(top.value)
    host.count += len(slots)
    return True


def delete_batch(host, slots: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None or host.metric not in _METRIC_CODE:
        return False  # custom metrics take the Python path
    host.store.ensure_capacity(host.neighbors.shape[1])
    common, cap = _common_args(host)
    slots = np.ascontiguousarray(slots, np.int64)
    entry = ctypes.c_int32(host.entry)
    top = ctypes.c_int32(host.top)
    lib.hnsw_delete_batch(
        *common, ctypes.c_int32(host.cfg.ef_construction),
        ctypes.c_int32(_METRIC_CODE[host.metric]),
        ctypes.c_int32(1 if host.cfg.diversify else 0),
        _ptr(slots, ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(slots)),
        ctypes.byref(entry), ctypes.byref(top))
    host.entry = int(entry.value)
    host.top = int(top.value)
    host.count -= len(slots)
    return True


def search_batch(host, queries: np.ndarray, k: int, ef: int,
                 pivots: Optional[np.ndarray] = None, n_seed: int = 1):
    """Native CPU batch search -> (dists [Q,k], slot ids [Q,k]).

    ``pivots`` (int64 slot ids) switches on pivot-seeded entry: the
    engine scores the pivots with SIMD dots and seeds the layer-0 beam
    with the ``n_seed`` best basins, skipping the upper-layer descent
    (Graph.entry_mode="pivots" ported down to the host engine)."""
    lib = get_lib()
    if lib is None or host.metric not in _METRIC_CODE:
        return None
    host.store.ensure_capacity(host.neighbors.shape[1])
    common, cap = _common_args(host)
    queries = np.ascontiguousarray(queries, np.float32)
    n_q = queries.shape[0]
    out_ids = np.empty((n_q, k), np.int64)
    out_d = np.empty((n_q, k), np.float32)
    if pivots is None:
        pivots = np.empty((0,), np.int64)
    pivots = np.ascontiguousarray(pivots, np.int64)
    lib.hnsw_search_batch(
        *common[:10],
        ctypes.c_int32(_METRIC_CODE[host.metric]),
        _ptr(queries, ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n_q), ctypes.c_int32(k), ctypes.c_int32(ef),
        ctypes.c_int32(host.entry), ctypes.c_int32(host.top),
        _ptr(pivots, ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(pivots)), ctypes.c_int32(n_seed),
        _ptr(out_ids, ctypes.POINTER(ctypes.c_int64)),
        _ptr(out_d, ctypes.POINTER(ctypes.c_float)))
    return out_d, out_ids


_SCAN_DTYPE = {np.dtype(np.float32): 0, np.dtype(np.float16): 1,
               np.dtype(np.int8): 2}


class PreparedScan:
    """Pre-marshalled hnsw_exact_scan call for the latency tier.

    lat_micro6 dissection (10k x 128 int8 rows, single query): the raw
    C scan is ~0.15 ms while the generic ``exact_scan`` wrapper +
    ExactIndex plumbing nearly doubled it — per-call ctypes argument
    construction, ascontiguousarray revalidation, and margin/dtype
    re-derivation, all invariant across calls. This object builds the
    fixed argument tuple ONCE per (store snapshot, k); per call it only
    wraps the query pointer and two freshly allocated output arrays
    (allocation keeps it thread-safe under concurrent readers).
    """

    def __init__(self, rows: np.ndarray, k: int, kk: int, metric: str,
                 sq_norms=None, scales=None, row_sums=None, alive=None,
                 rr_rows=None, rr_sq=None):
        lib = get_lib()
        dt = _SCAN_DTYPE.get(rows.dtype) if lib is not None else None
        self.ok = (lib is not None and dt is not None
                   and metric in _METRIC_CODE
                   and rows.flags["C_CONTIGUOUS"])
        if not self.ok:
            return
        self._lib = lib
        self.k = int(k)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        null_f = ctypes.cast(None, f32p)
        n, d = rows.shape
        # keep array refs alive for the lifetime of the prepared call
        self._keep = (rows, sq_norms, scales, row_sums, alive, rr_rows,
                      rr_sq)
        self._fixed = (
            rows.ctypes.data_as(ctypes.c_void_p), ctypes.c_int32(dt),
            _ptr(sq_norms, f32p) if sq_norms is not None else null_f,
            _ptr(scales, f32p) if scales is not None else null_f,
            (_ptr(row_sums, i32p) if row_sums is not None
             else ctypes.cast(None, i32p)),
            (alive.ctypes.data_as(ctypes.c_void_p)
             if alive is not None else None),
            ctypes.c_int64(n), ctypes.c_int32(d),
            ctypes.c_int32(_METRIC_CODE[metric]),
            _ptr(rr_rows, f32p) if rr_rows is not None else null_f,
            _ptr(rr_sq, f32p) if rr_sq is not None else null_f)
        self._tail = (ctypes.c_int32(k),
                      ctypes.c_int32(max(k, min(int(kk), max(n, k)))))
        self._f32p = f32p
        self._i64p = ctypes.POINTER(ctypes.c_int64)

    def __call__(self, queries: np.ndarray):
        """queries [B, D] float32 C-contiguous (caller guarantees);
        returns (dists [B, k] f32, ids [B, k] i64) or None on error."""
        n_q = queries.shape[0]
        out_ids = np.empty((n_q, self.k), np.int64)
        out_d = np.empty((n_q, self.k), np.float32)
        rc = self._lib.hnsw_exact_scan(
            *self._fixed, queries.ctypes.data_as(self._f32p),
            ctypes.c_int64(n_q), *self._tail,
            out_ids.ctypes.data_as(self._i64p),
            out_d.ctypes.data_as(self._f32p))
        if rc != 0:
            return None
        return out_d, out_ids


def exact_scan(rows: np.ndarray, queries: np.ndarray, k: int,
               metric: str, kk: Optional[int] = None,
               sq_norms: Optional[np.ndarray] = None,
               scales: Optional[np.ndarray] = None,
               row_sums: Optional[np.ndarray] = None,
               alive: Optional[np.ndarray] = None,
               rr_rows: Optional[np.ndarray] = None,
               rr_sq: Optional[np.ndarray] = None):
    """Fused exact scan + select (+ optional f32 rerank) over a
    contiguous row store — the host latency tier's hot loop
    (hnsw_native.cpp hnsw_exact_scan). rows: [n, D] float32, float16,
    or int8 (then ``scales`` per-row f32 scales and ``row_sums``
    per-row int32 byte sums are required), C-contiguous; for cosine
    they must be UNIT rows with sq_norms=None. rr_rows/rr_sq:
    full-precision store for the exact rerank of the kk-candidate pool
    (required when rows are reduced precision). Returns
    (dists [Q,k] f32, ids [Q,k] i64) or None if unavailable."""
    lib = get_lib()
    if lib is None or metric not in _METRIC_CODE:
        return None
    dt = _SCAN_DTYPE.get(rows.dtype)
    if dt is None or not rows.flags["C_CONTIGUOUS"]:
        return None
    queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
    n, D = rows.shape
    n_q = queries.shape[0]
    kk = k if kk is None else max(k, min(int(kk), max(n, k)))
    out_ids = np.empty((n_q, k), np.int64)
    out_d = np.empty((n_q, k), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    null_f = ctypes.cast(None, f32p)
    rc = lib.hnsw_exact_scan(
        rows.ctypes.data_as(ctypes.c_void_p), ctypes.c_int32(dt),
        _ptr(sq_norms, f32p) if sq_norms is not None else null_f,
        _ptr(scales, f32p) if scales is not None else null_f,
        (_ptr(row_sums, i32p) if row_sums is not None
         else ctypes.cast(None, i32p)),
        (alive.ctypes.data_as(ctypes.c_void_p)
         if alive is not None else None),
        ctypes.c_int64(n), ctypes.c_int32(D),
        ctypes.c_int32(_METRIC_CODE[metric]),
        _ptr(rr_rows, f32p) if rr_rows is not None else null_f,
        _ptr(rr_sq, f32p) if rr_sq is not None else null_f,
        _ptr(queries, f32p),
        ctypes.c_int64(n_q), ctypes.c_int32(k), ctypes.c_int32(kk),
        _ptr(out_ids, ctypes.POINTER(ctypes.c_int64)),
        _ptr(out_d, f32p))
    if rc != 0:
        return None
    return out_d, out_ids
