"""Fused exact k-NN screen: the hand-written CUDA kernel and its plain twin.

Port of hnsw_tpu/ops/pallas_exact.py. The kernel
(``csrc/exact_screen.cu``) scores a query batch against the whole table
and keeps each query's k_sel best (distance, id) pairs on chip; the
[Q, N] score matrix never reaches device memory. ``exact_topk_fused``
then reranks that pool in f32, as the JAX wrapper does.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes ``exact_screen_reference``, the plain torch version of the same
contract. On CUDA every float32 table runs the Gram product on the
tensor cores (TF32 ``wgmma``); the shape picks only who fills the
kernel's shared-memory ring (``screen_route``): TMA (``"wgmma"``) where
it can take both operands, else the threads' own ``cp.async`` copies
(``"wgmma_cp"``: D % 4 != 0, or a row view off 16-byte alignment). The
kernel's keys are int64 (distance bits high, column id low), so unlike
the TPU's packed int32 keys they lose no distance bits and cannot
collide; ties go to the lower id in both versions.

The library is compiled with nvcc at first use into ``build/hnsw_tpu_torch``
beside the package (rebuilt when the source is newer) and bound with
ctypes; nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Tuple

import torch

from hnsw_tpu_torch.config import canonical_metric
from hnsw_tpu_torch.ops.distance import (HIGHEST, INF_DIST, _epilogue,
                                         bf16_round, gathered_dist)
from hnsw_tpu_torch.ops.topk import exact_topk, topk_smallest

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "exact_screen.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hnsw_tpu_torch")
_METRIC_CODE = {"cosine": 0, "l2": 1, "sqeuclidean": 2, "dot": 3}
_EMPTY_KEY = (1 << 63) - 1
#: exact_screen_launch returns this + the CUresult when a TMA map fails
_ERR_TMA = 100000
#: most candidates the merge kernel sorts per query (n_seg * k_sel)
_MERGE_MAX = 4096
K_SEL_MAX = 128
#: table rows per matmul + sort step of the plain version
_REF_CHUNK = 65536

#: the producers of the library's one screen kernel, by route code
ROUTES = {"wgmma": 1, "wgmma_cp": 2}
#: kernel launches so far (one per screen call on a CUDA tensor), in all
#: and by route
launches = 0
launches_by_route = {"wgmma": 0, "wgmma_cp": 0}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build(defines=()) -> str:
    """Compile ``csrc/exact_screen.cu`` if the library is missing or older
    than the source; returns the library's path. ``defines``: macros
    passed as ``-D`` (the timing variants of ``tools/screen_split.py``;
    the port defines none)."""
    so = os.path.join(BUILD_DIR, "libexact_screen.so")
    if (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(SOURCE)):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", *(f"-D{m}" for m in defines), SOURCE, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    with open(os.path.join(BUILD_DIR, "exact_screen.ptxas.txt"), "w") as f:
        f.write(res.stderr)
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.exact_screen_launch.argtypes = [ci] + [vp] * 4 + [ci] * 8 \
                + [vp, vp, vp]
            lib.exact_screen_launch.restype = ci
            lib.exact_screen_blocks_per_sm.argtypes = [ci, ci, ci]
            lib.exact_screen_blocks_per_sm.restype = ci
            for fn in (lib.exact_screen_tile_queries,
                       lib.exact_screen_tile_columns):
                fn.argtypes = []
                fn.restype = ci
            _lib = lib
        return _lib


def _plan_segments(lib, device, route: int, nq: int, n: int, k_sel: int,
                   fast: bool) -> Tuple[int, int]:
    """(n_seg, seg_len): cut N so that the (query tiles x segments) grid
    of ``route``'s kernel fills about two waves of resident blocks."""
    tq = lib.exact_screen_tile_queries()
    tc = lib.exact_screen_tile_columns()
    per_sm = lib.exact_screen_blocks_per_sm(route, k_sel, int(fast))
    if per_sm <= 0:
        raise RuntimeError(f"exact_screen occupancy query failed "
                           f"(cudaError {-per_sm})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-nq // tq)
    col_tiles = -(-n // tc)
    n_seg = max(1, min(2 * sms * per_sm // q_tiles, col_tiles,
                       _MERGE_MAX // k_sel))
    seg_len = -(-col_tiles // n_seg) * tc
    return -(-n // seg_len), seg_len


def _decode(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 keys -> (dists f32, ids int64); empty slots -> (INF, -1)."""
    empty = keys == _EMPTY_KEY
    hi = (keys >> 32).to(torch.int32)
    bits = torch.where(hi >= 0, hi, torch.iinfo(torch.int32).min - hi)
    dists = torch.where(empty, float(INF_DIST), bits.view(torch.float32))
    ids = torch.where(empty, -1, keys & 0xFFFFFFFF)
    return dists, ids


def screen_route(queries: torch.Tensor, vectors: torch.Tensor) -> str:
    """The producer a screen of these float32 tensors takes: "wgmma"
    (TMA) when TMA can copy both matrices (D % 4 == 0, so a row is a
    multiple of 16 bytes, and 16-byte aligned base pointers), else
    "wgmma_cp" (cp.async, which takes any D and any 4-byte aligned
    pointer). Both run the same tensor-core screen."""
    if (queries.shape[-1] % 4 == 0 and queries.data_ptr() % 16 == 0
            and vectors.data_ptr() % 16 == 0):
        return "wgmma"
    return "wgmma_cp"


def _screen_cuda(queries, vectors, v_sq, valid, k_sel, metric, fast_math,
                 route):
    """Checks, then one launch of ``route``'s screen + merge."""
    global launches
    dev = queries.device
    for name, t, dt in (("queries", queries, torch.float32),
                        ("vectors", vectors, torch.float32),
                        ("v_sq", v_sq, torch.float32),
                        ("valid", valid, torch.bool)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.ndim != 2 or vectors.ndim != 2:
        raise ValueError("queries and vectors must be 2-D")
    nq, d = queries.shape
    n = vectors.shape[0]
    if d < 1 or vectors.shape[1] != d:
        raise ValueError(f"dimension mismatch: queries {tuple(queries.shape)}"
                         f", vectors {tuple(vectors.shape)}")
    if v_sq.shape != (n,) or valid.shape != (n,):
        raise ValueError("v_sq and valid must be [N]")
    if not 1 <= k_sel <= min(K_SEL_MAX, n):
        raise ValueError(f"k_sel must be in [1, min({K_SEL_MAX}, N)], "
                         f"got {k_sel}")
    if n >= 2 ** 31 or nq >= 2 ** 31:
        raise ValueError("N and Q must be < 2^31")
    if metric not in _METRIC_CODE:
        raise ValueError(f"the CUDA screen takes builtin metrics only, "
                         f"got {metric!r}")
    keys = torch.empty((nq, k_sel), dtype=torch.int64, device=dev)
    if nq == 0:
        return _decode(keys)
    lib = _load()
    code = ROUTES[route]
    with torch.cuda.device(dev):
        n_seg, seg_len = _plan_segments(lib, dev, code, nq, n, k_sel,
                                        fast_math)
        partial = torch.empty((nq, n_seg, k_sel), dtype=torch.int64,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.exact_screen_launch(
            code, queries.data_ptr(), vectors.data_ptr(), v_sq.data_ptr(),
            valid.data_ptr(), nq, n, d, k_sel, n_seg, seg_len,
            _METRIC_CODE[metric], int(fast_math), partial.data_ptr(),
            keys.data_ptr(), stream)
    if rc >= _ERR_TMA:
        raise RuntimeError(f"exact_screen ({route}): no TMA map, CUresult "
                           f"{rc - _ERR_TMA}")
    if rc != 0:
        raise RuntimeError(f"exact_screen ({route}) launch failed: "
                           f"cudaError {rc}")
    with _lock:                  # slices on one card launch from threads
        launches += 1
        launches_by_route[route] += 1
    return _decode(keys)


def exact_screen_reference(queries: torch.Tensor, vectors: torch.Tensor,
                           v_sq: torch.Tensor, valid: torch.Tensor, *,
                           k_sel: int, metric: str = "cosine",
                           fast_math: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the CUDA screen, same contract: the k_sel
    smallest (distance, id) pairs per query, ascending, ties to the lower
    id, masked or missing slots as (INF_DIST, -1). Chunked matmul +
    epilogue + stable sort on distance over id-ordered columns."""
    metric = canonical_metric(metric)
    q = queries.to(torch.float32)
    q_sq = torch.sum(q * q, dim=-1)
    qm = bf16_round(q) if fast_math else q
    n = vectors.shape[0]
    best_d = torch.empty((q.shape[0], 0), dtype=torch.float32,
                         device=q.device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for c0 in range(0, n, _REF_CHUNK):
        c1 = c0 + _REF_CHUNK
        v = vectors[c0:c1].to(torch.float32)
        d = _epilogue(metric, qm @ (bf16_round(v) if fast_math else v).T,
                      q_sq, v_sq[c0:c1])
        d = torch.where(valid[c0:c1][None, :], d, float(INF_DIST))
        ids = torch.arange(c0, c0 + v.shape[0], device=q.device)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, ids.expand(q.shape[0], -1)], dim=1)
        best_d, pos = topk_smallest(cat_d, k_sel)
        best_i = torch.gather(cat_i, 1, pos)
    best_i = torch.where(best_d >= INF_DIST, -1, best_i)
    return best_d, best_i


def exact_screen(queries: torch.Tensor, vectors: torch.Tensor,
                 v_sq: torch.Tensor, valid: torch.Tensor, *, k_sel: int,
                 metric: str = "cosine", fast_math: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Screening pass: (dists [Q, k_sel], ids [Q, k_sel]). CUDA tensors go
    through the kernel of ``screen_route``, CPU tensors through
    ``exact_screen_reference``."""
    metric = canonical_metric(metric)
    if queries.is_cuda:
        return _screen_cuda(queries, vectors, v_sq, valid, k_sel, metric,
                            fast_math, screen_route(queries, vectors))
    if vectors.is_cuda:
        raise ValueError("queries are on the CPU but vectors are on CUDA")
    return exact_screen_reference(queries, vectors, v_sq, valid,
                                  k_sel=k_sel, metric=metric,
                                  fast_math=fast_math)


def rerank_pool(queries: torch.Tensor, vectors: torch.Tensor,
                v_sq: torch.Tensor, ids: torch.Tensor, *, k: int,
                metric: str = "cosine"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 rerank of a screened pool (ids [Q, k_sel], -1 = none) ->
    (dists [Q, k], ids [Q, k]) exact-ordered, -1/INF for misses. Equal
    f32 distances go to the lower id, whatever order the screen left the
    pool in (the kernel's 3xTF32 screen and the plain version round
    differently)."""
    q = queries.to(torch.float32)
    n = vectors.shape[0]
    ids = torch.sort(torch.where(ids >= 0, ids, n), dim=1).values
    ids = torch.where(ids < n, ids, -1)
    safe = torch.clamp(ids, 0, n - 1)
    q_sq = torch.sum(q * q, dim=-1)
    d = gathered_dist(q, vectors[safe].to(torch.float32), v_sq[safe], q_sq,
                      metric=metric, precision=HIGHEST)
    d = torch.where(ids >= 0, d, float(INF_DIST))
    kk = min(k, d.shape[1])
    dk, pos = topk_smallest(d, kk)
    ik = torch.gather(ids, 1, pos)
    if k > kk:
        dk = torch.nn.functional.pad(dk, (0, k - kk), value=float(INF_DIST))
        ik = torch.nn.functional.pad(ik, (0, k - kk), value=-1)
    ik = torch.where(dk >= INF_DIST, -1, ik)
    return dk, ik


#: fewest table rows, and largest k, at which an exact f32 scan takes K1
FUSED_MIN_ROWS, FUSED_MAX_K = 32768, 120


def fused_applies(n: int, k: int, metric: str, table: torch.Tensor) -> bool:
    """Whether an exact scan of ``n`` table rows for the top ``k`` goes
    through K1 (``exact_topk_fused``): at least 32,768 rows, k <= 120, a
    built-in metric and a float32 CUDA ``table``. Elsewhere (fewer rows,
    larger k, custom metrics, reduced tables, the CPU) the chunked plain
    scan ``ops/topk.exact_topk`` runs. Both give f32-exact distances and
    order, ties to the lower id. The exact tier, the streaming tier's
    float32 chunks and facets' masked scan all decide here; any D and any
    row view of a float32 table takes the tensor-core kernel."""
    return (n >= FUSED_MIN_ROWS and k <= FUSED_MAX_K
            and canonical_metric(metric) in _METRIC_CODE
            and table.is_cuda and table.dtype == torch.float32)


def exact_scan(queries: torch.Tensor, vectors: torch.Tensor,
               v_sq: torch.Tensor, valid: torch.Tensor, *, k: int,
               metric: str = "cosine", fast_math: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of a query batch over a whole table: K1 where
    ``fused_applies``, else ``ops/topk.exact_topk``. Returns (dists [Q, k],
    ids [Q, k] int64), misses (INF_DIST, -1)."""
    if fused_applies(vectors.shape[0], k, metric, vectors):
        # exact_topk_fused reranks its winner pool in f32, so its results
        # are exact-ordered for both precisions
        return exact_topk_fused(queries, vectors, v_sq, valid, k=k,
                                metric=metric, fast_math=fast_math)
    return exact_topk(queries, vectors, v_sq, valid, k=k, metric=metric,
                      fast_math=fast_math)


def exact_topk_fused(queries: torch.Tensor, vectors: torch.Tensor,
                     v_sq: torch.Tensor, valid: torch.Tensor, *, k: int,
                     metric: str = "cosine", fast_math: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused exact k-NN: screen + f32 rerank of the k_sel = min(k+8, 128,
    N) winners. Returns (dists [Q, k], idx [Q, k]) with f32-exact
    distances and ordering; k <= 120. (The JAX wrapper's ``interpret``
    flag has no counterpart: the device of the tensors picks kernel or
    plain version.)"""
    if k > 120:
        raise ValueError("exact_topk_fused supports k <= 120")
    metric = canonical_metric(metric)
    queries = queries.to(torch.float32).contiguous()
    k_sel = min(k + 8, K_SEL_MAX, vectors.shape[0])
    _, ids = exact_screen(queries, vectors, v_sq, valid, k_sel=k_sel,
                          metric=metric, fast_math=fast_math)
    return rerank_pool(queries, vectors, v_sq, ids, k=k, metric=metric)
