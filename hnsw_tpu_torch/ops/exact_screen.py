"""Fused exact k-NN screen: the hand-written CUDA kernel and its plain twins.

Port of hnsw_tpu/ops/pallas_exact.py (K1) and of the capacity scan
hnsw_tpu/ops/topk.py:quantized_topk_candidates (K3). The kernel
(``csrc/exact_screen.cu``) scores a query batch against the whole table
and keeps each query's k_sel best (distance, id) pairs on chip; the
[Q, N] score matrix never reaches device memory.

K1, float32 tables: ``exact_topk_fused`` screens, then reranks the pool
in f32, as the JAX wrapper does. A CUDA tensor launches the kernel (or
raises); a CPU tensor takes ``exact_screen_reference``, the plain torch
version of the same contract. On CUDA every float32 table runs the Gram
product on the tensor cores (TF32 ``wgmma``); the shape picks only who
fills the kernel's shared-memory ring (``screen_route``): TMA
(``"wgmma"``) where it can take both operands, else the threads' own
``cp.async`` copies (``"wgmma_cp"``: D % 4 != 0, or a row view off
16-byte alignment).

K3, the capacity modes' reduced tables (int8 rows with per-row scales,
bf16, fp16): ``capacity_scan`` launches a capacity screen where
``capacity_applies``, else runs the plain
``ops/topk.quantized_topk_candidates``. ``capacity_route`` picks the
kernel: the int8 and bf16 tables that TMA can copy take
``screen_ws_kernel`` ("bf16_ws": bf16 ``wgmma``, a resident query tile,
a warp-specialised ring) where its lists fit a warp's registers and its
ring and queries a block (``ws_applies``: kk <= 32, D <= 192); the rest
take the same kernel as K1 with the table's store (TMA, or ordinary
loads for the row pitches TMA cannot take). Its launches are counted by
store (``capacity_launches_by_store``) and by route
(``capacity_launches_by_route``), apart from K1's; the plain scans it
runs on a CUDA table are counted too (``capacity_plain_on_cuda``).

The kernel's keys are int64 (distance bits high, column id low), so
unlike the TPU's packed int32 keys they lose no distance bits and cannot
collide; ties go to the lower id in every version.

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
from hnsw_tpu_torch.ops.topk import (exact_topk, quantized_topk_candidates,
                                     topk_smallest)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "exact_screen.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hnsw_tpu_torch")
_METRIC_CODE = {"cosine": 0, "l2": 1, "sqeuclidean": 2, "dot": 3}
_EMPTY_KEY = (1 << 63) - 1
#: exact_screen_launch returns this + the CUresult when a TMA map fails
_ERR_TMA = 100000
#: and this when the "bf16_ws" kernel's registers cannot cover its
#: setmaxnreg budget (it is then not launched)
_ERR_REGS = 90000
#: most candidates the merge kernel sorts per query (n_seg * k_sel)
_MERGE_MAX = 4096
#: largest k_sel of K1 (the JAX kernel's limit) and of the capacity screen
#: (k = 170 on the int8 rung, whose pool is k + k // 2)
K_SEL_MAX = 128
CAPACITY_K_MAX = 256
#: table rows per matmul + sort step of the plain version
_REF_CHUNK = 65536

#: the producers of the library's one screen kernel for a float32 table,
#: by route code
ROUTES = {"wgmma": 1, "wgmma_cp": 2}
#: the capacity screen's routes: K1's kernel fed by TMA or by ordinary
#: loads ("wgmma_ld"), and the warp-specialised bf16 screen of int8 and
#: bf16 tables ("bf16_ws", TMA)
CAPACITY_ROUTES = {"wgmma": 1, "wgmma_ld": 3, "bf16_ws": 4}
#: "bf16_ws"'s block (csrc/exact_screen.cu WS_*, which these repeat):
#: consumer warpgroups of 64 queries each, table rows a tile, bf16 a
#: swizzle row, tiles in the ring by store, int8's raw tiles in flight,
#: the most dynamic shared memory a block may take (227 KB), and the
#: largest kk (a list is 8 entries in each of its quad's 4 lanes)
WS_CONSUMERS, WS_TILE_COLUMNS, WS_KB = 4, 64, 64
WS_STAGES = {"int8": 3, "bf16": 4}
WS_RAW = 4
WS_SMEM_MAX = 232_448
WS_K_MAX = 32
#: the library's store codes: float32 (f32-accurate or fast_math) and the
#: capacity modes' reduced tables, by torch dtype
STORES = {"float32": 0, "fast_math": 1, "int8": 2, "bf16": 3, "fp16": 4}
_REDUCED = {torch.int8: "int8", torch.bfloat16: "bf16",
            torch.float16: "fp16"}
#: K1's launches so far (one per screen call on a float32 CUDA table), in
#: all and by route
launches = 0
launches_by_route = {"wgmma": 0, "wgmma_cp": 0}
#: the capacity screen's launches so far (one per capacity_scan call that
#: takes the kernel), in all and by store
capacity_launches = 0
capacity_launches_by_store = {"int8": 0, "bf16": 0, "fp16": 0}
capacity_launches_by_route = {"wgmma": 0, "wgmma_ld": 0, "bf16_ws": 0}
#: capacity scans of a CUDA table that ran the plain version (off
#: capacity_applies: kk past CAPACITY_K_MAX, or a custom metric)
capacity_plain_on_cuda = 0

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
            lib.exact_screen_launch.argtypes = [ci] + [vp] * 5 + [ci] * 8 \
                + [vp, vp, vp]
            lib.exact_screen_launch.restype = ci
            lib.exact_screen_blocks_per_sm.argtypes = [ci] * 4
            lib.exact_screen_blocks_per_sm.restype = ci
            lib.exact_screen_smem_bytes.argtypes = [ci] * 4
            lib.exact_screen_smem_bytes.restype = ctypes.c_size_t
            for fn in (lib.exact_screen_tile_queries,
                       lib.exact_screen_tile_columns):
                fn.argtypes = [ci]
                fn.restype = ci
            _lib = lib
        return _lib


def _plan_segments(lib, device, route: int, nq: int, n: int, d: int,
                   k_sel: int, store: int) -> Tuple[int, int]:
    """(n_seg, seg_len): cut N so that the (query tiles x segments) grid
    of the kernel of ``route`` and ``store`` (codes) fills about two waves
    of resident blocks; one for "bf16_ws", whose one block an SM per
    segment runs equal work, and where each segment costs its lists'
    fill again (about kk (1 + ln(segment / kk)) inserts a query)."""
    tq = lib.exact_screen_tile_queries(route)
    tc = lib.exact_screen_tile_columns(route)
    per_sm = lib.exact_screen_blocks_per_sm(route, d, k_sel, store)
    if per_sm <= 0:
        raise RuntimeError(f"exact_screen occupancy query failed "
                           f"(cudaError {-per_sm})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    waves = 1 if route == CAPACITY_ROUTES["bf16_ws"] else 2
    q_tiles = -(-nq // tq)
    col_tiles = -(-n // tc)
    n_seg = max(1, min(waves * sms * per_sm // q_tiles, col_tiles,
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


def ws_smem_bytes(d: int, store: str) -> int:
    """Dynamic shared memory of "bf16_ws"'s kernel for an int8 or bf16
    table of width ``d`` (csrc/exact_screen.cu ws_smem_bytes): 1 KiB of
    alignment slack, the four consumers' resident 64-query tiles (bf16, D
    padded to 64), the ring of bf16 tiles (and int8's raw tiles), each
    tile's norms / mask / scales, the query norms and the mbarriers. Its
    lists live in registers."""
    n_kb = -(-d // WS_KB)
    ns, i8 = WS_STAGES[store], store == "int8"
    return (1024 + WS_CONSUMERS * n_kb * 64 * 128
            + ns * n_kb * WS_TILE_COLUMNS * 128
            + (WS_RAW * n_kb * WS_TILE_COLUMNS * WS_KB if i8 else 0)
            + ns * 3 * WS_TILE_COLUMNS * 4 + 64 * WS_CONSUMERS * 4
            + (2 * ns + (2 * WS_RAW if i8 else 0)) * 8)


def ws_applies(d: int, kk: int, store: str) -> bool:
    """Whether "bf16_ws" takes an int8 or bf16 table of width ``d`` for
    ``kk`` candidates: kk <= WS_K_MAX (a list lives in registers, 8
    entries in each of 4 lanes) and its shared memory fits a block (D <=
    192).
    Elsewhere (fp16, kk 150 on the int8 rung, wide tables) the capacity
    screen keeps K1's kernel."""
    return (store in WS_STAGES and 1 <= kk <= WS_K_MAX
            and ws_smem_bytes(d, store) <= WS_SMEM_MAX)


def capacity_route(queries: torch.Tensor, table: torch.Tensor,
                   kk: int) -> str:
    """The kernel and producer a capacity screen of this reduced
    ``table`` for ``kk`` candidates takes. At a row pitch (D times the
    value's bytes) and base pointers that are multiples of 16 bytes (int8
    D % 16 == 0, bf16 / fp16 D % 8 == 0), TMA: "bf16_ws" for int8 and
    bf16 where ``ws_applies`` (min(kk, N) candidates), else "wgmma" (K1's
    kernel with the table's store). Any other D and offset: "wgmma_ld"
    (K1's kernel, ordinary loads)."""
    pitch = table.shape[-1] * table.element_size()
    if not (pitch % 16 == 0 and table.data_ptr() % 16 == 0
            and queries.data_ptr() % 16 == 0):
        return "wgmma_ld"
    store = _REDUCED.get(table.dtype)
    if ws_applies(table.shape[-1], min(kk, table.shape[0]), store):
        return "bf16_ws"
    return "wgmma"


def _check_args(queries, table, scales, v_sq, valid, k_sel, metric,
                table_dtypes, k_max):
    """The wrapper's checks of what the kernel takes: device, types (the
    table one of ``table_dtypes``), shapes, contiguity, k_sel (at most
    ``k_max``) and metric."""
    dev = queries.device
    args = [("queries", queries, (torch.float32,)),
            ("vectors", table, table_dtypes),
            ("v_sq", v_sq, (torch.float32,)),
            ("valid", valid, (torch.bool,))]
    if table.dtype == torch.int8:
        if scales is None:
            raise ValueError("an int8 table needs its per-row scales")
        args.append(("scales", scales, (torch.float32,)))
    elif scales is not None:
        raise ValueError(f"scales go with an int8 table, not "
                         f"{table.dtype}")
    for name, t, dts in args:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
        if t.dtype not in dts:
            raise TypeError(f"{name} must be {' or '.join(map(str, dts))}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.ndim != 2 or table.ndim != 2:
        raise ValueError("queries and vectors must be 2-D")
    nq, d = queries.shape
    n = table.shape[0]
    if d < 1 or table.shape[1] != d:
        raise ValueError(f"dimension mismatch: queries {tuple(queries.shape)}"
                         f", vectors {tuple(table.shape)}")
    if v_sq.shape != (n,) or valid.shape != (n,) or (
            scales is not None and scales.shape != (n,)):
        raise ValueError("v_sq, valid and scales must be [N]")
    if not 1 <= k_sel <= min(k_max, n):
        raise ValueError(f"k_sel must be in [1, min({k_max}, N)], "
                         f"got {k_sel}")
    if n >= 2 ** 31 or nq >= 2 ** 31:
        raise ValueError("N and Q must be < 2^31")
    if metric not in _METRIC_CODE:
        raise ValueError(f"the CUDA screen takes builtin metrics only, "
                         f"got {metric!r}")


def _launch(queries, table, scales, v_sq, valid, k_sel, metric, store,
            route, label, plan=None) -> torch.Tensor:
    """One launch of the screen + merge of ``store`` fed by ``route``
    (codes); returns the [Q, k_sel] int64 keys. ``plan``: (n_seg,
    seg_len) in place of ``_plan_segments``' (tests put a segment boundary
    inside a tile). Raises on any error."""
    dev = queries.device
    nq, n, d = queries.shape[0], table.shape[0], queries.shape[1]
    keys = torch.empty((nq, k_sel), dtype=torch.int64, device=dev)
    if nq == 0:
        return keys
    lib = _load()
    with torch.cuda.device(dev):
        if plan is None:
            n_seg, seg_len = _plan_segments(lib, dev, route, nq, n, d,
                                            k_sel, store)
        else:
            n_seg, seg_len = plan
            if (n_seg != -(-n // seg_len)
                    or n_seg * k_sel > _MERGE_MAX):
                raise ValueError(f"plan {plan} does not cut N={n} into "
                                 f"segments the merge takes")
        partial = torch.empty((nq, n_seg, k_sel), dtype=torch.int64,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.exact_screen_launch(
            route, queries.data_ptr(), table.data_ptr(),
            None if scales is None else scales.data_ptr(), v_sq.data_ptr(),
            valid.data_ptr(), nq, n, d, k_sel, n_seg, seg_len,
            _METRIC_CODE[metric], store, partial.data_ptr(),
            keys.data_ptr(), stream)
    if rc >= _ERR_TMA:
        raise RuntimeError(f"exact_screen ({label}): no TMA map, CUresult "
                           f"{rc - _ERR_TMA}")
    if rc == _ERR_REGS:
        raise RuntimeError(f"exact_screen ({label}): the compiled kernel's "
                           f"registers do not cover its setmaxnreg budget")
    if rc != 0:
        raise RuntimeError(f"exact_screen ({label}) launch failed: "
                           f"cudaError {rc}")
    return keys


def _screen_cuda(queries, vectors, v_sq, valid, k_sel, metric, fast_math,
                 route):
    """Checks, then one launch of ``route``'s float32 screen + merge."""
    global launches
    _check_args(queries, vectors, None, v_sq, valid, k_sel, metric,
                (torch.float32,), K_SEL_MAX)
    keys = _launch(queries, vectors, None, v_sq, valid, k_sel, metric,
                   int(fast_math), ROUTES[route], route)
    if queries.shape[0]:
        with _lock:              # slices on one card launch from threads
            launches += 1
            launches_by_route[route] += 1
    return _decode(keys)


def _capacity_cuda(queries, table, scales, v_sq, valid, kk, metric, route,
                   plan=None):
    """Checks, then one launch of the capacity screen of ``table``'s store
    through ``route`` (``plan``: as ``_launch``'s)."""
    global capacity_launches
    _check_args(queries, table, scales, v_sq, valid, kk, metric,
                tuple(_REDUCED), CAPACITY_K_MAX)
    store = _REDUCED[table.dtype]
    if route == "bf16_ws" and not ws_applies(queries.shape[1], kk, store):
        raise ValueError(f"bf16_ws does not take a {store} table at "
                         f"D={queries.shape[1]}, kk={kk}")
    keys = _launch(queries, table, scales, v_sq, valid, kk, metric,
                   STORES[store], CAPACITY_ROUTES[route],
                   f"capacity {store}, {route}", plan)
    if queries.shape[0]:
        with _lock:
            capacity_launches += 1
            capacity_launches_by_store[store] += 1
            capacity_launches_by_route[route] += 1
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


def capacity_applies(n: int, kk: int, metric: str, table: torch.Tensor,
                     scales) -> bool:
    """Whether a capacity scan of ``n`` rows for ``kk`` candidates goes
    through the capacity screen (K3's kernel): any table of at least one
    row, min(kk, n) <= CAPACITY_K_MAX, a built-in metric, and a CUDA
    ``table`` that is int8 with float32 per-row ``scales``, or bf16 or
    fp16 (no scales). Unlike K1 there is no row switch: the kernel is
    ahead of the plain scan at every table size measured (the smoke's
    phase 3). Elsewhere (a larger kk, custom metrics, the CPU) the plain
    ``ops/topk.quantized_topk_candidates`` runs; both give the same
    candidates, ties to the lower id."""
    if table.dtype == torch.int8:
        store_ok = scales is not None and scales.dtype == torch.float32
    else:
        store_ok = table.dtype in _REDUCED and scales is None
    return (n >= 1 and 1 <= min(kk, n) <= CAPACITY_K_MAX
            and canonical_metric(metric) in _METRIC_CODE
            and table.is_cuda and store_ok)


def capacity_scan(queries: torch.Tensor, table: torch.Tensor, scales,
                  v_sq: torch.Tensor, valid: torch.Tensor, *, kk: int,
                  metric: str = "cosine"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity modes' candidate scan over a reduced table (int8 with
    per-row ``scales``, bf16 or fp16): the kk smallest reduced-precision
    distances per query. The capacity screen where ``capacity_applies``
    (a build or launch error raises; nothing falls back), else the plain
    ``ops/topk.quantized_topk_candidates``. Returns (dists [Q, kk'], ids
    [Q, kk'] int64), kk' = min(kk, N), ascending, ties to the lower id,
    masked or missing slots (INF_DIST, -1); callers restore exact order
    with an f32 host rerank."""
    global capacity_plain_on_cuda
    metric = canonical_metric(metric)
    n = table.shape[0]
    if capacity_applies(n, kk, metric, table, scales):
        q = queries.to(torch.float32).contiguous()
        return _capacity_cuda(q, table, scales, v_sq, valid, min(kk, n),
                              metric, capacity_route(q, table, kk))
    if table.is_cuda:
        with _lock:
            capacity_plain_on_cuda += 1
    return quantized_topk_candidates(queries, table, scales, v_sq, valid,
                                     kk=kk, metric=metric)
