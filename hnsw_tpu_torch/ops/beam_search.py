"""Beam search of one graph layer: the hand-written CUDA kernel (K2).

The kernel (``csrc/beam_search.cu``) runs one layer of
``core/search.beam_search_layer`` for a batch of queries with one block a
query: the query's pool stays in shared memory and its hops loop inside
the kernel, so a layer is one launch with no host sync between hops. Its
plain twin is ``core/search.beam_search_layer_reference``, which returns
the same pools (the kernel's f32 sums run in another order).

Which calls take the kernel is decided here, in ``hop_kernel_applies``:
CUDA tensors, a built-in metric and a merge it knows, within the
kernel's shared-memory limit, in every layout ``core/state.from_host``
makes. Its scoring mode follows the twin's ``_score_hop`` /
``_score_blocks`` (``layer_mode``): "blocks" (layer 0 with int8 or fp16
neighbour blocks), "qrows" (the int8 capacity mode: ``qvec`` rows with
per-row ``qscale``, ``vectors`` a [1, D] placeholder), "rows" / "f16rows"
/ "bf16rows" (a float32 / float16 / bfloat16 ``vectors`` store). Every
other call (a CPU tensor, a registered custom metric) runs the twin; on
CUDA each such layer is counted in ``twin_layers_on_cuda``, by reason, so
a caller can see that a covered mode never reached the twin. Which modes
multiply a bf16-rounded query is decided here too (``rounds_operands``):
the kernel rounds it as the launch says.

The library is compiled with nvcc at first use into ``build/hnsw_tpu_torch``
beside the package (rebuilt when the source is newer) and bound with
ctypes; nothing is built when this module is imported. A build or launch
that fails raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import torch

from hnsw_tpu_torch.ops.distance import DEFAULT
from hnsw_tpu_torch.ops.exact_screen import BUILD_DIR, _nvcc

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "beam_search.cu")
_METRIC_CODE = {"cosine": 0, "l2": 1, "sqeuclidean": 2, "dot": 3}
#: the kernel's scoring modes (csrc/beam_search.cu S_*)
(_SCORE_F32, _SCORE_BF16, _SCORE_I8, _SCORE_F16, _SCORE_Q8ROW,
 _SCORE_F16ROW, _SCORE_B16ROW) = range(7)
#: the row store's dtype -> its mode (a float32 store is "rows")
_ROW_MODES = {torch.float32: "rows", torch.float16: "f16rows",
              torch.bfloat16: "bf16rows"}
_MERGE_CODE = {"bitonic": 0, "sort": 1}

#: largest pool plus candidate block (P + E*M) the kernel takes: its merge
#: buffer is the next power of two, at most 4,096 entries
HOP_MAX_WIDTH = 4096
#: dynamic shared memory a block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
_THREADS = 128

#: the kernel's scoring modes, as ``layer_mode`` names them
MODES = ("rows", "blocks", "qrows", "f16rows", "bf16rows")
#: kernel launches so far (one per layer searched on CUDA), in all and by
#: scoring mode
launches = 0
launches_by_mode = dict.fromkeys(MODES, 0)
#: layers searched by the twin on CUDA tensors, by reason: "mode" (a
#: registered metric or a merge the kernel lacks), "size" (a covered mode
#: past HOP_MAX_WIDTH or SMEM_LIMIT) or "other" (a covered mode within its
#: limits: a graph that is not on the card, or the twin forced)
twin_layers_on_cuda = {"mode": 0, "size": 0, "other": 0}

_lock = threading.Lock()
_lib = None


def build(defines=(), build_dir: Optional[str] = None,
          source: Optional[str] = None) -> str:
    """Compile ``csrc/beam_search.cu`` (or ``source``) into ``build_dir``
    (default ``BUILD_DIR``) if the library is missing or older than the
    source; returns the library's path. ``defines``: macros passed as
    ``-D`` (``BEAM_PHASE_CLOCKS`` for ``tools/hop_split.py``; the port
    defines none). ptxas's report goes to ``beam_search.ptxas.txt``
    beside the library."""
    build_dir = build_dir or BUILD_DIR
    source = source or SOURCE
    so = os.path.join(build_dir, "libbeam_search.so")
    if (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(source)):
        return so
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    # --split-compile=0: the optimizer runs on every core, over the
    # source's 44 kernel instantiations (K2's 14, K5's 30)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "--split-compile=0", "-Xptxas", "-v",
           *(f"-D{m}" for m in defines), source, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    with open(os.path.join(build_dir, "beam_search.ptxas.txt"), "w") as f:
        f.write(res.stderr)
    os.replace(tmp, so)
    return so


def bind(path: str):
    """The library at ``path`` loaded with ctypes, its entry points
    typed."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.beam_search_launch.argtypes = (
        [vp] * 4 + [ci, vp, ci, vp, ci, vp, vp, vp, vp, ci, vp]
        + [ci] * 11 + [vp] * 5)
    lib.beam_search_launch.restype = ci
    lib.beam_search_smem_bytes.argtypes = [ci] * 5
    lib.beam_search_smem_bytes.restype = ci
    lib.beam_search_blocks_per_sm.argtypes = [ci] * 3
    lib.beam_search_blocks_per_sm.restype = ci
    lib.beam_search_clock_khz.restype = ci
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def smem_bytes(D: int, P: int, E: int, M: int, merge: str) -> int:
    """Dynamic shared memory of one block of the kernel, in bytes (the
    library's ``beam_search_smem_bytes``): the pool's hash table (twice
    its keys: pool ids, and under the bitonic merge a hop's candidate ids;
    8 bytes a slot), the sort keys (8 bytes, at least 64), the query row,
    the pool, the merge buffer (the next power of two >= P + E*M under the
    bitonic merge, P under the sort merge), four candidate arrays, the
    sort merge's ranked list, the selection and three counts."""
    C = E * M
    sort = merge == "sort"
    wb = P if sort else _next_pow2(P + C)
    table = _next_pow2(2 * (P + (0 if sort else C)))
    keys = max(64, _next_pow2(C))
    return 8 * (table + keys) + 4 * (((D + 3) & ~3) + 2 * P + 2 * wb + 4 * C
                                     + (3 * C if sort else 0) + 2 * E + 4)


def _covered(g, layer: int, metric: str, merge: str
             ) -> Tuple[Optional[str], int]:
    """(mode, M): the kernel's scoring mode for one layer of ``g`` at any
    size, or None for a mode it lacks, and the layer's neighbour width.
    The order is the twin's: layer-0 blocks, then the int8 capacity
    mode's rows, then the ``vectors`` store by its dtype."""
    if metric not in _METRIC_CODE or merge not in _MERGE_CODE:
        return None, 0
    if layer == 0 and g.nbr_blocks is not None:
        if g.nbr_blocks.dtype not in (torch.int8, torch.float16):
            return None, 0
        return "blocks", min(g.layer_width(0), g.nbr_blocks.shape[1])
    if g.qvec is not None and g.vectors.shape[0] <= 1:
        return "qrows", g.layer_width(layer)
    mode = _ROW_MODES.get(g.vectors.dtype)
    if mode is None or g.vectors.shape[0] <= 1:
        return None, 0
    return mode, g.layer_width(layer)


def layer_mode(g, layer: int, metric: str, P: int, E: int,
               merge: str = "bitonic") -> Optional[str]:
    """The kernel's scoring mode for one layer of ``g`` on any device:
    "blocks" (layer 0 with int8 or fp16 ``nbr_blocks``), "qrows" (the int8
    capacity mode: ``qvec`` with ``vectors`` the [1, D] placeholder),
    "rows" / "f16rows" / "bf16rows" (a float32 / float16 / bfloat16
    ``vectors`` store of more than one row), or None when the twin runs (a
    registered metric, an unknown merge, or a pool and candidate block
    past ``HOP_MAX_WIDTH`` or ``SMEM_LIMIT``)."""
    mode, M = _covered(g, layer, metric, merge)
    if mode is None or (P + E * M > HOP_MAX_WIDTH
                        or smem_bytes(g.dim, P, E, M, merge) > SMEM_LIMIT):
        return None
    return mode


def hop_kernel_applies(g, layer: int, metric: str, queries: torch.Tensor,
                       P: int, E: int, merge: str = "bitonic") -> bool:
    """Whether ``core/search.beam_search_layer`` runs this layer through the
    kernel: CUDA tensors and a ``layer_mode``. The one place that decides;
    every other call runs ``beam_search_layer_reference``."""
    return (queries.is_cuda and g.neighbors.is_cuda
            and layer_mode(g, layer, metric, P, E, merge) is not None)


def count_twin_layer(g, layer: int, metric: str, P: int, E: int,
                     merge: str = "bitonic") -> str:
    """Counts one layer that ran the twin on CUDA in
    ``twin_layers_on_cuda``, by reason: "mode" where the kernel lacks the
    layer's mode (a registered metric, an unknown merge), "size" where
    the mode is covered but ``layer_mode`` finds the layer past its
    limits, else "other" (a graph that is not on the card, the twin
    forced). Returns the reason."""
    if _covered(g, layer, metric, merge)[0] is None:
        reason = "mode"
    elif layer_mode(g, layer, metric, P, E, merge) is None:
        reason = "size"
    else:
        reason = "other"
    with _lock:
        twin_layers_on_cuda[reason] += 1
    return reason


def score_code(g, mode: str, precision: str) -> int:
    """The kernel's scoring mode (csrc/beam_search.cu S_*) for a layer of
    ``g`` that ``layer_mode`` puts in ``mode``: the blocks' dtype, the
    precision of f32 rows, else the row store's own mode."""
    if mode == "blocks":
        return _SCORE_I8 if g.nbr_blocks.dtype == torch.int8 else _SCORE_F16
    if mode == "rows":
        return _SCORE_BF16 if precision == DEFAULT else _SCORE_F32
    return {"qrows": _SCORE_Q8ROW, "f16rows": _SCORE_F16ROW,
            "bf16rows": _SCORE_B16ROW}[mode]


def rounds_operands(score: int, precision: str) -> bool:
    """Whether scoring mode ``score`` (``score_code``) multiplies a
    bf16-rounded query, as the twin does: f32 rows at DEFAULT (their rows
    rounded too), int8 blocks and int8 rows at any precision, bf16 rows
    at DEFAULT; never fp16 rows or blocks (f32 at any precision) or f32
    and bf16 rows at HIGHEST / HIGH. The launch passes it to the kernel
    (``round_q``). Every product is then exact in f32 but f32 x fp16 /
    bf16, which both sides round once, so the kernel parts from the twin
    only in its order of f32 sums."""
    return (score in (_SCORE_BF16, _SCORE_I8, _SCORE_Q8ROW)
            or (score == _SCORE_B16ROW and precision == DEFAULT))


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def beam_search_cuda(g, layer: int, queries: torch.Tensor,
                     q_sq: torch.Tensor, start_ids: torch.Tensor,
                     start_d: torch.Tensor, *, pool_size: int,
                     max_hops: int, metric: str, precision: str, expand: int,
                     merge: str, store_normalized: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """One launch of the kernel for one layer. Returns (pool_d [B, P] f32,
    pool_i [B, P] int32, hops [B] int32, work [B, 2] int32: nodes expanded
    and candidates scored by each query), the pools as the twin returns
    them. Raises on what the kernel does not take."""
    global launches
    P = pool_size
    E = max(1, min(expand, P))
    mode = layer_mode(g, layer, metric, P, E, merge)
    if not queries.is_cuda or mode is None:
        raise ValueError(f"the beam-search kernel does not take layer "
                         f"{layer} of this graph ({metric}, P={P}, E={E}, "
                         f"{merge}, on {queries.device})")
    dev = queries.device
    queries = queries.to(torch.float32).contiguous()
    q_sq = q_sq.to(torch.float32).contiguous()
    B, D = queries.shape
    if D != g.dim or q_sq.shape != (B,):
        raise ValueError(f"queries {tuple(queries.shape)} and q_sq "
                         f"{tuple(q_sq.shape)} do not fit a D={g.dim} graph")
    if start_ids.ndim == 1:
        start_ids, start_d = start_ids[:, None], start_d[:, None]
    start_ids = _i32(start_ids)
    start_d = start_d.to(torch.float32).contiguous()
    if start_ids.shape[0] != B or start_d.shape != start_ids.shape:
        raise ValueError("start ids and distances must be [B] or [B, S]")
    if g.nbr_upper is not None and layer > 0:
        table = g.nbr_upper[layer - 1]
        umap = g.upper_map
    else:
        table, umap = g.neighbors[layer], None
    table = _i32(table)
    if umap is not None:
        umap = _i32(umap)
    score = score_code(g, mode, precision)
    blocks = scale = vectors = sq = qscale = None
    if mode == "blocks":
        blocks = g.nbr_blocks.contiguous()
        M = min(g.layer_width(0), blocks.shape[1])
        scale = (g.block_scale.to(torch.float32).reshape(()).contiguous()
                 if score == _SCORE_I8 else None)
    else:
        M = g.layer_width(layer)
        sq = g.sq_norms.to(torch.float32).contiguous()
        if mode == "qrows":
            vectors = g.qvec.contiguous()
            qscale = g.qscale.to(torch.float32).contiguous()
        else:
            vectors = g.vectors.contiguous()
    for name, t in (("table", table), ("upper_map", umap),
                    ("vectors", vectors), ("sq_norms", sq),
                    ("qscale", qscale), ("nbr_blocks", blocks),
                    ("block_scale", scale), ("start_ids", start_ids)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
    out_d = torch.empty((B, P), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, P), dtype=torch.int32, device=dev)
    hops = torch.zeros((B,), dtype=torch.int32, device=dev)
    work = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    if B == 0:
        return out_d, out_i, hops, work

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.beam_search_launch(
            ptr(queries), ptr(q_sq), ptr(start_ids), ptr(start_d),
            start_ids.shape[1], ptr(table), table.shape[1], ptr(umap),
            table.shape[0], ptr(vectors), ptr(sq), ptr(qscale),
            ptr(blocks), blocks.shape[1] if blocks is not None else 0,
            ptr(scale), B, D, P, E, M, max_hops, _METRIC_CODE[metric],
            score, _MERGE_CODE[merge], int(bool(store_normalized)),
            int(rounds_operands(score, precision)), ptr(out_d),
            ptr(out_i), ptr(hops), ptr(work), stream)
    if rc != 0:
        raise RuntimeError(f"beam_search ({mode}) launch failed: "
                           f"cudaError {rc}")
    with _lock:                  # slices on one card launch from threads
        launches += 1
        launches_by_mode[mode] += 1
    return out_d, out_i, hops, work
