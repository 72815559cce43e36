"""A whole graph search in one launch: the hand-written CUDA kernel K5.

The kernel (``graph_search_kernel`` in ``csrc/beam_search.cu``) runs all
of ``core/search.search_graph`` for a batch, one block a query: the entry
distances (the graph's entry, or the caller's seeds), every upper layer's
narrow beam and the hand-off of its best entry, layer 0, and the f32
rerank of the pool's head. Each layer is K2's device code
(``layer_search``, the body of ``beam_search_kernel``), so a layer gives
what one K2 launch gives. Its plain version is
``core/search.search_graph_reference``, the composition of one
``beam_search_layer`` a layer that the kernel replaces.

Which calls take the kernel is decided here, in
``search_kernel_applies``: CUDA tensors, and every layer the search runs
in one of K2's modes within K2's limits (``ops/beam_search.layer_mode``),
with the entries scored in a row mode, at most ``MAX_UP`` upper layers,
and the whole block's shared memory within ``SMEM_LIMIT``. Every other
call runs the plain version; on CUDA each is counted in
``plain_on_cuda``, by reason.

The kernel is built into K2's library (``ops/beam_search.build``, nvcc at
first use) and bound here with ctypes; nothing is built when this module
is imported. A build or launch that fails raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Tuple

import torch

from hnsw_tpu_torch.ops import beam_search as bs
from hnsw_tpu_torch.utils.profiling import span

#: upper layers the kernel takes (csrc/beam_search.cu MAX_UP)
MAX_UP = 64
#: the rerank's row store by dtype: csrc/beam_search.cu S_F32, S_F16ROW,
#: S_B16ROW (each read at full precision)
_RERANK_SCORE = {torch.float32: bs._SCORE_F32,
                 torch.float16: bs._SCORE_F16ROW,
                 torch.bfloat16: bs._SCORE_B16ROW}

#: kernel launches so far (one a search), in all and by layer 0's mode
launches = 0
launches_by_mode = dict.fromkeys(bs.MODES, 0)
#: searches of CUDA tensors the plain version ran, by reason: "mode" (a
#: layer or the entries in a mode the kernel lacks: a registered metric, an
#: unknown merge), "size" (covered modes past HOP_MAX_WIDTH, SMEM_LIMIT or
#: MAX_UP) or "other" (covered and within the limits: a graph that is not
#: on the card, or the plain version forced)
plain_on_cuda = {"mode": 0, "size": 0, "other": 0}

_lock = threading.Lock()
_lib = None


def _load():
    """K2's library (``ops/beam_search._load``) with K5's entry points
    typed."""
    global _lib
    lib = bs._load()
    with _lock:
        if _lib is not lib:
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.graph_search_launch.argtypes = (
                [vp, vp, vp, vp, ci, ci, vp, vp, ci, vp, vp, ci, vp, vp, vp,
                 vp, ci, vp, vp] + [ci] * 20 + [vp] * 4)
            lib.graph_search_launch.restype = ci
            lib.graph_search_smem_bytes.argtypes = [ci] * 10
            lib.graph_search_smem_bytes.restype = ci
            lib.graph_search_blocks_per_sm.argtypes = [ci] * 4
            lib.graph_search_blocks_per_sm.restype = ci
            _lib = lib
        return lib


def smem_bytes(D: int, P_up: int, E_up: int, M_up: int, n_up: int, P0: int,
               E0: int, M0: int, merge: str, n_seed: int) -> int:
    """Dynamic shared memory of one block of the kernel, in bytes (the
    library's ``graph_search_smem_bytes``): the larger of the layouts of
    the layers it searches (``ops/beam_search.smem_bytes``: layer 0's, and
    the upper layers' when n_up > 0), rounded up to 8, then the n_seed
    entries' ids and distances."""
    o = bs.smem_bytes(D, P0, E0, M0, merge)
    if n_up > 0:
        o = max(o, bs.smem_bytes(D, P_up, E_up, M_up, merge))
    return ((o + 7) & ~7) + 8 * n_seed


def row_mode(g) -> Optional[str]:
    """The mode the entries (and every upper layer) are scored in, as
    ``_score_hop`` scores rows: "qrows" (the int8 capacity mode), else the
    ``vectors`` store's ("rows", "f16rows", "bf16rows"); None for a store
    the kernel lacks."""
    if g.qvec is not None and g.vectors.shape[0] <= 1:
        return "qrows"
    if g.vectors.shape[0] <= 1:
        return None
    return bs._ROW_MODES.get(g.vectors.dtype)


def _plan(g, metric: str, P0: int, P_up: int, expand: int, merge: str,
          n_seed: Optional[int]) -> Tuple[Optional[dict], str]:
    """The launch's plan ({"mode0", "mode_up", "n_up", "E0", "E_up", "M0",
    "M_up", "smem"}) and "", or None and the reason the kernel does not
    take the search ("mode" or "size"). ``n_seed``: the width of the
    caller's seeds, or None for the descent from the graph's entry."""
    E0, E_up = max(1, min(expand, P0)), max(1, min(expand, P_up))
    n_up = 0 if n_seed is not None else g.num_layers - 1
    up = row_mode(g)
    mode0, M0 = bs._covered(g, 0, metric, merge)
    if up is None or mode0 is None or n_seed == 0:
        return None, "mode"
    widths = {g.layer_width(layer) for layer in range(1, n_up + 1)}
    if len(widths) > 1:
        return None, "mode"
    M_up = widths.pop() if widths else 1
    if any(bs._covered(g, layer, metric, merge)[0] != up
           for layer in range(1, n_up + 1)):
        return None, "mode"
    smem = smem_bytes(g.dim, P_up, E_up, M_up, n_up, P0, E0, M0, merge,
                      1 if n_seed is None else min(n_seed, P0))
    if (n_up > MAX_UP or smem > bs.SMEM_LIMIT
            or bs.layer_mode(g, 0, metric, P0, E0, merge) is None
            or (n_up and bs.layer_mode(g, 1, metric, P_up, E_up, merge)
                is None)):
        return None, "size"
    return dict(mode0=mode0, mode_up=up, n_up=n_up, E0=E0, E_up=E_up, M0=M0,
                M_up=M_up, smem=smem), ""


def search_kernel_applies(g, metric: str, queries: torch.Tensor, P0: int,
                          P_up: int, expand: int, merge: str,
                          n_seed: Optional[int] = None) -> Optional[dict]:
    """The launch's plan where ``core/search.search_graph`` runs this
    search through the kernel, else None: CUDA tensors, and every layer it
    searches (with ``n_seed``, the width of the caller's seeds, layer 0
    alone) in one of K2's modes within K2's limits, the entries in a row
    mode, at most ``MAX_UP`` upper layers and the block's shared memory
    within ``SMEM_LIMIT``. The one place that decides; every other call
    runs ``search_graph_reference``. ``graph_search_cuda`` takes the plan,
    so a search works it out once."""
    if not (queries.is_cuda and g.neighbors.is_cuda):
        return None
    return _plan(g, metric, P0, P_up, expand, merge, n_seed)[0]


def count_plain(g, metric: str, P0: int, P_up: int, expand: int,
                merge: str, n_seed: Optional[int] = None) -> str:
    """Counts one search of CUDA tensors that ran the plain version in
    ``plain_on_cuda``, by reason ("mode", "size", else "other"); returns
    the reason."""
    reason = _plan(g, metric, P0, P_up, expand, merge, n_seed)[1] or "other"
    with _lock:
        plain_on_cuda[reason] += 1
    return reason


@contextlib.contextmanager
def plain(twin: bool = False):
    """Inside the block every search runs the plain version
    (``search_kernel_applies`` patched to say no): one
    ``beam_search_layer`` a layer, which is a K2 launch on the card, or
    with ``twin`` K2's plain twin (``ops/beam_search.hop_kernel_applies``
    patched too), so that nothing of the search runs K2's device code. The
    searches and layers it so sends there are left out of
    ``plain_on_cuda`` and ``twin_layers_on_cuda``."""
    global search_kernel_applies
    real, counts = search_kernel_applies, dict(plain_on_cuda)
    real_k2, counts_k2 = bs.hop_kernel_applies, dict(bs.twin_layers_on_cuda)
    search_kernel_applies = lambda *a, **kw: None  # noqa: E731
    if twin:
        bs.hop_kernel_applies = lambda *a, **kw: False
    try:
        yield
    finally:
        search_kernel_applies = real
        bs.hop_kernel_applies = real_k2
        plain_on_cuda.update(counts)
        bs.twin_layers_on_cuda.update(counts_k2)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def upper_tables(g, n_up: int) -> list:
    """Layer l's neighbour table at l - 1, for l in 1 .. n_up: a view of
    ``neighbors`` or of the split ``nbr_upper``, or the compact tuple's
    own tensor (rows through ``upper_map``)."""
    if g.nbr_upper is not None:
        return [_i32(g.nbr_upper[layer - 1]) for layer in range(1, n_up + 1)]
    return [_i32(g.neighbors[layer]) for layer in range(1, n_up + 1)]


def graph_search_cuda(g, queries: torch.Tensor, plan: Optional[dict], *,
                      k: int, P0: int, P_up: int, expand: int, max_hops: int,
                      metric: str, precision: str, merge: str,
                      store_normalized: bool, rerank: bool,
                      seed_ids: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the kernel for a whole search, with ``plan``,
    ``search_kernel_applies``' answer for these arguments. Returns (dists
    [B, k] f32, slot ids [B, k] int32, hops [n_up + 1, B] int32: each
    query's hop count a layer, the top layer first; one row, layer 0's,
    with seeds), all three views of one buffer (``to_host`` copies them at
    once). ``rerank``: the pool's first R = min(P0, max(2k, 16)) entries
    are scored again at full f32 and ranked stably, else the pool's first
    k are returned. Raises on what the kernel does not take (no plan, or
    queries off the card)."""
    global launches
    n_seed = None if seed_ids is None else int(seed_ids.shape[1])
    if not queries.is_cuda or plan is None:
        raise ValueError(f"the graph-search kernel does not take this "
                         f"search ({metric}, P0={P0}, P_up={P_up}, "
                         f"expand={expand}, {merge}, seeds {n_seed}, on "
                         f"{queries.device})")
    if k > P0:
        raise ValueError(f"k={k} is larger than the pool ({P0})")
    with span("k5.prepare"):
        dev = queries.device
        queries = queries.to(torch.float32).contiguous()
        B, D = queries.shape
        if D != g.dim:
            raise ValueError(f"queries {tuple(queries.shape)} do not fit "
                             f"a D={g.dim} graph")
        # the squared norms as the plain version takes them (two launches)
        q_sq = torch.sum(queries * queries, dim=-1)
        n_up = plan["n_up"]
        mode0, mode_up = plan["mode0"], plan["mode_up"]
        tables = upper_tables(g, n_up)
        umap = (_i32(g.upper_map) if g.nbr_upper is not None
                and g.upper_map is not None and n_up else None)
        table0 = _i32(g.neighbors[0])
        sq = g.sq_norms.to(torch.float32).contiguous()
        qscale = None
        if mode_up == "qrows":
            vectors = g.qvec.contiguous()
            qscale = g.qscale.to(torch.float32).contiguous()
        else:
            vectors = g.vectors.contiguous()
        score_up = bs.score_code(g, mode_up, precision)
        score0 = bs.score_code(g, mode0, precision)
        blocks = scale = None
        if mode0 == "blocks":
            blocks = g.nbr_blocks.contiguous()
            if score0 == bs._SCORE_I8:
                scale = (g.block_scale.to(torch.float32).reshape(())
                         .contiguous())
        R, rr_score, rr_vectors = 0, 0, None
        if rerank:
            R = min(P0, max(2 * k, 16))
            rr_vectors = g.vectors.contiguous()
            rr_score = _RERANK_SCORE[rr_vectors.dtype]
        seeds = None if seed_ids is None else _i32(seed_ids)
        if seeds is not None and seeds.shape[0] != B:
            raise ValueError("seed ids must be [B, S]")
        for name, t in (("neighbors", table0), ("upper_map", umap),
                        ("vectors", vectors), ("sq_norms", sq),
                        ("qscale", qscale), ("nbr_blocks", blocks),
                        ("block_scale", scale), ("entry", g.entry),
                        ("seed_ids", seeds), *(("upper table", t)
                                               for t in tables)):
            if t is not None and t.device != dev:
                raise ValueError(f"{name} is on {t.device}, queries on "
                                 f"{dev}")
        buf = torch.empty(2 * B * k + (n_up + 1) * B, dtype=torch.int32,
                          device=dev)
        out_d = buf[:B * k].view(torch.float32).view(B, k)
        out_i = buf[B * k:2 * B * k].view(B, k)
        hops = buf[2 * B * k:].view(n_up + 1, B)
        if B == 0:
            return out_d, out_i, hops

        def ptr(t):
            return None if t is None else t.data_ptr()

        lib = _load()
        up_ptrs = (ctypes.c_void_p * max(1, n_up))(*[t.data_ptr()
                                                     for t in tables])
        up_rows = (ctypes.c_int * max(1, n_up))(*[t.shape[0]
                                                   for t in tables])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("k5.launch"):
            rc = lib.graph_search_launch(
                ptr(queries), ptr(q_sq), ptr(g.entry), ptr(seeds), n_seed or 0,
                n_up,
                up_ptrs, up_rows, plan["M_up"],
                ptr(umap), ptr(table0), table0.shape[1], ptr(vectors), ptr(sq),
                ptr(qscale), ptr(blocks),
                blocks.shape[1] if blocks is not None else 0, ptr(scale),
                ptr(rr_vectors), rr_score, R, k, B, D, g.cap, P_up,
                plan["E_up"], plan["M_up"], P0, plan["E0"], plan["M0"],
                max_hops, bs._METRIC_CODE[metric], score_up, score0,
                bs._MERGE_CODE[merge], int(bool(store_normalized)),
                int(bs.rounds_operands(score_up, precision)),
                int(bs.rounds_operands(score0, precision)), ptr(out_d),
                ptr(out_i), ptr(hops), stream)
    if rc != 0:
        raise RuntimeError(f"graph_search ({mode0}, uppers {mode_up}) "
                           f"launch failed: cudaError {rc}")
    with _lock:                  # slices on one card launch from threads
        launches += 1
        launches_by_mode[mode0] += 1
    return out_d, out_i, hops


def to_host(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors on the host. Views of one card buffer (the kernel's
    outputs) come back in one device-to-host copy of that buffer; others
    one copy each."""
    with span("hnsw.results.copy"):
        stores = {t.untyped_storage().data_ptr() for t in tensors}
        if len(stores) != 1:
            return tuple(t.cpu() for t in tensors)
        whole = torch.empty(0, dtype=torch.uint8, device=tensors[0].device)
        host = whole.set_(tensors[0].untyped_storage()).cpu()
        return tuple(torch.as_strided(host.view(t.dtype), t.shape,
                                      t.stride(), t.storage_offset())
                     for t in tensors)

