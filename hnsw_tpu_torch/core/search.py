"""Batched hierarchical beam search (port of hnsw_tpu/core/search.py).

B queries traverse the graph in lockstep. Each hop:

  1. select each query's best unexpanded pool entries      (stable sort)
  2. gather their M neighbor ids + vectors   (row gathers, or one [M, D]
                                              neighbor block per node)
  3. score all candidates at once            (batched matmul; f32, fp16
                                              or bf16 rows, int8 rows or
                                              blocks with scales)
  4. merge into the per-query pool                         (bitonic / sort)

The bounded result/candidate heap pair of the reference becomes a single
fixed-width pool of size P = max(ef, k) with per-entry "expanded" flags.
A query goes inactive when its best unexpanded candidate is no better
than its worst pool entry (reference graph.go:164-166).

On CUDA a layer is one launch of the hand-written kernel K2
(``ops/beam_search``, ``csrc/beam_search.cu``): one block a query, the
pool in shared memory, every hop inside the kernel, no host sync until
the layer is done, in every layout and store ``core/state.from_host``
makes (f32 / fp16 / bf16 rows, the int8 capacity mode's rows, layer-0
neighbour blocks). ``ops/beam_search.hop_kernel_applies`` decides which
calls take it. Every other call (CPU tensors, registered metrics, a pool
past the kernel's limits) runs the plain twin,
``beam_search_layer_reference``: there the JAX ``lax.while_loop`` is a
host loop that reads ``take.any()`` once per hop. Both count the hops
(``stats["hops"]``, one entry per layer searched, top layer first).
Multi-operand ``lax.sort`` is a stable ``torch.sort`` plus ``gather``.

A whole search (``search_graph``: the entries, every upper layer and its
hand-off, layer 0, the f32 rerank) is one launch of K5
(``ops/graph_search``) on CUDA, built from K2's device code, with no host
sync before the results are read; ``search_graph_reference`` is its plain
version, one ``beam_search_layer`` a layer. The builder's descent and
refine still call ``beam_search_layer`` (K2) a layer at a time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hnsw_tpu_torch.config import canonical_metric
from hnsw_tpu_torch.core.state import DeviceGraph
from hnsw_tpu_torch.ops import beam_search as _kernel
from hnsw_tpu_torch.ops import graph_search as _graph_kernel
from hnsw_tpu_torch.ops.distance import (DEFAULT, HIGHEST, INF_DIST,
                                         bf16_round, gathered_dist,
                                         gathered_epilogue, pairwise_dist,
                                         registered)
from hnsw_tpu_torch.ops.topk import topk_smallest
from hnsw_tpu_torch.utils.profiling import span

_INF = float(INF_DIST)

#: bit 30 of the merge id operand carries the "expanded" flag (slot ids
#: are dense int32 < 2^30; -1 sentinels stay negative).
_EXP_BIT = 1 << 30


def _sort_pairs(d: torch.Tensor, i: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort of ``d`` along dim 1, carrying ``i``."""
    sd, pos = torch.sort(d, dim=1, stable=True)
    return sd, torch.gather(i, 1, pos)


def _dedup_adjacent(pool_d, pool_i, expanded):
    """Mask duplicate ids in a distance-sorted pool.

    Duplicate ids carry equal distances, so after a stable sort they are
    adjacent. Masked slots get (INF, -1, expanded=True) and are pushed
    out at the next merge."""
    dup = torch.zeros_like(pool_i, dtype=torch.bool)
    dup[:, 1:] = (pool_i[:, 1:] == pool_i[:, :-1]) & (pool_i[:, 1:] >= 0)
    return (torch.where(dup, _INF, pool_d),
            torch.where(dup, -1, pool_i),
            expanded | dup)


def _bitonic_merge(pool_d, pool_i, cand_d, cand_i, P: int):
    """Merge a sorted pool with a narrow candidate block.

    pool_d/pool_i [B, P] sorted ascending; cand_d/cand_i [B, C] unsorted.
    Ids are moved opaquely (flag bits survive). Sorting the candidates
    ascending, reversing them and appending to the ascending pool (with
    an INF plateau from padding in between) forms a bitonic sequence, so
    log2(W) compare-exchange stages sort it fully. Returns the best P
    entries, ascending."""
    B, C = cand_d.shape
    cd, ci = _sort_pairs(cand_d, cand_i)
    W = P + C
    W2 = 1 << (W - 1).bit_length()
    pad = W2 - W
    if pad:
        cd = torch.nn.functional.pad(cd, (0, pad), value=_INF)
        ci = torch.nn.functional.pad(ci, (0, pad), value=-1)
    d = torch.cat([pool_d, cd.flip(1)], dim=1)
    i = torch.cat([pool_i, ci.flip(1)], dim=1)
    s = W2 // 2
    while s >= 1:
        d4 = d.reshape(B, -1, 2, s)
        i4 = i.reshape(B, -1, 2, s)
        a_d, b_d = d4[:, :, 0], d4[:, :, 1]
        a_i, b_i = i4[:, :, 0], i4[:, :, 1]
        swap = a_d > b_d
        d = torch.stack([torch.where(swap, b_d, a_d),
                         torch.where(swap, a_d, b_d)], dim=2).reshape(B, W2)
        i = torch.stack([torch.where(swap, b_i, a_i),
                         torch.where(swap, a_i, b_i)], dim=2).reshape(B, W2)
        s //= 2
    return d[:, :P], i[:, :P]


def _score_hop(g: DeviceGraph, queries, q_sq, nb_safe, metric, precision):
    """Distances from each query to its gathered candidate slots.

    Rows come from ``g.vectors`` when real vectors are on the device. The
    int8 store scores hops only in the capacity mode (``g.vectors`` is
    the [1, D] placeholder): bf16-rounded queries against the exactly
    upcast int8 rows, summed in f32, with the per-row scale folded into
    the Gram epilogue. An fp16 store is scored at HIGHEST whatever
    ``precision`` says: its 11 significand bits are what route through
    tight clusters. Custom registered metrics always consume raw
    vectors.
    """
    idx = nb_safe.long()
    if (g.qvec is not None and g.vectors.shape[0] <= 1
            and registered(metric) is None):
        qv = torch.einsum("bd,bcd->bc", bf16_round(queries),
                          g.qvec[idx].to(torch.float32))
        qv = qv * g.qscale[idx]
        return gathered_epilogue(metric, qv, q_sq, g.sq_norms[idx])
    cand_vecs = g.vectors[idx]
    if cand_vecs.dtype == torch.float16:
        precision = HIGHEST
    return gathered_dist(queries, cand_vecs, g.sq_norms[idx], q_sq,
                         metric=metric, precision=precision)


def _score_blocks(g: DeviceGraph, queries, q_sq, cur_safe, metric,
                  store_normalized):
    """Layer-0 block scoring: ONE [M, D] neighbor block per expanded
    node (cur_safe [B, E]) -> distances [B, E*M].

    int8 blocks: bf16-rounded queries against the upcast blocks, f32
    sums, times the global block_scale; squared norms are bf16-rounded
    sums of bf16-rounded squares, as the JAX package computes them.
    fp16 blocks (tight-cluster data): f32 scoring at HIGHEST. A
    pre-normalized cosine store (``store_normalized``) skips the norms.
    """
    B = queries.shape[0]
    blk = g.nbr_blocks[cur_safe.long()]                 # [B, E, M, D]
    blkf = blk.to(torch.float32)
    C = blk.shape[1] * blk.shape[2]
    int8 = blk.dtype == torch.int8
    qv = torch.einsum("bd,bemd->bem",
                      bf16_round(queries) if int8 else queries, blkf)
    qv = qv.reshape(B, C) * g.block_scale if int8 else qv.reshape(B, C)
    if store_normalized and metric == "cosine":
        vsq = torch.ones_like(qv)
    elif int8:
        bsq = bf16_round(torch.sum(bf16_round(blkf * blkf), dim=-1))
        vsq = bsq.reshape(B, C) * torch.square(g.block_scale)
    else:
        vsq = torch.sum(blkf * blkf, dim=-1).reshape(B, C)
    return gathered_epilogue(metric, qv, q_sq, vsq)


def _entry_dist(g: DeviceGraph, queries, q_sq, entry_ids, metric,
                precision):
    safe = torch.clamp(entry_ids, 0, g.cap - 1)
    d = _score_hop(g, queries, q_sq, safe[:, None], metric, precision)[:, 0]
    return torch.where(entry_ids >= 0, d, _INF)


def beam_search_layer(g: DeviceGraph, layer: int, queries: torch.Tensor,
                      q_sq: torch.Tensor, start_ids: torch.Tensor,
                      start_d: torch.Tensor, pool_size: int, max_hops: int,
                      metric: str, precision: str, expand: int = 1,
                      merge: str = "sort", store_normalized: bool = False,
                      stats: Optional[dict] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search one layer for a batch of queries: one launch of the
    CUDA kernel where ``ops/beam_search.hop_kernel_applies`` (CUDA
    tensors, a built-in metric, any store: f32, fp16 or bf16 rows, the
    int8 capacity mode's rows with per-row scales, layer-0 int8 / fp16
    blocks), else ``beam_search_layer_reference`` (same arguments, same
    results; see there). With the kernel, ``stats["hops"]`` gets the
    largest hop count of any query, which is the twin's lockstep count: a
    query that stops keeps its pool from then on. A layer on CUDA tensors
    that the twin runs (a registered metric, a pool past the kernel's
    limits, a graph not on the card) is counted in
    ``ops/beam_search.twin_layers_on_cuda``."""
    E = max(1, min(expand, pool_size))
    if not _kernel.hop_kernel_applies(g, layer, metric, queries, pool_size,
                                      E, merge):
        if queries.is_cuda:
            _kernel.count_twin_layer(g, layer, metric, pool_size, E, merge)
        return beam_search_layer_reference(
            g, layer, queries, q_sq, start_ids, start_d, pool_size,
            max_hops, metric, precision, expand=expand, merge=merge,
            store_normalized=store_normalized, stats=stats)
    pd, pi, hops, _ = _kernel.beam_search_cuda(
        g, layer, queries, q_sq, start_ids, start_d, pool_size=pool_size,
        max_hops=max_hops, metric=metric, precision=precision, expand=E,
        merge=merge, store_normalized=store_normalized)
    if stats is not None:
        stats.setdefault("hops", []).append(
            int(hops.max()) if hops.numel() else 0)
    return pd, pi


def beam_search_layer_reference(g: DeviceGraph, layer: int,
                                queries: torch.Tensor, q_sq: torch.Tensor,
                                start_ids: torch.Tensor,
                                start_d: torch.Tensor, pool_size: int,
                                max_hops: int, metric: str, precision: str,
                                expand: int = 1, merge: str = "sort",
                                store_normalized: bool = False,
                                stats: Optional[dict] = None,
                                touched: Optional[dict] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search one layer for a batch of queries, in plain PyTorch (the
    twin of the CUDA kernel, and the version every call runs off it).

    ``expand`` > 1 opens the top-E unexpanded pool entries per hop.
    ``stats`` (a dict), when given, gets this layer's hop count appended
    to ``stats["hops"]``. At layer 0 a graph with ``nbr_blocks`` scores
    one neighbor block per expanded node (_score_blocks); blocks
    narrower than M0 (block_m) expand only their first block_m edges.
    ``store_normalized`` says the cosine store holds unit rows.
    ``touched`` (a dict), when given, gets the ids of the nodes each hop
    expands in ``touched["nodes"]`` and the rows it scores in
    ``touched["rows"]`` (vector slots, or ``node * block_m + j`` for the
    block rows), as tensors: what a roofline bound reads once.

    Returns (pool_dists [B, P], pool_ids [B, P] int32) sorted ascending;
    empty slots are (INF_DIST, -1).

    There is no visited set: candidates already in the pool are masked
    by a broadcast compare before scoring, an evicted node can never
    re-enter (the pool only improves), and same-hop duplicates are
    masked before (bitonic) or after (sort) the merge. Edges to dead
    nodes were prefolded to -1 by state.from_host.
    """
    B = queries.shape[0]
    cap = g.cap
    P = pool_size
    E = max(1, min(expand, P))
    M = g.layer_width(layer)
    dev = queries.device
    use_blocks = (layer == 0 and g.nbr_blocks is not None
                  and registered(metric) is None)
    if use_blocks:
        M = min(M, g.nbr_blocks.shape[1])

    # Pool init: the start node(s) occupy the leading slots (reference
    # graph.go:122). start_ids/start_d may be [B] or [B, S].
    if start_ids.ndim == 1:
        start_ids = start_ids[:, None]
        start_d = start_d[:, None]
    S = min(start_ids.shape[1], P)
    pool_i = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    pool_i[:, :S] = start_ids[:, :S]
    pool_d = torch.full((B, P), _INF, dtype=torch.float32, device=dev)
    pool_d[:, :S] = start_d[:, :S]
    if S > 1:
        # keep the pool's sorted-ascending invariant for seeded entries
        pool_d, pool_i = _sort_pairs(pool_d, pool_i)
        pool_d, pool_i, _ = _dedup_adjacent(pool_d, pool_i, pool_i < -1)
        if merge == "bitonic":
            # push dedup holes to the tail: the bitonic merge requires a
            # hole-free ascending pool
            pool_d, pool_i = _sort_pairs(pool_d, pool_i)
    expanded = torch.zeros((B, P), dtype=torch.bool, device=dev)

    def select(pool_d, pool_i, expanded):
        """Top-E unexpanded pool entries; take-mask per entry."""
        sel_d = torch.where(expanded | (pool_i < 0), _INF, pool_d)
        best, j = topk_smallest(sel_d, E)                   # [B, E]
        worst = pool_d.max(dim=1).values                    # INF if not full
        return j, best < worst[:, None]

    j, take = select(pool_d, pool_i, expanded)
    hops = 0
    while hops < max_hops and bool(take.any()):
        cur = torch.gather(pool_i, 1, j)                     # [B, E]
        cur_safe = torch.clamp(torch.where(take, cur, 0), 0, cap - 1)
        expanded = expanded.scatter(1, j, torch.gather(expanded, 1, j)
                                    | take)

        nbrs = g.gather_neighbors(layer, cur_safe.long())[..., :M] \
            .reshape(B, E * M)                               # [B, E*M]
        nb_ok = (nbrs >= 0) & take.repeat_interleave(M, dim=1)
        # mask candidates already in the pool: without this, duplicates
        # of the best pool entries crowd out legitimate tail entries
        in_pool = (nbrs[:, :, None] == pool_i[:, None, :]).any(-1)
        nb_ok = nb_ok & ~in_pool
        if use_blocks:
            d = _score_blocks(g, queries, q_sq, cur_safe, metric,
                              store_normalized)
        else:
            nb_safe = torch.clamp(torch.where(nb_ok, nbrs, 0), 0, cap - 1)
            d = _score_hop(g, queries, q_sq, nb_safe, metric, precision)
        d = torch.where(nb_ok, d, _INF)
        new_i = torch.where(nb_ok, nbrs, -1)
        if touched is not None:
            touched.setdefault("nodes", []).append(cur[take])
            rows = (cur_safe.repeat_interleave(M, dim=1)
                    * g.nbr_blocks.shape[1]
                    + torch.arange(M, device=dev).repeat(E)
                    if use_blocks else nbrs)
            touched.setdefault("rows", []).append(rows[nb_ok])

        # the expanded flag rides in bit 30 of the id operand
        ei = torch.where(expanded & (pool_i >= 0), pool_i | _EXP_BIT,
                         pool_i)
        if merge == "bitonic":
            # same-hop diamond twins are the only possible duplicates, so
            # dedup the candidate block by O(C^2) id equality BEFORE the
            # merge; the pool then never develops holes
            C = new_i.shape[1]
            tri = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                        device=dev), diagonal=-1)
            is_dup = ((new_i[:, :, None] == new_i[:, None, :])
                      & (new_i[:, :, None] >= 0) & tri[None]).any(-1)
            d = torch.where(is_dup, _INF, d)
            new_i = torch.where(is_dup, -1, new_i)
            pool_d, packed = _bitonic_merge(pool_d, ei, d, new_i, P)
        else:
            sd, si = _sort_pairs(torch.cat([pool_d, d], dim=1),
                                 torch.cat([ei, new_i], dim=1))
            pool_d, packed = sd[:, :P], si[:, :P]
        expanded = packed >= _EXP_BIT
        pool_i = torch.where(packed >= 0, packed & (_EXP_BIT - 1), packed)
        if merge != "bitonic":
            pool_d, pool_i, expanded = _dedup_adjacent(pool_d, pool_i,
                                                       expanded)
        j, take = select(pool_d, pool_i, expanded)
        hops += 1
    if stats is not None:
        stats.setdefault("hops", []).append(hops)
    # final compaction: dedup slots hold (INF, -1); one stable sort pushes
    # them to the tail
    pd, pi = _sort_pairs(pool_d, pool_i)
    return pd, torch.where(pd >= _INF, -1, pi)


def search_graph(g: DeviceGraph, queries: torch.Tensor, *, k: int, ef: int,
                 metric: str = "cosine", max_hops: int = 128,
                 fast_math: bool = False, expand: int = 1,
                 ef_upper: int = 0, device_rerank: bool = True,
                 seed_ids: torch.Tensor | None = None,
                 merge: str = "sort", store_normalized: bool = False,
                 stats: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full hierarchical search for a batch of queries.

    Mirrors Graph.Search's descent (graph.go:571-593): narrow beam with
    result width 1 on upper layers, full (ef, k) beam at layer 0. Returns
    (dists [B, k], slot ids [B, k] int32); -1 = no result.

    ``ef_upper`` is the upper-layer beam width (0 -> an 8-wide pool).
    ``fast_math`` runs hop scoring on bf16-rounded operands. When the
    traversal was approximate (``fast_math`` or an int8 store) and real
    vectors are on the device, the head of the final pool is reranked in
    f32; ``device_rerank=False`` skips that and returns the
    traversal-ordered pool (the capacity modes rerank on the host).
    ``seed_ids`` ([B, S] slot ids, -1 padded) replaces the upper-layer
    descent with pre-selected layer-0 entries. ``store_normalized``: the
    cosine store holds unit rows. ``stats`` collects per-layer hop counts
    (``stats["hops"]``, top layer first; on K5's path ``results_to_host``
    fills it).

    On CUDA the whole search is one launch of the hand-written kernel K5
    (``ops/graph_search``) where ``ops/graph_search.search_kernel_applies``
    holds: every layer, the hand-offs and the rerank in one block a query,
    no host sync. Its hop counts stay on the card as
    ``stats["hops_by_query"]`` ([layers, B] int32) until
    ``results_to_host`` reads them with the results, in one copy, and
    fills ``stats["hops"]``. Every other call runs
    ``search_graph_reference`` (and on CUDA is counted in
    ``ops/graph_search.plain_on_cuda``).
    """
    metric = canonical_metric(metric)
    P0 = max(ef, k)
    P_up = ef_upper if ef_upper > 0 else min(8, P0)
    n_seed = None if seed_ids is None else int(seed_ids.shape[1])
    plan = _graph_kernel.search_kernel_applies(g, metric, queries, P0, P_up,
                                               expand, merge, n_seed)
    if plan is None:
        if queries.is_cuda:
            _graph_kernel.count_plain(g, metric, P0, P_up, expand, merge,
                                      n_seed)
        return search_graph_reference(
            g, queries, k=k, ef=ef, metric=metric, max_hops=max_hops,
            fast_math=fast_math, expand=expand, ef_upper=ef_upper,
            device_rerank=device_rerank, seed_ids=seed_ids, merge=merge,
            store_normalized=store_normalized, stats=stats)
    d, i, hops = _graph_kernel.graph_search_cuda(
        g, queries, plan, k=k, P0=P0, P_up=P_up, expand=expand,
        max_hops=max_hops, metric=metric,
        precision=DEFAULT if fast_math else HIGHEST, merge=merge,
        store_normalized=store_normalized,
        rerank=(device_rerank and (fast_math or g.qvec is not None)
                and g.vectors.shape[0] > 1), seed_ids=seed_ids)
    if stats is not None:
        stats["hops_by_query"] = hops
    return d, i


def results_to_host(d: torch.Tensor, i: torch.Tensor,
                    stats: Optional[dict] = None, hops: bool = True):
    """``search_graph``'s results as numpy arrays (dists, slot ids). Where
    the kernel left its hop counts on the card (``stats["hops_by_query"]``)
    they come back in the same device-to-host copy (one copy of K5's
    output buffer) into ``stats["hops_by_query"]``, and with ``hops``
    ``stats["hops"]`` gets each layer's largest count (``hop_maxima``),
    the lockstep count the plain version reports. ``Graph`` passes
    ``hops=False``: ``last_search_hops`` reduces the counts when read."""
    hq = None if stats is None else stats.get("hops_by_query")
    if hq is None:
        dh, ih = _graph_kernel.to_host(d, i)
    else:
        dh, ih, hq = _graph_kernel.to_host(d, i, hq)
        stats["hops_by_query"] = hq
        if hops:
            stats["hops"] = hop_maxima(hq)
    return dh.numpy(), ih.numpy()


def hop_maxima(hops_by_query: torch.Tensor) -> list:
    """Each layer's largest hop count of K5's [layers, B] counts (zeros
    for an empty batch)."""
    with span("hnsw.results.hops"):
        if hops_by_query.shape[1]:
            return hops_by_query.amax(1).tolist()
        return [0] * hops_by_query.shape[0]


def search_graph_reference(g: DeviceGraph, queries: torch.Tensor, *, k: int,
                           ef: int, metric: str = "cosine",
                           max_hops: int = 128, fast_math: bool = False,
                           expand: int = 1, ef_upper: int = 0,
                           device_rerank: bool = True,
                           seed_ids: torch.Tensor | None = None,
                           merge: str = "sort",
                           store_normalized: bool = False,
                           stats: Optional[dict] = None,
                           touched: Optional[list] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``search_graph`` (the same arguments and results) as a composition
    of one ``beam_search_layer`` a layer: the plain version of K5, and
    what every call off it runs. On CUDA each layer is a K2 launch and its
    hop count a host sync; the f32 rerank is about ten eager launches.
    ``touched`` (a list), when given, gets each layer's
    ``beam_search_layer_reference`` reads (its ``touched`` dict, top layer
    first; the twin runs every layer then) and, where the rerank runs, a
    last dict whose "rows" are the slots it scores: what a roofline bound
    of the whole search reads.
    """
    metric = canonical_metric(metric)
    precision = DEFAULT if fast_math else HIGHEST
    B = queries.shape[0]
    queries = queries.to(torch.float32)
    q_sq = torch.sum(queries * queries, dim=-1)
    L = g.num_layers
    P0 = max(ef, k)
    P_up = ef_upper if ef_upper > 0 else min(8, P0)

    def layer_search(layer, ids, dists, pool):
        kw = dict(pool_size=pool, max_hops=max_hops, metric=metric,
                  precision=precision, expand=min(expand, pool),
                  merge=merge, store_normalized=store_normalized,
                  stats=stats)
        if touched is None:
            return beam_search_layer(g, layer, queries, q_sq, ids, dists,
                                     **kw)
        touched.append({})
        return beam_search_layer_reference(g, layer, queries, q_sq, ids,
                                           dists, touched=touched[-1], **kw)

    if seed_ids is not None:
        safe = torch.clamp(seed_ids, 0, g.cap - 1)
        seed_d = _score_hop(g, queries, q_sq, safe, metric, precision)
        entry_d = torch.where(seed_ids >= 0, seed_d, _INF)
        entry_ids = torch.where(seed_ids >= 0, seed_ids, -1)
    else:
        entry_ids = g.entry.expand(B).to(torch.int32)
        entry_d = _entry_dist(g, queries, q_sq, entry_ids, metric,
                              precision)
        # upper layers: narrow beam, the best becomes the next entry
        # (reference search(1, efSearch) + elevator, graph.go:578-585)
        for layer in range(L - 1, 0, -1):
            pd, pi = layer_search(layer, entry_ids, entry_d, P_up)
            keep = pi[:, 0] >= 0
            entry_ids = torch.where(keep, pi[:, 0], entry_ids)
            entry_d = torch.where(keep, pd[:, 0], entry_d)

    pd, pi = layer_search(0, entry_ids, entry_d, P0)
    if (device_rerank and (fast_math or g.qvec is not None)
            and g.vectors.shape[0] > 1):
        # f32 rerank of the head of the pool: traversal ordering ran on
        # bf16 operands and/or the int8 store; reported distances and the
        # final order are recomputed at HIGHEST over a small widened
        # window. The shape guard: in the int8 capacity mode g.vectors is
        # a [1, D] placeholder, and reranking against it would score
        # every candidate against row 0.
        R = min(P0, max(2 * k, 16))
        ri = pi[:, :R]
        if touched is not None:
            touched.append({"rows": [ri[ri >= 0]]})
        safe = torch.clamp(ri, 0, g.cap - 1).long()
        dd = gathered_dist(queries, g.vectors[safe], g.sq_norms[safe],
                           q_sq, metric=metric, precision=HIGHEST)
        dd = torch.where(ri >= 0, dd, _INF)
        sd, si = _sort_pairs(dd, ri)
        si = torch.where(sd >= _INF, -1, si)
        return sd[:, :k], si[:, :k]
    return pd[:, :k], pi[:, :k]


def pivot_seeds(queries: torch.Tensor, pvecs: torch.Tensor,
                psq: torch.Tensor, pids: torch.Tensor, *, s: int,
                metric: str = "cosine", fast_math: bool = False
                ) -> torch.Tensor:
    """Coarse entry selection: one matmul over a pivot subset.

    queries [B, D] x pvecs [P, D] -> per-query s best pivot SLOT ids
    [B, s] (-1 = none), ties to the lower pivot index. Feeds
    search_graph(seed_ids=...)."""
    metric = canonical_metric(metric)
    precision = DEFAULT if fast_math else HIGHEST
    d = pairwise_dist(queries.to(torch.float32), pvecs, v_sq=psq,
                      metric=metric, precision=precision)     # [B, P]
    dv, j = topk_smallest(d, min(s, d.shape[1]))
    return torch.where(dv < _INF, pids[j], -1)
