"""Bulk batched graph construction (port of hnsw_tpu/core/build.py).

The reference inserts strictly sequentially (each Add searches the graph
containing all previous nodes, graph.go:437-531). This module builds in
WAVES:

  1. sample all insertion levels up front (same geometric law,
     maxLevel cap evaluated at each node's sequential position);
  2. per wave of W nodes: ONE batched descent over the pre-wave graph
     snapshot (construction_descent: per layer, a lockstep beam search
     on the device) yields every wave node's top-M layer candidates;
  3. intra-wave k-NN (one W x W matmul) supplies candidates among nodes
     of the same wave;
  4. edge assembly: wave rows = diversity-selected top-M of (snapshot ∪
     intra-wave) candidates; reverse edges applied with worst-distance
     eviction in one grouped pass (batch_reverse_insert).

Wave nodes do not observe each other's edges mid-wave, and evictees are
not replenished during bulk build (delete repair still replenishes).

The device functions take torch tensors and run on the tensors' device.
``construction_descent`` scores at DEFAULT (bf16-rounded operands, f32
sums: ops/distance.py) like the JAX package; the candidate distances
that rank edge selection are computed at HIGHEST. The selection itself
(``_diverse_select_dev``) is one launch of the CUDA kernel K4
(ops/diverse_select) on the card. ``bulk_insert`` and
``batch_reverse_insert`` are the host-authoritative wave builder (numpy
glue around the same device functions); core/build_device.py is the
device-resident one that Graph.build uses.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import canonical_metric
from hnsw_tpu_torch.core import host_build
from hnsw_tpu_torch.core.search import beam_search_layer
from hnsw_tpu_torch.core.state import (DeviceGraph, bucket_pow2,
                                      default_device, from_host)
from hnsw_tpu_torch.ops import diverse_select as _select
from hnsw_tpu_torch.ops.distance import (DEFAULT, HIGHEST, INF_DIST,
                                         bf16_round, gathered_dist,
                                         pairwise_dist)

_INF = float(INF_DIST)


def construction_descent(g: DeviceGraph, queries: torch.Tensor, *, ef: int,
                         m_out: int, metric: str, max_hops: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched insert-search: descend all layers for W wave vectors.

    Every layer is searched with a pool of ``ef`` at DEFAULT precision,
    expanding 4 pool entries a hop. Returns (cand_d, cand_i) of shape
    [L, W, m_out]: per layer, each wave node's nearest m_out snapshot
    nodes (the "neighborhood" of graph.go:500, batched) that belong to
    that layer (level >= layer; others are -1 / INF_DIST). Above the
    entry's own level the pool holds only the entry, which is not a
    member there; the JAX package returns it, and edges to it break the
    layer-membership invariant (ROADMAP Queue 3, fault F9)."""
    metric = canonical_metric(metric)
    queries = queries.to(torch.float32)
    q_sq = torch.sum(queries * queries, dim=-1)
    W = queries.shape[0]

    entry_ids = g.entry.expand(W).to(torch.int32)
    safe = torch.clamp(entry_ids, 0, g.cap - 1).long()
    entry_d = gathered_dist(queries, g.vectors[safe][:, None, :],
                            g.sq_norms[safe][:, None], q_sq, metric=metric,
                            precision=DEFAULT)[:, 0]
    entry_d = torch.where(entry_ids >= 0, entry_d, _INF)

    outs_d, outs_i = [], []
    for layer in range(g.num_layers - 1, -1, -1):
        pd, pi = beam_search_layer(g, layer, queries, q_sq, entry_ids,
                                   entry_d, pool_size=ef, max_hops=max_hops,
                                   metric=metric, precision=DEFAULT,
                                   expand=4)
        member = (pi >= 0) & (g.levels[torch.clamp(pi, 0, g.cap - 1).long()]
                              >= layer)
        outs_d.append(torch.where(member, pd, _INF)[:, :m_out])
        outs_i.append(torch.where(member, pi, -1)[:, :m_out])
        keep = pi[:, 0] >= 0
        entry_ids = torch.where(keep, pi[:, 0], entry_ids)
        entry_d = torch.where(keep, pd[:, 0], entry_d)
    # outs are top-down; reorder to layer index order [0..L-1]
    outs_d.reverse()
    outs_i.reverse()
    return torch.stack(outs_d), torch.stack(outs_i)


def _cand_dist_dev(vectors: torch.Tensor, sq: torch.Tensor,
                   anchors: torch.Tensor, others: torch.Tensor,
                   metric: str) -> torch.Tensor:
    """dist(vectors[anchors[u]], vectors[others[u, k]]) -> [U, K] at
    HIGHEST precision; -1 entries in ``anchors`` or ``others`` yield
    INF_DIST."""
    n = vectors.shape[0]
    safe_a = torch.clamp(anchors, 0, n - 1).long()
    safe_o = torch.clamp(others, 0, n - 1).long()
    d = gathered_dist(vectors[safe_a], vectors[safe_o], sq[safe_o],
                      sq[safe_a], metric=metric, precision=HIGHEST)
    return torch.where((others >= 0) & (anchors[:, None] >= 0), d, _INF)


def _diverse_select_dev(cand_i: torch.Tensor, cand_d: torch.Tensor,
                        vectors: torch.Tensor, sq: torch.Tensor, *,
                        deg: int, metric: str,
                        diversify: bool) -> torch.Tensor:
    """Device version of diverse_select (see that docstring): sort by
    distance, dedup, Malkov-heuristic scan, pruned backfill, compact.

    cand_i [P, C] int32 (-1 pad), cand_d [P, C] f32 (INF_DIST on pads)
    -> rows [P, min(C, deg)] int32, -1 padded. One launch of the CUDA
    kernel K4 (ops/diverse_select) where
    ``ops/diverse_select.select_kernel_applies``; every other call (the
    CPU, a registered metric) runs the twin ``_diverse_select_reference``
    (same arguments, same rows), counted by reason on CUDA."""
    kw = dict(metric=metric, diversify=diversify)
    if cand_i.is_cuda:
        if _select.select_kernel_applies(cand_i, cand_d, vectors, sq, **kw):
            return _select.diverse_select_cuda(cand_i, cand_d, vectors, sq,
                                               deg=deg, **kw)
        _select.count_plain(cand_i, vectors, **kw)
    return _diverse_select_reference(cand_i, cand_d, vectors, sq, deg=deg,
                                     **kw)


def _diverse_select_reference(cand_i: torch.Tensor, cand_d: torch.Tensor,
                              vectors: torch.Tensor, sq: torch.Tensor, *,
                              deg: int, metric: str,
                              diversify: bool) -> torch.Tensor:
    """The plain twin of ``_diverse_select_dev`` (K4): sort by distance,
    dedup, Malkov-heuristic scan, pruned backfill, compact, as eager
    PyTorch.

    The [P, C, C] candidate Gram runs at DEFAULT (bf16-rounded operands,
    f32 sums). The heuristic scan is C serial steps (each depends on what
    the earlier ones kept); the backfill is an exclusive cumsum: it takes
    valid, unselected candidates in distance order while the row has
    room. No NaN may reach it: pads are INF_DIST, and a NaN sorts apart
    from where the JAX package and the kernel would put it."""
    assert not torch.isnan(cand_d).any(), "NaN candidate distance"
    P, C = cand_i.shape
    cd, order = torch.sort(cand_d, dim=1, stable=True)
    ci = torch.gather(cand_i, 1, order)
    dup = torch.tril(ci[:, :, None] == ci[:, None, :], diagonal=-1)
    dup = dup.any(dim=2) & (ci >= 0)
    cd = torch.where(dup, _INF, cd)
    valid = (cd < _INF) & (ci >= 0)

    if not diversify:
        return torch.where(valid[:, :deg], ci[:, :deg], -1)

    safe = torch.clamp(ci, 0, vectors.shape[0] - 1).long()
    pv = bf16_round(vectors[safe].to(torch.float32))     # [P, C, D]
    gram = torch.einsum("pcd,ped->pce", pv, pv)
    s = sq[safe]
    if metric == "cosine":
        pd = 1.0 - gram * torch.rsqrt(s[:, :, None] * s[:, None, :] + 1e-30)
    elif metric == "dot":
        pd = -gram
    else:
        pd = torch.clamp_min(s[:, :, None] + s[:, None, :] - 2.0 * gram, 0.0)
        if metric == "l2":
            pd = torch.sqrt(pd)
    # conflict[p, j, e]: kept candidate e is closer to j than j is to the
    # node, so j is pruned if e was kept
    conflict = pd < cd[:, :, None]

    sel = torch.zeros((P, C), dtype=torch.bool, device=ci.device)
    count = torch.zeros((P,), dtype=torch.int32, device=ci.device)
    for j in range(C):
        clash = (conflict[:, j, :] & sel).any(dim=1)
        take = valid[:, j] & ~clash & (count < deg)
        sel[:, j] = take
        count += take

    # keepPrunedConnections backfill
    cand = valid & ~sel
    before = torch.cumsum(cand.to(torch.int32), dim=1) - cand.to(torch.int32)
    sel = sel | (cand & (count[:, None] + before < deg))

    idx = torch.sort((~sel).to(torch.int8), dim=1, stable=True).indices
    sel_s = torch.gather(sel, 1, idx)[:, :deg]
    ci_s = torch.gather(ci, 1, idx)[:, :deg]
    return torch.where(sel_s, ci_s, -1)


def _np_dist_rows(vectors: np.ndarray, sq: np.ndarray, a: np.ndarray,
                  b: np.ndarray, metric: str) -> np.ndarray:
    """Pairwise distances between vectors[a[i]] and vectors[b[i]] (same
    shape index arrays, any dims)."""
    va = vectors[a]
    vb = vectors[b]
    ab = np.einsum("...d,...d->...", va, vb)
    if metric == "dot":
        return -ab
    sa = sq[a]
    sb = sq[b]
    if metric == "cosine":
        return 1.0 - ab / np.sqrt(sa * sb + 1e-30)
    d = np.maximum(sa + sb - 2.0 * ab, 0.0)
    if metric == "sqeuclidean":
        return d
    return np.sqrt(d)


def diverse_select(cand_i: np.ndarray, cand_d: np.ndarray,
                   vectors: np.ndarray, sq: np.ndarray, deg: int,
                   metric: str, diversify: bool = True) -> np.ndarray:
    """Vectorized neighbor selection for a batch of P nodes.

    With ``diversify`` (Malkov's Algorithm 4, the standard HNSW
    heuristic the reference omits): walk candidates nearest-first, keep
    one only if it is closer to the query node than to every
    already-kept neighbor, then backfill with pruned candidates. All P
    rows are processed in lockstep with one [P, C, C] distance block.

    cand_i [P, C] (-1 pad), cand_d [P, C] (inf on pads).
    Returns rows [P, deg] of selected ids, -1 padded.
    """
    order = np.argsort(cand_d, axis=1, kind="stable")
    ci = np.take_along_axis(cand_i, order, axis=1)
    cd = np.take_along_axis(cand_d, order, axis=1)
    # drop duplicate candidate ids within a row (keep nearest occurrence)
    P, C = ci.shape
    dup = np.zeros((P, C), bool)
    for j in range(1, C):
        dup[:, j] = (ci[:, j:j + 1] == ci[:, :j]).any(axis=1) & (ci[:, j] >= 0)
    cd = np.where(dup, np.inf, cd)
    valid = np.isfinite(cd) & (ci >= 0)

    if not diversify:
        out = np.where(valid[:, :deg], ci[:, :deg], -1)
        if out.shape[1] < deg:
            out = np.pad(out, ((0, 0), (0, deg - out.shape[1])),
                         constant_values=-1)
        return out

    safe = np.where(ci >= 0, ci, 0)
    pv = vectors[safe].astype(np.float32)            # [P, C, D]
    gram = np.einsum("pcd,ped->pce", pv, pv)
    s = sq[safe].astype(np.float32)
    if metric == "cosine":
        pd = 1.0 - gram / np.sqrt(s[:, :, None] * s[:, None, :] + 1e-30)
    elif metric == "dot":
        pd = -gram
    else:
        pd = np.maximum(s[:, :, None] + s[:, None, :] - 2.0 * gram, 0.0)
        if metric == "l2":
            pd = np.sqrt(pd)

    sel = np.zeros((P, C), bool)
    count = np.zeros(P, np.int64)
    for j in range(C):
        no_conflict = np.all(~sel | (pd[:, j, :] >= cd[:, j, None]), axis=1)
        take = valid[:, j] & no_conflict & (count < deg)
        sel[:, j] = take
        count += take
    for j in range(C):  # keepPrunedConnections backfill
        take = valid[:, j] & ~sel[:, j] & (count < deg)
        sel[:, j] |= take
        count += take

    # compact selected (they are in ascending-distance order already)
    idx = np.argsort(~sel, axis=1, kind="stable")
    sel_s = np.take_along_axis(sel, idx, axis=1)[:, :deg]
    ci_s = np.take_along_axis(ci, idx, axis=1)[:, :deg]
    out = np.where(sel_s, ci_s, -1)
    if out.shape[1] < deg:
        out = np.pad(out, ((0, 0), (0, deg - out.shape[1])),
                     constant_values=-1)
    return out


def _dev_pair_dist(dev_vectors: torch.Tensor, dev_sq: torch.Tensor,
                   a: np.ndarray, b: np.ndarray, metric: str) -> np.ndarray:
    """dist(a[i], b[i]) for index vectors, computed on the device."""
    dev = dev_vectors.device
    ta = torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    tb = torch.from_numpy(np.asarray(b, np.int64)[:, None]).to(dev)
    d = _cand_dist_dev(dev_vectors, dev_sq, ta, tb, metric)
    return d[:, 0].cpu().numpy().astype(np.float64)


def _dev_row_dist(dev_vectors: torch.Tensor, dev_sq: torch.Tensor,
                  anchors: np.ndarray, others: np.ndarray,
                  metric: str) -> np.ndarray:
    """dist(anchors[u], others[u, k]) -> [U, K] on the device."""
    dev = dev_vectors.device
    d = _cand_dist_dev(dev_vectors, dev_sq,
                       torch.from_numpy(np.asarray(anchors, np.int64)).to(dev),
                       torch.from_numpy(np.asarray(others, np.int64)).to(dev),
                       metric)
    return d.cpu().numpy().astype(np.float64)


def batch_reverse_insert(neigh_l: np.ndarray, vectors: torch.Tensor,
                         sq: torch.Tensor, tgt: np.ndarray, src: np.ndarray,
                         m: int, metric: str,
                         diversify: bool = True) -> None:
    """Vectorized reverse-edge application with worst-distance eviction.

    For every (tgt, src) pair, src enters tgt's neighbor row; when a row
    exceeds the degree cap ``m``, the farthest entries are evicted — the
    batched version of addNeighbor's eviction rule (graph.go:41-81),
    minus the evictee replenish (bulk-build deviation, see module
    docstring). ``m`` is the LAYER's degree cap and may be smaller than
    the physical row width. ``vectors``/``sq`` are DEVICE tensors; all
    distance math runs on the device, only grouping stays on host.
    """
    if len(tgt) == 0:
        return
    big = _INF / 2
    d = _dev_pair_dist(vectors, sq, tgt, src, metric)
    # Rank incoming edges within each target; keep the best m per target.
    order = np.lexsort((d, tgt))
    tgt_s, src_s, d_s = tgt[order], src[order], d[order]
    new_grp = np.r_[True, tgt_s[1:] != tgt_s[:-1]]
    grp_id = np.cumsum(new_grp) - 1
    grp_start = np.flatnonzero(new_grp)
    rank = np.arange(len(tgt_s)) - grp_start[grp_id]
    keep = rank < m
    tgt_s, src_s, d_s, grp_id, rank = (tgt_s[keep], src_s[keep], d_s[keep],
                                       grp_id[keep], rank[keep])
    uniq = tgt_s[np.r_[True, tgt_s[1:] != tgt_s[:-1]]]
    U = len(uniq)
    inc = np.full((U, m), -1, np.int64)
    inc_d = np.full((U, m), np.inf, np.float64)
    inc[grp_id, rank] = src_s
    inc_d[grp_id, rank] = d_s

    existing = neigh_l[uniq].astype(np.int64)          # [U, row_w]
    ex_d = _dev_row_dist(vectors, sq, uniq, existing, metric)
    # Dedup: drop incoming that already sit in the row.
    dup = (inc[:, :, None] == existing[:, None, :]).any(-1) & (inc >= 0)
    inc_d = np.where(dup, np.inf, inc_d)

    comb = np.concatenate([existing, inc], axis=1)      # [U, row_w + m]
    comb_d = np.concatenate([ex_d, inc_d], axis=1)
    row_w = neigh_l.shape[1]
    out = np.full((U, row_w), -1, np.int64)
    if diversify:
        # heuristic re-selection on overflow (hnswlib applies the same
        # rule in mutuallyConnectNewElement); chunked to bound the
        # [chunk, C, C] device block
        dev = vectors.device
        for c0 in range(0, U, 8192):
            c1 = min(c0 + 8192, U)
            ci = torch.from_numpy(comb[c0:c1].astype(np.int32)).to(dev)
            cd = torch.from_numpy(np.minimum(comb_d[c0:c1], _INF)
                                  .astype(np.float32)).to(dev)
            rows = _diverse_select_dev(ci, cd, vectors, sq, deg=m,
                                       metric=metric, diversify=True)
            out[c0:c1, :rows.shape[1]] = rows.cpu().numpy()
    else:
        part = np.argpartition(comb_d, m - 1, axis=1)[:, :m]
        rows = np.take_along_axis(comb, part, axis=1)
        rows_d = np.take_along_axis(comb_d, part, axis=1)
        out[:, :m] = np.where(rows_d < big, rows, -1)
    neigh_l[uniq] = out.astype(np.int32)


def bulk_insert(host: host_build.HostGraph, slots: np.ndarray, *,
                wave: int = 1024, intra_k: Optional[int] = None,
                device=None) -> None:
    """Insert ``slots`` (already in the vector store) into the host graph
    by device-batched waves on ``device`` (default: the CUDA device; raises
    without one, pass ``device="cpu"`` for the CPU). Mutates host arrays
    in place."""
    cfg = host.cfg
    metric = host.metric
    intra_k = intra_k if intra_k is not None else cfg.m_base
    store = host.store
    device = torch.device(device) if device is not None \
        else default_device()

    slots = np.asarray(slots, np.int64)
    n_new = len(slots)
    if n_new == 0:
        return
    # Levels sampled at each node's sequential position (graph.go:400:
    # cap depends on the CURRENT base-layer size).
    base = host.count
    levels = np.empty(n_new, np.int32)
    for i in range(n_new):
        cap_lvl = host_build.max_level(cfg.ml, base + i)
        lvl = 0
        while lvl < cap_lvl and host.rng.random() <= cfg.ml:
            lvl += 1
        levels[i] = lvl

    start = 0
    if host.entry < 0:  # bootstrap
        host._ensure(int(slots[0]), int(levels[0]))
        host.levels[slots[0]] = levels[0]
        host.count += 1
        host.entry, host.top = int(slots[0]), int(levels[0])
        start = 1

    host._ensure(int(slots.max()), int(levels.max()))
    ncap = host.neighbors.shape[1]
    store.ensure_capacity(ncap)
    vectors_all = store.vectors[:ncap]
    sq_all = store.sq_norms[:ncap]
    n_cand = min(cfg.ef_construction, 2 * cfg.m_base)

    # Wave-size ramp: a wave never exceeds the current graph size, so
    # early nodes are inserted against a meaningful snapshot instead of
    # forming one giant intra-wave kNN blob.
    w0 = start
    while w0 < n_new:
        cur_wave = min(wave, max(256, bucket_pow2(host.count)))
        w1 = min(w0 + cur_wave, n_new)
        wslots = slots[w0:w1]
        wlevels = levels[w0:w1]
        W = len(wslots)
        snap_top = host.top

        # --- device: batched descent over the snapshot ------------------
        # only nodes inserted so far are searchable; all layers uploaded
        # (empty upper layers are inert: the entry's row there is all -1)
        inserted = host.levels[:ncap] >= 0
        dev = from_host(vectors_all, sq_all, host.neighbors,
                        host.levels[:ncap], inserted, host.entry,
                        cap_pad=bucket_pow2(ncap), device=device)
        wq = torch.from_numpy(np.ascontiguousarray(
            vectors_all[wslots], np.float32)).to(device)
        # a wider candidate slate than the degree gives the diversity
        # heuristic material to choose from
        cand_d, cand_i = construction_descent(
            dev, wq, ef=max(cfg.ef_construction, n_cand), m_out=n_cand,
            metric=metric, max_hops=cfg.max_hops)
        cand_d = cand_d.cpu().numpy()        # [L_all, W, n_cand]
        cand_i = cand_i.cpu().numpy()

        # --- intra-wave candidates (one W x W distance block) -----------
        intra_d = pairwise_dist(wq, wq, metric=metric).cpu().numpy() \
            .astype(np.float64)
        np.fill_diagonal(intra_d, np.inf)

        max_l = int(max(wlevels.max(initial=0), snap_top))
        C_max = n_cand + intra_k            # fixed candidate width
        rev_t: List[np.ndarray] = []
        rev_s: List[np.ndarray] = []
        rev_layers: List[int] = []
        for layer in range(0, max_l + 1):
            part = np.flatnonzero(wlevels >= layer)
            if len(part) == 0:
                continue
            deg = cfg.max_degree(layer)
            P = len(part)
            comb_i = np.full((P, C_max), -1, np.int64)
            comb_d = np.full((P, C_max), np.inf)
            # snapshot candidates at this layer
            sc_i = cand_i[layer][part].astype(np.int64)       # [P, n_cand]
            sc_d = cand_d[layer][part].astype(np.float64)
            sc_d = np.where(sc_i >= 0, sc_d, np.inf)
            comb_i[:, :n_cand] = sc_i
            comb_d[:, :n_cand] = sc_d
            # intra-wave candidates at this layer
            in_layer = wlevels >= layer
            iw = intra_d[np.ix_(part, np.flatnonzero(in_layer))]
            iw_slots = wslots[in_layer]
            kk = min(intra_k, iw.shape[1])
            if kk > 0:
                sel = np.argpartition(iw, kk - 1, axis=1)[:, :kk]
                iw_d = np.take_along_axis(iw, sel, axis=1)
                iw_i = np.where(np.isfinite(iw_d), iw_slots[sel], -1)
                comb_i[:, n_cand:n_cand + kk] = iw_i
                comb_d[:, n_cand:n_cand + kk] = iw_d

            row_i = _diverse_select_dev(
                torch.from_numpy(comb_i.astype(np.int32)).to(device),
                torch.from_numpy(np.minimum(comb_d, _INF)
                                 .astype(np.float32)).to(device),
                dev.vectors, dev.sq_norms, deg=deg, metric=metric,
                diversify=cfg.diversify).cpu().numpy().astype(np.int64)
            # set wave rows (-1 padded to the m_base row width)
            rows = np.full((P, host.neighbors.shape[2]), -1, np.int32)
            rows[:, :row_i.shape[1]] = row_i.astype(np.int32)
            host.neighbors[layer][wslots[part]] = rows
            # collect reverse edges
            e_mask = row_i >= 0
            rev_t.append(row_i[e_mask])
            rev_s.append(np.repeat(wslots[part], e_mask.sum(axis=1)))
            rev_layers.append(layer)

        # --- reverse edges with eviction, grouped per layer ---------------
        for layer, t, s in zip(rev_layers, rev_t, rev_s):
            batch_reverse_insert(host.neighbors[layer], dev.vectors,
                                 dev.sq_norms, t, s,
                                 cfg.max_degree(layer), metric,
                                 diversify=cfg.diversify)

        # --- commit wave --------------------------------------------------
        host.levels[wslots] = wlevels
        host.count += W
        wmax = int(wlevels.max())
        if wmax > host.top:
            host.top = wmax
            host.entry = int(wslots[int(np.argmax(wlevels))])
        w0 = w1
