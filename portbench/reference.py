"""The plain reference: plain PyTorch in float64, frozen here.

It imports nothing of the program under test and takes nothing it made,
apart from the graph that ``walk`` follows (see there). It gives:

* ``exact_topk``: the exact k nearest rows of each query (brute force);
* ``distances``: each returned id's distance, worked out again;
* ``walk``: the graph search the configuration states, over a graph's
  public arrays, with the distinct rows and neighbour lists it reads and
  the candidates it scores;
* ``graph_faults``: what is wrong with a graph's arrays as an HNSW graph.

Distances: ``l2`` is the Euclidean distance, ``cosine`` is 1 - cos.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
INF = float("inf")
METRICS = ("l2", "cosine")


def prepare(x: torch.Tensor, metric: str) -> torch.Tensor:
    """``x`` in float64, rows normalised to unit length for cosine."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    x = x.to(F64)
    if metric == "cosine":
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x


def _finish(sq_or_dot: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "l2":
        return torch.sqrt(torch.clamp_min(sq_or_dot, 0.0))
    return 1.0 - sq_or_dot


def exact_topk(rows: torch.Tensor, queries: torch.Tensor, k: int,
               metric: str, q_block: int = 1024, r_block: int = 1 << 18
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances [Q, k] float64, ids [Q, k] int64): each query's k
    nearest rows by brute force, ascending, on the rows' device. Rows and
    queries go through ``prepare`` a block at a time."""
    out_d, out_i = [], []
    n = rows.shape[0]
    for q0 in range(0, queries.shape[0], q_block):
        q = prepare(queries[q0:q0 + q_block], metric)
        best_d = torch.full((q.shape[0], 0), INF, dtype=F64, device=q.device)
        best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                             device=q.device)
        for r0 in range(0, n, r_block):
            r = prepare(rows[r0:r0 + r_block].to(q.device), metric)
            dot = q @ r.T
            if metric == "l2":
                key = ((q * q).sum(1)[:, None] + (r * r).sum(1)[None, :]
                       - 2.0 * dot)
            else:
                key = -dot
            kk = min(k, key.shape[1])
            d, i = torch.topk(key, kk, dim=1, largest=False)
            best_d = torch.cat([best_d, d], 1)
            best_i = torch.cat([best_i, i + r0], 1)
            best_d, j = torch.topk(best_d, min(k, best_d.shape[1]), dim=1,
                                   largest=False)
            best_i = torch.gather(best_i, 1, j)
        out_d.append(_finish(best_d if metric == "l2" else -best_d, metric))
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def distances(rows: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
              metric: str) -> torch.Tensor:
    """[B, k] float64: the distance of each query ``queries[b]`` to row
    ``ids[b, j]``, taken directly ((x - q)^2 summed, or the dot of unit
    rows); NaN where the id is out of range."""
    ok = (ids >= 0) & (ids < rows.shape[0])
    safe = torch.where(ok, ids, 0)
    x = prepare(rows[safe.reshape(-1)].to(queries.device), metric)
    x = x.reshape(*ids.shape, -1)
    q = prepare(queries, metric)[:, None, :]
    if metric == "l2":
        d = _finish(((x - q) ** 2).sum(-1), metric)
    else:
        d = _finish((x * q).sum(-1), metric)
    return torch.where(ok, d, torch.nan)


class GraphArrays:
    """A graph as the search reads it: ``neighbors[l]`` the [n, W]
    neighbour ids of layer ``l`` (-1 = none), of which a node may use the
    first ``widths[l]`` (M0 on layer 0, M above), ``levels`` [n] each
    node's top layer, ``entry`` the node where every search starts."""

    def __init__(self, neighbors: List[torch.Tensor], widths: List[int],
                 levels: torch.Tensor, entry: int):
        self.neighbors = neighbors
        self.widths = widths
        self.levels = levels
        self.entry = int(entry)

    @property
    def n(self) -> int:
        return int(self.levels.shape[0])


def graph_faults(g: GraphArrays) -> int:
    """How many entries break the HNSW graph's rules: a neighbour past the
    layer's width, a neighbour id out of range, a node its own neighbour,
    an id twice in one list, a node with neighbours on a layer above its
    level, a neighbour on layer ``l`` whose level is below ``l``, a node
    with no neighbour on layer 0 (in a graph of more than one node), an
    entry that is not on the top layer."""
    n, faults = g.n, 0
    node = torch.arange(n, device=g.levels.device)[:, None]
    for layer, nb in enumerate(g.neighbors):
        nb = nb.long()
        faults += int((nb[:, g.widths[layer]:] >= 0).sum())
        nb = nb[:, :g.widths[layer]]
        valid = nb >= 0
        faults += int((nb >= n).sum())
        valid &= nb < n
        faults += int((valid & (nb == node)).sum())
        s = torch.sort(torch.where(valid, nb, -1), dim=1).values
        faults += int(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).sum())
        faults += int((valid.any(1) & (g.levels < layer)).sum())
        lv = g.levels[torch.where(valid, nb, 0)]
        faults += int((valid & (lv < layer)).sum())
        if layer == 0 and n > 1:
            faults += int((~valid.any(1)).sum())
    top = len(g.neighbors) - 1
    if not (0 <= g.entry < n) or int(g.levels[g.entry]) != top:
        faults += 1
    return faults


def _score(rows_p: torch.Tensor, q_p: torch.Tensor, ids: torch.Tensor,
           metric: str) -> torch.Tensor:
    """Distances [B, C] from prepared queries to prepared rows ``ids``."""
    x = rows_p[ids.reshape(-1)].reshape(*ids.shape, -1)
    if metric == "l2":
        return _finish(((x - q_p[:, None, :]) ** 2).sum(-1), metric)
    return _finish((x * q_p[:, None, :]).sum(-1), metric)


def walk(g: GraphArrays, rows_p: torch.Tensor, queries: torch.Tensor, *,
         metric: str, k: int, ef: int, ef_upper: int, expand: int,
         max_hops: int, counts: Optional[Dict] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The search the configuration states (Malkov & Yashunin 2018,
    Algorithm 2, as the program specifies it) for every query, in
    lockstep: from the entry, a beam of ``min(ef_upper, P)`` on each upper
    layer whose best entry starts the next layer, then a beam of P =
    max(ef, k) on layer 0, whose first k are the answer. A beam is a pool
    of its best P candidates, sorted; each hop expands the ``expand`` best
    entries not yet expanded that are better than the pool's worst (an
    unfilled slot is worse than any), scores their neighbours that are not
    in the pool (each once) and keeps the best P of pool and candidates.
    A query stops when it expands nothing, or after ``max_hops`` hops a
    layer. ``rows_p`` are ``prepare``'d rows on the queries' device.

    Returns (distances [B, k] float64, ids [B, k] int64; -1 past the
    candidates found). With ``counts`` (a dict) it adds, for each layer
    searched, top first, (width, distinct nodes expanded, distinct rows
    scored, candidates scored) over the whole batch to ``counts["layers"]``
    and the entry's rows and scores to ``counts["entry_rows"]`` and
    ``counts["entry_scored"]``.
    """
    dev = queries.device
    q_p = prepare(queries, metric)
    B = q_p.shape[0]
    entry = torch.full((B,), g.entry, dtype=torch.int64, device=dev)
    entry_d = _score(rows_p, q_p, entry[:, None], metric)[:, 0]
    if counts is not None:
        counts.setdefault("layers", [])
        counts["entry_rows"] = 1
        counts["entry_scored"] = B
    P0 = max(ef, k)
    for layer in range(len(g.neighbors) - 1, 0, -1):
        d, i = _layer(g, layer, rows_p, q_p, entry, entry_d,
                      min(ef_upper, P0), expand, max_hops, metric, counts)
        keep = i[:, 0] >= 0
        entry = torch.where(keep, i[:, 0], entry)
        entry_d = torch.where(keep, d[:, 0], entry_d)
    d, i = _layer(g, 0, rows_p, q_p, entry, entry_d, P0, expand, max_hops,
                  metric, counts)
    return d[:, :k], i[:, :k]


def _layer(g: GraphArrays, layer: int, rows_p, q_p, start, start_d, P: int,
           expand: int, max_hops: int, metric: str, counts):
    W = g.widths[layer]
    nb = g.neighbors[layer][:, :W]
    B = q_p.shape[0]
    E = max(1, min(expand, P))
    dev = q_p.device
    pool_i = torch.full((B, P), -1, dtype=torch.int64, device=dev)
    pool_d = torch.full((B, P), INF, dtype=F64, device=dev)
    pool_i[:, 0], pool_d[:, 0] = start, start_d
    expanded = torch.zeros((B, P), dtype=torch.bool, device=dev)
    tri = torch.tril(torch.ones((E * W, E * W), dtype=torch.bool,
                                device=dev), diagonal=-1)
    seen_nodes = torch.zeros(g.n, dtype=torch.bool, device=dev)
    seen_rows = torch.zeros(g.n, dtype=torch.bool, device=dev)
    scored = 0
    for _ in range(max_hops):
        sel = torch.where(expanded | (pool_i < 0), INF, pool_d)
        best, j = torch.topk(sel, E, dim=1, largest=False)
        take = best < pool_d.max(dim=1).values[:, None]
        if not bool(take.any()):
            break
        cur = torch.gather(pool_i, 1, j)
        expanded.scatter_(1, j, torch.gather(expanded, 1, j) | take)
        nbrs = nb[torch.where(take, cur, 0)].long().reshape(B, E * W)
        ok = (nbrs >= 0) & take.repeat_interleave(W, dim=1)
        ok &= ~(nbrs[:, :, None] == pool_i[:, None, :]).any(-1)
        cand = torch.where(ok, nbrs, -1)
        ok &= ~((cand[:, :, None] == cand[:, None, :]) & tri).any(-1)
        cand = torch.where(ok, nbrs, -1)
        cd = torch.where(ok, _score(rows_p, q_p, torch.where(ok, cand, 0),
                                    metric), INF)
        if counts is not None:
            seen_nodes[cur[take]] = True
            seen_rows[cand[ok]] = True
            scored += int(ok.sum())
        all_d = torch.cat([pool_d, cd], 1)
        all_i = torch.cat([pool_i, cand], 1)
        all_e = torch.cat([expanded, torch.zeros_like(ok)], 1)
        all_d, pos = torch.sort(all_d, dim=1, stable=True)
        pool_d = all_d[:, :P]
        pool_i = torch.gather(all_i, 1, pos[:, :P])
        expanded = torch.gather(all_e, 1, pos[:, :P])
    if counts is not None:
        counts["layers"].append((W, int(seen_nodes.sum()),
                                 int(seen_rows.sum()), scored))
    return pool_d, torch.where(pool_d < INF, pool_i, -1)
