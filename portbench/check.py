"""The comparison that decides ``correct``.

Each number is compared with its limit in ``portbench/limits/<cell>.json``
(a number passes at or below its limit):

* ``invalid_answers``: answers (query rows) that break what every answer
  must be: k ids, each in range and each once, with finite distances in
  ascending order. Limit 0.
* ``dist_err``: the widest gap between a returned distance and the
  distance of the returned id worked out again in float64, over every
  answer of the window, on the operands' scale: |d^2 - d_ref^2| /
  (|q|^2 + |x|^2) for l2, |d - d_ref| for cosine (unit rows). It catches
  an id or a distance altered, and distances computed below float32.
* ``walk_diff``: the share of returned ids that the reference's own walk
  of the same graph (``reference.walk``) does not return for that query,
  over every answer of the window. It catches a search that goes another
  way than the configuration's: a lower precision, a narrower beam.
* ``recall_miss``: the share of returned ids that the exact top k of the
  same rows (float64) does not hold, over every answer of the window:
  1 - recall@10. It takes nothing from the program's graph, so it catches
  a build that makes a poorer graph, which ``walk_diff`` follows.
* ``graph_faults``: entries of the built graph that break an HNSW graph's
  rules (``reference.graph_faults``). Limit 0.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import reference


def invalid_rows(d: np.ndarray, ids: np.ndarray, n: int) -> np.ndarray:
    """[B] bool: the answers that break the rules above."""
    ids = np.asarray(ids)
    bad = ((ids < 0) | (ids >= n)).any(1) | ~np.isfinite(d).all(1)
    s = np.sort(ids, axis=1)
    bad |= (s[:, 1:] == s[:, :-1]).any(1)
    bad |= (np.diff(d, axis=1) < 0).any(1)
    return bad


def dist_err(rows: torch.Tensor, queries: torch.Tensor, d: np.ndarray,
             ids: np.ndarray, metric: str) -> float:
    """The widest gap of ``d`` from the reference's distances of ``ids``
    on the operands' scale (see the module); out-of-range ids are left to
    ``invalid_answers``."""
    dev = queries.device
    ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
    ok = (ids_t >= 0) & (ids_t < rows.shape[0])
    ref = reference.distances(rows, queries, ids_t, metric)
    got = torch.as_tensor(np.asarray(d), device=dev).to(torch.float64)
    if metric == "l2":
        x = rows[torch.where(ok, ids_t, 0).reshape(-1)].to(dev)
        x_sq = (x.to(torch.float64) ** 2).sum(-1).reshape(ids_t.shape)
        q_sq = (queries.to(torch.float64) ** 2).sum(-1)[:, None]
        gap = (got ** 2 - ref ** 2).abs() / (q_sq + x_sq)
    else:
        gap = (got - ref).abs()
    gap = torch.where(ok, gap, 0.0)
    if not bool(torch.isfinite(gap).all()):
        return float("inf")
    return float(gap.max()) if gap.numel() else 0.0


def walk_misses(ids: np.ndarray, ref_ids: np.ndarray) -> int:
    """The entries of ``ids`` that ``ref_ids``' rows do not hold."""
    ids = np.asarray(ids)
    same = (ids[:, :, None] == np.asarray(ref_ids)[:, None, :]).any(-1)
    return int(ids.size - (same & (ids >= 0)).sum())


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]], List[str]]:
    """(correct, {name: {"value", "limit"}}, one line a number): each
    number against its limit; a number with no limit, or a limit with no
    number, is not correct."""
    out, ok = {}, set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        out[name] = {"value": v, "limit": lim}
        ok &= v is not None and lim is not None and v <= lim
    lines = [f"check {n}: {r['value']!r} (limit {r['limit']!r})"
             for n, r in out.items()]
    return bool(ok), out, lines
