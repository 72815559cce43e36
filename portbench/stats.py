"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def cut_batches(traffic: dict, n_pool: int, seed: int) -> List[np.ndarray]:
    """The pool indices of each batch the traffic mix sends, cut in
    advance: ``batches`` draws of ``batch`` distinct queries of the pool,
    each a seeded permutation's head."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    size = int(traffic["batch"])
    if size > n_pool:
        raise ValueError(f"batch {size} is larger than the pool {n_pool}")
    return [rng.permutation(n_pool)[:size]
            for _ in range(int(traffic["batches"]))]


def qps(queries: int, window_s: float) -> float:
    """Every query completed in the window over the window's seconds."""
    return queries / window_s


def p95_ms(latencies_s: Sequence[float]) -> float:
    """The 95th percentile (linear between order statistics) of every
    call's latency, in ms."""
    return float(np.percentile(np.asarray(latencies_s, np.float64), 95)
                 * 1e3)


def hits(ids: np.ndarray, truth: np.ndarray) -> int:
    """The ids of each row of ``ids`` that its row of ``truth`` holds,
    summed (-1 never counts)."""
    ids = np.asarray(ids)
    same = (ids[:, :, None] == np.asarray(truth)[:, None, :]).any(-1)
    return int((same & (ids >= 0)).sum())

