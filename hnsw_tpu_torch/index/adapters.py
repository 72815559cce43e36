"""Index protocol + composition adapters (port of
hnsw_tpu/index/adapters.py).

The reference needs four adapter classes (hybrid/adapter.go:12,92,165,
213) because its sub-indexes expose different Go interfaces. Here every
index (ExactIndex, Graph, LSHIndex, HybridIndex, AdaptiveHybridIndex)
already speaks one duck-typed protocol, so only the genuinely useful
composition survives: MultiIndexAdapter — fan-out search over several
indexes with merge + dedup (adapter.go:257-308).
"""

from __future__ import annotations

from typing import (Any, Hashable, List, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np


@runtime_checkable
class SearchableIndex(Protocol):
    """The shared index protocol (hybrid/hybrid.go:15-60)."""

    def add(self, key: Hashable, vector) -> None: ...

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None: ...

    def search(self, query, k: int) -> List[Tuple[Any, float]]: ...

    def delete(self, key: Hashable) -> bool: ...

    def __len__(self) -> int: ...


class MultiIndexAdapter:
    """Fan-out to several indexes; merge by distance, dedup by key
    (adapter.go:257-308)."""

    def __init__(self, indexes: Sequence[SearchableIndex]):
        if not indexes:
            raise ValueError("at least one index required")
        self.indexes = list(indexes)

    def add(self, key: Hashable, vector) -> None:
        for idx in self.indexes:
            idx.add(key, vector)

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        for idx in self.indexes:
            idx.batch_add(keys, vectors)

    def delete(self, key: Hashable) -> bool:
        return any([idx.delete(key) for idx in self.indexes])

    def search(self, query, k: int) -> List[Tuple[Any, float]]:
        best = {}
        for idx in self.indexes:
            for key, d in idx.search(query, k):
                if key not in best or d < best[key]:
                    best[key] = d
        return sorted(best.items(), key=lambda r: r[1])[:k]

    def __len__(self) -> int:
        return max((len(i) for i in self.indexes), default=0)
