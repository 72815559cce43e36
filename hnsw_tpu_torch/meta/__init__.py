"""JSON metadata attachment (copy of hnsw_tpu/meta) — capability parity
with hnsw-extensions/meta.

MetadataStore / MemoryMetadataStore mirror meta/meta.go:78-173;
MetadataGraph mirrors meta/graph.go (add-with-rollback, get merging
vector + metadata, search with metadata attachment). One deliberate
fix: results carry REAL distances — the reference returns Dist: 0
placeholders (meta/graph.go:140; SURVEY.md §7.4).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple


def _coerce_metadata(metadata: Any) -> Any:
    """Accept dict / list / JSON str / bytes, validating JSON
    (meta/meta.go:14-75's multi-type constructor)."""
    if metadata is None:
        return None
    if isinstance(metadata, (bytes, bytearray)):
        metadata = metadata.decode("utf-8")
    if isinstance(metadata, str):
        return json.loads(metadata)  # raises on invalid JSON
    json.dumps(metadata)  # validate serializability
    return metadata


class MetadataStore:
    """meta/meta.go:78 interface."""

    def add(self, key: Hashable, metadata: Any) -> None:
        raise NotImplementedError

    def get(self, key: Hashable) -> Optional[Any]:
        raise NotImplementedError

    def delete(self, key: Hashable) -> bool:
        raise NotImplementedError

    def batch_add(self, keys: Sequence[Hashable],
                  metadatas: Sequence[Any]) -> None:
        for k, m in zip(keys, metadatas):
            self.add(k, m)

    def batch_get(self, keys: Sequence[Hashable]) -> List[Optional[Any]]:
        return [self.get(k) for k in keys]

    def for_each(self, fn) -> None:
        raise NotImplementedError


class MemoryMetadataStore(MetadataStore):
    """meta/meta.go:120 map implementation."""

    def __init__(self) -> None:
        self._data: Dict[Hashable, Any] = {}

    def add(self, key: Hashable, metadata: Any) -> None:
        self._data[key] = _coerce_metadata(metadata)

    def get(self, key: Hashable) -> Optional[Any]:
        return self._data.get(key)

    def delete(self, key: Hashable) -> bool:
        return self._data.pop(key, None) is not None

    def for_each(self, fn) -> None:
        for k, v in self._data.items():
            fn(k, v)

    def __len__(self) -> int:
        return len(self._data)


class MetadataGraph:
    """Graph + MetadataStore composition (meta/graph.go:12)."""

    def __init__(self, graph, store: Optional[MetadataStore] = None):
        self.graph = graph
        # not `store or ...`: an empty store is falsy through __len__
        self.store = store if store is not None else MemoryMetadataStore()

    def add(self, key: Hashable, vector, metadata: Any = None) -> None:
        """Add with rollback on store failure (meta/graph.go:26-42)."""
        coerced = _coerce_metadata(metadata)  # validate BEFORE inserting
        self.graph.add(key, vector)
        try:
            self.store.add(key, coerced)
        except Exception:
            self.graph.delete(key)
            raise

    def batch_add(self, keys: Sequence[Hashable], vectors,
                  metadatas: Sequence[Any]) -> None:
        for k, v, m in zip(keys, vectors, metadatas):
            self.add(k, v, m)

    def delete(self, key: Hashable) -> bool:
        ok = self.graph.delete(key)
        self.store.delete(key)
        return ok

    def get(self, key: Hashable) -> Optional[Dict[str, Any]]:
        """Merged record: vector + metadata (meta/graph.go:98-125)."""
        vec = self.graph.lookup(key)
        if vec is None:
            return None
        return {"key": key, "vector": vec, "metadata": self.store.get(key)}

    # -- searches with metadata attachment (meta/graph.go:128-240) ----------
    def _attach(self, results: List[Tuple[Any, float]]
                ) -> List[Dict[str, Any]]:
        metas = self.store.batch_get([k for k, _ in results])
        return [{"key": k, "dist": float(d), "metadata": m}
                for (k, d), m in zip(results, metas)]

    def search(self, query, k: int) -> List[Dict[str, Any]]:
        return self._attach(self.graph.search(query, k))

    def batch_search(self, queries, k: int) -> List[List[Dict[str, Any]]]:
        keys, dists = self.graph.batch_search(queries, k)
        out = []
        for row_k, row_d in zip(keys, dists):
            pairs = [(kk, dd) for kk, dd in zip(row_k, row_d)
                     if kk is not None]
            out.append(self._attach(pairs))
        return out

    def search_with_negative(self, query, negative, k: int,
                             neg_weight: float = 0.5
                             ) -> List[Dict[str, Any]]:
        res = self.graph.search_with_negative(query, negative, k, neg_weight)
        return self._attach(res)

    def search_with_negatives(self, query, negatives, k: int,
                              neg_weight: float = 0.5
                              ) -> List[Dict[str, Any]]:
        res = self.graph.search_with_negatives(query, negatives, k,
                                               neg_weight)
        return self._attach(res)

    def __len__(self) -> int:
        return len(self.graph)
