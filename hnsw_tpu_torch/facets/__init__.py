"""Faceted search (port of hnsw_tpu/facets) — capability parity with
hnsw-extensions/facets.

Facet model and filters mirror facets/facets.go:14-276 (BasicFacet,
EqualityFilter, RangeFilter, StringContainsFilter, MemoryFacetStore);
the search path mirrors the over-fetch/post-filter/refill pattern of
facets/search.go:15-88 — but the over-fetch runs as ONE batched device
sweep, and the store filter is a vectorized host predicate.

The masked exact scan (``FacetedGraph.batch_search_exact``) goes through
``ops/exact_screen.exact_scan``: the fused screen kernel K1 on a CUDA
graph of 32,768 slots or more, the plain chunked scan elsewhere, as the
exact tier decides. The JAX package calls its plain scan (XLA) here at
every size; the results are the same (f32-exact, ties to the lower id).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.ops.exact_screen import exact_scan


@dataclasses.dataclass(frozen=True)
class Facet:
    """A (name, value) attribute attached to a node (facets.go:78)."""
    name: str
    value: Any


BasicFacet = Facet  # reference naming alias (facets.go:78)


class FacetFilter:
    """Predicate over a facet value (facets.go:26)."""

    name: str

    def matches(self, value: Any) -> bool:  # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class EqualityFilter(FacetFilter):
    """Exact equality (facets.go:132's DeepEqual)."""
    name: str
    value: Any

    def matches(self, value: Any) -> bool:
        return value == self.value


@dataclasses.dataclass(frozen=True)
class RangeFilter(FacetFilter):
    """Numeric [min, max] with coercion (facets.go:146)."""
    name: str
    min: Optional[float] = None
    max: Optional[float] = None

    def matches(self, value: Any) -> bool:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return False
        if self.min is not None and v < self.min:
            return False
        if self.max is not None and v > self.max:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class StringContainsFilter(FacetFilter):
    """Case-insensitive substring (facets.go:175)."""
    name: str
    substring: str

    def matches(self, value: Any) -> bool:
        return isinstance(value, str) and self.substring.lower() in value.lower()


class FacetStore:
    """Storage interface for per-key facets (facets.go:209)."""

    def add(self, key: Hashable, facets: Sequence[Facet]) -> None:
        raise NotImplementedError

    def get(self, key: Hashable) -> Optional[List[Facet]]:
        raise NotImplementedError

    def delete(self, key: Hashable) -> bool:
        raise NotImplementedError

    def matches(self, key: Hashable, filters: Sequence[FacetFilter]) -> bool:
        facets = self.get(key)
        if facets is None:
            return not filters
        by_name: Dict[str, List[Any]] = {}
        for f in facets:
            by_name.setdefault(f.name, []).append(f.value)
        for flt in filters:
            vals = by_name.get(flt.name)
            if vals is None or not any(flt.matches(v) for v in vals):
                return False
        return True

    def filter(self, filters: Sequence[FacetFilter]) -> List[Hashable]:
        raise NotImplementedError


class MemoryFacetStore(FacetStore):
    """In-memory map store (facets.go:232)."""

    def __init__(self) -> None:
        self._data: Dict[Hashable, List[Facet]] = {}

    def add(self, key: Hashable, facets: Sequence[Facet]) -> None:
        self._data[key] = list(facets)

    def get(self, key: Hashable) -> Optional[List[Facet]]:
        return self._data.get(key)

    def delete(self, key: Hashable) -> bool:
        return self._data.pop(key, None) is not None

    def filter(self, filters: Sequence[FacetFilter]) -> List[Hashable]:
        return [k for k in self._data if self.matches(k, filters)]

    def __len__(self) -> int:
        return len(self._data)


class FacetedGraph:
    """Graph + FacetStore composition (facets/search.go:166)."""

    def __init__(self, graph, store: Optional[FacetStore] = None):
        self.graph = graph
        # not `store or ...`: an empty store is falsy through __len__
        self.store = store if store is not None else MemoryFacetStore()

    # -- mutation (Add with rollback, search.go:178-205) -------------------
    def add(self, key: Hashable, vector, facets: Sequence[Facet]) -> None:
        self.graph.add(key, vector)
        try:
            self.store.add(key, facets)
        except Exception:
            self.graph.delete(key)
            raise

    def batch_add(self, keys: Sequence[Hashable], vectors,
                  facets_per_key: Sequence[Sequence[Facet]]) -> None:
        for k, v, f in zip(keys, vectors, facets_per_key):
            self.add(k, v, f)

    def delete(self, key: Hashable) -> bool:
        ok = self.graph.delete(key)
        self.store.delete(key)
        return ok

    # -- faceted search (over-fetch + post-filter, search.go:15-88) ---------
    def search(self, query, k: int, filters: Sequence[FacetFilter] = (),
               expand_factor: int = 3) -> List[Tuple[Any, float]]:
        expanded_k = max(k * max(expand_factor, 1), k)
        results = self.graph.search(query, expanded_k)
        kept = [(key, d) for key, d in results
                if self.store.matches(key, filters)]
        if len(kept) < k and len(results) == expanded_k:
            # shortfall: re-query wider once (search.go:56-72)
            wider = self.graph.search(query, 2 * expanded_k)
            seen = {key for key, _ in kept}
            for key, d in wider:
                if key not in seen and self.store.matches(key, filters):
                    kept.append((key, d))
                    seen.add(key)
        kept.sort(key=lambda r: r[1])
        return kept[:k]

    def search_with_negative(self, query, negative, k: int,
                             neg_weight: float = 0.5,
                             filters: Sequence[FacetFilter] = (),
                             expand_factor: int = 3
                             ) -> List[Tuple[Any, float]]:
        """facets/search.go:92-163 — negative-example + facet filter.
        Scores are the combined negative-example scores (higher=better)."""
        expanded_k = max(k * max(expand_factor, 1), k)
        results = self.graph.search_with_negative(query, negative,
                                                  expanded_k, neg_weight)
        kept = [(key, s) for key, s in results
                if self.store.matches(key, filters)]
        kept.sort(key=lambda r: -r[1])
        return kept[:k]

    def batch_search(self, queries, k: int,
                     filters: Sequence[FacetFilter] = (),
                     expand_factor: int = 3
                     ) -> List[List[Tuple[Any, float]]]:
        """One batched device over-fetch, host-side filtering per query."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        expanded_k = max(k * max(expand_factor, 1), k)
        keys, dists = self.graph.batch_search(queries, expanded_k)
        out = []
        for qi in range(queries.shape[0]):
            kept = [(key, float(d)) for key, d in zip(keys[qi], dists[qi])
                    if key is not None and self.store.matches(key, filters)]
            kept.sort(key=lambda r: r[1])
            out.append(kept[:k])
        return out

    def batch_search_exact(self, queries, k: int,
                           filters: Sequence[FacetFilter] = ()
                           ) -> List[List[Tuple[Any, float]]]:
        """Filtered search as ONE masked exact scan — recall 1.0
        under ANY filter selectivity.

        The reference's over-fetch/post-filter/refill pattern
        (facets/search.go:15-88, mirrored by ``batch_search``) degrades
        when the filter is selective: the k nearest MATCHING vectors may
        all sit outside the expanded candidate set. The upgrade:
        resolve the allowed-key set host-side, fold it into the alive
        mask, and brute-force the survivors — exact filtered k-NN at
        exact-tier throughput. Requires the full device vector store
        (hbm_mode="full")."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        allowed = self.store.filter(filters) if filters else None
        dev = self.graph.device_graph()
        if dev.vectors.shape[0] <= 1:
            raise ValueError("batch_search_exact requires "
                             "hbm_mode='full' (vectors on the device)")
        alive = dev.alive
        if allowed is not None:
            mask = np.zeros(dev.cap, bool)
            for key in allowed:
                s = self.graph.slots.slot_of(key)
                if s is not None:
                    mask[s] = True
            alive = alive & torch.from_numpy(mask).to(alive.device)
        # ALWAYS exact: this method's contract is recall 1.0 (it can
        # serve as a filtered ground-truth oracle), so the graph's
        # fast_math approximation is deliberately not inherited.
        # pow2-bucket the batch, as the JAX package does
        nq = queries.shape[0]
        q_pad = 1 << max(3, (nq - 1).bit_length())
        qp = np.zeros((q_pad, queries.shape[1]), np.float32)
        qp[:nq] = queries
        d, i = exact_scan(torch.from_numpy(qp).to(dev.vectors.device),
                          dev.vectors, dev.sq_norms, alive, k=k,
                          metric=self.graph.metric, fast_math=False)
        d, i = d[:nq].cpu().numpy(), i[:nq].cpu().numpy()
        out = []
        for qi in range(queries.shape[0]):
            row = [(self.graph.slots.key_of(int(s)), float(dd))
                   for dd, s in zip(d[qi], i[qi]) if s >= 0]
            out.append(row[:k])
        return out

    def facet_aggregations(self, query, k: int,
                           facet_names: Optional[Sequence[str]] = None
                           ) -> Dict[str, Dict[Any, int]]:
        """Value-count histograms over the k nearest candidates
        (search.go:283-329 GetFacetAggregations)."""
        results = self.graph.search(query, k)
        agg: Dict[str, Dict[Any, int]] = {}
        for key, _ in results:
            for f in self.store.get(key) or []:
                if facet_names and f.name not in facet_names:
                    continue
                agg.setdefault(f.name, {})
                agg[f.name][f.value] = agg[f.name].get(f.value, 0) + 1
        return agg
