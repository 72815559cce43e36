"""Hybrid dispatch, adaptive dispatch, IVF, faceted and metadata search.

    python3 -m hnsw_tpu_torch.examples.hybrid_and_facets [--cpu] [--small]

(The reference's hybrid/, facets/ and meta/ example programs.)
"""

import numpy as np

from hnsw_tpu_torch import (AdaptiveHybridIndex, EqualityFilter, Facet,
                            FacetedGraph, Graph, HybridConfig, HybridIndex,
                            IVFIndex, MetadataGraph, RangeFilter)
from hnsw_tpu_torch.examples import check, cli


def main(device=None, small=False):
    rng = np.random.default_rng(1)
    n, d = (1200, 32) if small else (3000, 64)
    docs = rng.standard_normal((n, d)).astype(np.float32)
    keys = list(range(len(docs)))

    # --- hybrid: exact tier below the threshold, the graph above ---------
    h = HybridIndex(config=HybridConfig(exact_threshold=500), device=device)
    try:
        h.batch_add(keys, docs)
        res = h.search(docs[5], 3)
        print("hybrid strategy:", h._strategy(), "->", res[:1])
        print("partition stats:", h.get_partition_stats())
        check(res[0][0] == 5, "the hybrid index finds doc 5 first")
    finally:
        h.close()

    # --- adaptive: the bandit learns the best strategy per workload ------
    a = AdaptiveHybridIndex(device=device)
    try:
        a.batch_add(keys[:1000], docs[:1000])
        hits = sum(a.search(q, 5)[0][0] == i for i, q in enumerate(docs[:50]))
        print("adaptive stats:", {k: v for k, v in a.get_stats().items()
                                  if k != "strategies"})
        check(hits >= 48, f"the adaptive engine finds {hits} of 50 stored "
              f"vectors first (>= 48)")
    finally:
        a.close()

    # --- IVF: partition-scanned ANN (the large-N strategy) ---------------
    ivf = IVFIndex(num_partitions=32, nprobe=8, device=device)
    try:
        ivf.build(keys, docs)
        res = ivf.search(docs[7], 3)
        print("ivf:", res[:1], ivf.stats()["sizes_max"])
        check(res[0][0] == 7, "IVF finds doc 7 first")
    finally:
        ivf.close()

    # --- facets ----------------------------------------------------------
    fg = FacetedGraph(Graph(seed=0, device=device))
    for i in range(500):
        fg.add(i, docs[i], [Facet("color", ["red", "blue"][i % 2]),
                            Facet("price", float(i))])
    res = fg.search(docs[10], 3, [EqualityFilter("color", "red"),
                                  RangeFilter("price", max=100)])
    print("faceted:", res)
    check(len(res) == 3 and res[0][0] == 10 and
          all(k % 2 == 0 and k <= 100 for k, _ in res),
          "faceted search returns red items priced <= 100, doc 10 first")
    print("aggregations:", fg.facet_aggregations(docs[10], 20, ["color"]))

    # --- metadata --------------------------------------------------------
    mg = MetadataGraph(Graph(seed=0, device=device))
    mg.batch_add(list(range(200)), docs[:200],
                 [{"title": f"item {i}"} for i in range(200)])
    top = mg.search(docs[3], 2)[0]
    print("metadata:", top)
    check(top["key"] == 3 and top["metadata"] == {"title": "item 3"},
          "metadata search returns item 3 with its payload")


if __name__ == "__main__":
    cli(main, __doc__)
