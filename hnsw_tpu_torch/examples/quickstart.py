"""Quickstart: build, search, mutate, persist.

    python3 -m hnsw_tpu_torch.examples.quickstart [--cpu] [--small]

(The reference's example/main.go walkthrough, on the port.)
"""

import os
import tempfile

import numpy as np

from hnsw_tpu_torch import Graph, SavedGraph
from hnsw_tpu_torch.examples import check, cli


def main(device=None, small=False):
    rng = np.random.default_rng(0)
    n, d = (1000, 32) if small else (5000, 128)
    docs = rng.standard_normal((n, d)).astype(np.float32)

    g = Graph(m=16, ef_search=20, metric="cosine", device=device)
    g.build([f"doc-{i}" for i in range(len(docs))], docs)
    print(f"indexed {len(g)} vectors in {g.num_layers} layers")

    # batched search: the engine's native shape
    queries = rng.standard_normal((256, d)).astype(np.float32)
    keys, dists = g.batch_search(queries, k=5, ef=64)
    print("first query neighbors:", list(zip(keys[0], dists[0].round(3))))
    check(len(keys) == 256 and all(len(row) == 5 for row in keys),
          "batch_search returns 5 keys for each of 256 queries")

    # single-query convenience + self-lookup
    res = g.search(docs[42], 3)
    print("nearest to doc-42:", res)
    check(res[0][0] == "doc-42" and res[0][1] < 1e-5,
          "the nearest neighbour of doc-42 is itself")

    # mutation
    g.add("fresh", docs[0] * 0.99)
    g.delete("doc-17")
    print("after mutation:", len(g))
    check(len(g) == n and "doc-17" not in
          [kk for kk, _ in g.search(docs[17], 5)],
          "one add and one delete keep the count; doc-17 is gone")

    # negative-example search: demote results similar to a negative
    res = g.search_with_negative(queries[0], docs[7], k=5, neg_weight=0.7)
    print("negative-weighted:", res[:3])

    # self-tuning ef: state a recall target instead of guessing ef, on a
    # sample of the workload
    ef, measured = g.calibrate_ef(0.9, k=5, probe_queries=queries[:64])
    print(f"calibrated ef={ef} (probe recall {measured:.3f}); default "
          "searches now use it")
    check(measured >= 0.9, f"calibrate_ef meets its 0.9 target "
          f"({measured:.3f})")

    # latency tier: batches <= native_serve_max_batch are answered by the
    # C++ engine on the host arrays, with no device round trip
    print("single query (native tier):", g.search(queries[0], 3)[:1])

    # persistence with atomic checkpoints
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "quickstart_graph.npz")
        SavedGraph(g, path).save()
        sg2 = SavedGraph.load(path, device=device)
        print("reloaded:", len(sg2.graph))
        check(len(sg2.graph) == len(g) and
              sg2.graph.search(docs[42], 1)[0][0] == "doc-42",
              "the reloaded graph holds every key and finds doc-42")


if __name__ == "__main__":
    cli(main, __doc__)
