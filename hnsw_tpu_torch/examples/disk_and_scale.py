"""Disk-resident serving, recall targets, custom metrics, multi-host
slices.

    python3 -m hnsw_tpu_torch.examples.disk_and_scale [--cpu] [--small]
"""

import tempfile

import numpy as np
import torch

from hnsw_tpu_torch import (ExactIndex, Graph, HybridConfig, HybridIndex,
                            register_distance)
from hnsw_tpu_torch.examples import check, cli
from hnsw_tpu_torch.index.streaming import StreamingExactIndex
from hnsw_tpu_torch.parallel.multihost import LocalTransport, MultiHostIndex


def main(device=None, small=False):
    rng = np.random.default_rng(0)
    n, d = (2000, 32) if small else (5000, 64)
    docs = rng.standard_normal((n, d)).astype(np.float32)

    # --- disk-resident vectors: capacity is the disk, not RAM or HBM -----
    with tempfile.TemporaryDirectory() as td:
        idx = StreamingExactIndex(td, metric="cosine", chunk_rows=1024,
                                  device=device)
        try:
            idx.batch_add(list(range(len(docs))), docs)
            res = idx.search(docs[7], 3)
            print("streaming exact:", res)
            check(res[0][0] == 7, "the streaming exact tier finds doc 7")
        finally:
            idx.close()

    # --- recall-aware routing --------------------------------------------
    h = HybridIndex(HybridConfig(exact_threshold=100, large_strategy="ivf",
                                 num_partitions=32, partition_size=200),
                    device=device)
    try:
        h.batch_add(list(range(len(docs))), docs)
        res = h.search(docs[42], 5, target_recall=0.95)
        print("target_recall route:", h.stats.last_strategy, "->", res[0])
        check(res[0][0] == 42, "target_recall=0.95 serves doc 42 first")
    finally:
        h.close()

    # --- a custom distance end to end ------------------------------------
    register_distance(
        "manhattan",
        lambda a, b: float(np.abs(a - b).sum()),
        lambda q, v: torch.cdist(q, v, p=1.0))
    g = Graph(metric="manhattan", device=device)
    # a custom metric builds with the Python host builder: fewer rows
    n_custom = 300 if small else 1000
    g.batch_add(list(range(n_custom)), docs[:n_custom])
    res = g.search(docs[3], 2)
    print("custom metric:", res)
    check(res[0][0] == 3 and res[0][1] < 1e-4,
          "the manhattan graph finds doc 3 at distance 0")

    # --- multi-host slices with replication ------------------------------
    mh = MultiHostIndex(LocalTransport([ExactIndex(device=device)
                                        for _ in range(4)]), replicas=2)
    mh.batch_add(list(range(2000)), docs[:2000])
    res = mh.search(docs[11], 2)
    print("multihost:", res, mh.stats()["per_slice"])
    check(res[0][0] == 11, "four slices with two replicas find doc 11")


if __name__ == "__main__":
    cli(main, __doc__)
