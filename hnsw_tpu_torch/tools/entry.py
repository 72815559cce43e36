"""Driver entry points of the port (counterpart of ``__graft_entry__``).

entry(device=None)  -> (fn, example_args): one batched hierarchical HNSW
                       search over the device graph (core/search.py) on
                       a 512 x 32 cosine graph, with 64 queries.
dryrun_multichip(n) -> the multi-device paths on an n-shard mesh
                       (``parallel/dryrun.py``).

    python3 -m hnsw_tpu_torch.tools.entry [--device cpu]

runs ``fn(*args)`` once and prints the result's shapes. Without
``--device cpu`` it runs on the CUDA card or raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from hnsw_tpu_torch.parallel.dryrun import dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]


def _tiny_graph(n=512, d=32, seed=0, device=None):
    from hnsw_tpu_torch import Graph
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    g = Graph(m=8, ef_search=20, metric="cosine", seed=seed, device=device)
    g.build(list(range(n)), vecs, wave=256)
    return g, vecs


def entry(device=None):
    """(fn, args): ``fn(*args)`` searches 64 queries (seed 1) for k=10 at
    ef=32 over the tiny graph's device layout; returns (dists [64, 10],
    slots [64, 10])."""
    from hnsw_tpu_torch.core.search import search_graph

    g, vecs = _tiny_graph(device=device)
    dev = g.device_graph()
    rng = np.random.default_rng(1)
    queries = torch.from_numpy(rng.standard_normal(
        (64, vecs.shape[1])).astype(np.float32)).to(g.device)

    def fn(graph, q):
        return search_graph(graph, q, k=10, ef=32, metric="cosine",
                            max_hops=64, expand=4)

    return fn, (dev, queries)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help='"cpu" to run on the CPU (default: the CUDA card)')
    args = ap.parse_args(argv)
    fn, fargs = entry(device=args.device)
    out = fn(*fargs)
    print("entry ok:", [tuple(o.shape) for o in out])
    return 0


if __name__ == "__main__":
    sys.exit(main())
