"""Multi-device serving over a mesh of shards.

    python3 -m hnsw_tpu_torch.examples.multichip [--cpu] [--small]

On the card: ``default_mesh(8)``, eight shards of one card (on several
cards the shards go round-robin over them); with ``--cpu``: eight CPU
shards.
"""

import numpy as np
import torch

from hnsw_tpu_torch import Graph
from hnsw_tpu_torch.examples import check, cli
from hnsw_tpu_torch.ops.topk import np_exact_topk
from hnsw_tpu_torch.parallel.rowsharded import (make_row_shards,
                                                rowsharded_graph_search)
from hnsw_tpu_torch.parallel.sharded import (default_mesh,
                                             sharded_exact_topk,
                                             sharded_graph_search)


def main(device=None, small=False):
    mesh = (default_mesh(8) if device is None
            else default_mesh(8, device=device))
    n_dev = len(mesh.devices)
    print(f"mesh: {n_dev} shards on {sorted({str(d) for d in mesh.devices})}")

    rng = np.random.default_rng(0)
    n, d = (1024, 32) if small else (4096, 64)
    docs = rng.standard_normal((n, d)).astype(np.float32)

    # data-parallel serving: replicated graph, sharded query batch
    g = Graph(seed=0, device=mesh.devices[0])
    g.build(list(range(len(docs))), docs, wave=1024)
    qn = rng.standard_normal((64 * n_dev, d)).astype(np.float32)
    queries = torch.from_numpy(qn).to(mesh.devices[0])
    _, i = sharded_graph_search(g.device_graph(), queries, k=5, ef=48,
                                metric="cosine", mesh=mesh)
    ids = i.cpu().numpy()
    print("dp search ids[0]:", ids[0])
    _, gt = np_exact_topk(qn, docs, 5, "cosine")
    rec = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ids, gt)])
    check(rec >= 0.9, f"query-sharded graph recall@5 {rec:.3f} >= 0.9")

    # row-sharded exact: each shard scans its rows, global top-k merge
    vecs = torch.from_numpy(docs).to(mesh.devices[0])
    _, i2 = sharded_exact_topk(
        queries[:16], vecs, (vecs * vecs).sum(1),
        torch.ones(len(docs), dtype=torch.bool, device=vecs.device), k=5,
        metric="l2", mesh=mesh)
    print("row-sharded exact ids[0]:", i2.cpu().numpy()[0])
    check(np.array_equal(i2.cpu().numpy(),
                         np_exact_topk(qn[:16], docs, 5, "l2")[1]),
          "row-sharded exact ids equal the numpy oracle's")

    # ONE graph larger than a device: layer-0 rows sharded over the mesh,
    # a frontier exchange a hop (the reference's distributed sketch,
    # hnsw-extensions.md:233-271)
    shards = make_row_shards(g, n_dev)
    _, i3 = rowsharded_graph_search(shards, queries[:16], k=5, ef=64,
                                    metric="cosine", mesh=mesh)
    ids3 = i3.cpu().numpy()
    print("row-sharded SINGLE graph ids[0]:", ids3[0])
    rec3 = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ids3, gt)])
    check(rec3 >= 0.9, f"row-sharded graph recall@5 {rec3:.3f} >= 0.9")


if __name__ == "__main__":
    cli(main, __doc__)
