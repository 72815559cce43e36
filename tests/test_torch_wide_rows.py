"""Rows wider than 128 through the port's plain path, held to the
benchmark's float64 reference.

The 1,536-wide configuration (ANN-Benchmarks' dbpedia-openai-1000k-angular,
``portbench/configs/dbpedia-openai1536-cos-hnsw.json``) gives rows twelve
times as wide as the other cells'. Here ``Graph.build(method="device")``
builds 2,000 of its generator's rows at D = 132 (one 16-byte unit past
128), 1,030 (not a multiple of 4) and 1,536, in cosine and l2, and
``batch_search_slots`` answers 64 queries through the plain path (the
CPU's). The answers are compared with ``portbench.reference.walk`` over
the same graph's arrays (``walk_diff``) and with ``reference.distances``
(``dist_err``), the numbers the benchmark's ``correct`` takes. No test
here needs CUDA; ``tests/test_torch_cuda_wide.py`` holds the kernels to
the plain path at these widths on the card.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hnsw_tpu_torch import Graph  # noqa: E402
from hnsw_tpu_torch.config import GraphConfig  # noqa: E402
from portbench import check, datagen, reference  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(
    ROOT, "portbench", "configs", "dbpedia-openai1536-cos-hnsw.json")))
N, NQ, EF = 2000, 64, 64
#: walk_diff: the plain path scores in float32 and the reference in
#: float64, so a near-tie may be broken the other way and the walk then
#: differs by a neighbour or two: at most 3 ids of the 640 returned. A
#: fault of the width (a row read at the wrong stride, a cut row) moves
#: far more.
WALK_DIFF = 3 / (NQ * 10)
#: dist_err: the benchmark's own limit for these cells; a float32 sum of
#: 1,536 terms rounds at about sqrt(D) 2^-24 = 2.3e-6 of the operands'
#: scale, and reads 2e-7 to 4e-7 here
DIST_ERR = 1e-5


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("dim", [132, 1030, 1536])
def test_wide_rows_build_and_search_as_the_reference_walks(dim, metric):
    rows, queries = datagen.generate(CONFIG["generator"], N, NQ, dim, 7,
                                     "cpu")
    g = Graph(config=GraphConfig(m=8, m0=16, ml=0.25, ef_construction=40,
                                 metric=metric, seed=7, max_hops=128,
                                 search_expand=4), device="cpu")
    g.build(list(range(N)), rows.numpy(), method="device", wave=512)
    d, ids = g.batch_search_slots(queries.numpy(), 10, ef=EF)
    assert ids.shape == (NQ, 10) and not check.invalid_rows(d, ids, N).any()
    nb, levels, entry, _ = g.host.arrays()
    ga = reference.GraphArrays(
        [torch.from_numpy(np.array(nb[layer, :N]))
         for layer in range(nb.shape[0])],
        [16] + [8] * (nb.shape[0] - 1),
        torch.from_numpy(np.array(levels[:N])), int(entry))
    assert reference.graph_faults(ga) == 0
    _, walked = reference.walk(ga, reference.prepare(rows, metric), queries,
                               metric=metric, k=10, ef=EF, ef_upper=8,
                               expand=4, max_hops=128)
    walk_diff = check.walk_misses(ids, walked.numpy()) / ids.size
    assert walk_diff <= WALK_DIFF, walk_diff
    err = check.dist_err(rows, queries, d, ids, metric)
    assert err <= DIST_ERR, err


def test_the_generator_at_1536_gives_text_embedding_geometry():
    """The configuration's generator at D = 1,536: the shape, float32,
    and two random rows' cosine similarity near 0.7 on average (ada-002
    embeddings share a mean direction; the configuration's offset sets
    it), with the nearest rows of a query closer still."""
    rows, queries = datagen.generate(CONFIG["generator"], 4000, 200,
                                     CONFIG["dim"], 11, "cpu")
    assert rows.shape == (4000, 1536) and queries.shape == (200, 1536)
    assert rows.dtype == torch.float32
    u = reference.prepare(rows, "cosine")
    r = np.random.default_rng(0)
    i, j = r.integers(0, 4000, (2, 3000))
    keep = i != j
    sim = (u[i[keep]] * u[j[keep]]).sum(1)
    assert abs(float(sim.mean()) - 0.7) < 0.03, float(sim.mean())
    top = (reference.prepare(queries, "cosine") @ u.T).max(1).values
    assert float(top.mean()) > float(sim.mean()) + 0.15
