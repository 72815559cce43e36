"""The plain reference against NumPy brute force, the program's plain
search, and toy graphs whose reads are known."""

import numpy as np
import pytest
import torch

from portbench import datagen, reference


def _np_dist(rows, queries, metric):
    r, q = rows.astype(np.float64), queries.astype(np.float64)
    if metric == "l2":
        return np.sqrt(((q[:, None, :] - r[None, :, :]) ** 2).sum(-1))
    r = r / np.linalg.norm(r, axis=1, keepdims=True)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return 1.0 - q @ r.T


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_exact_topk_matches_numpy(metric):
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((700, 24)).astype(np.float32)
    queries = rng.standard_normal((50, 24)).astype(np.float32)
    d, i = reference.exact_topk(torch.from_numpy(rows),
                                torch.from_numpy(queries), 10, metric,
                                q_block=16, r_block=128)
    full = _np_dist(rows, queries, metric)
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(full, want, 1),
                               rtol=1e-12, atol=1e-12)
    again = reference.distances(torch.from_numpy(rows),
                                torch.from_numpy(queries), i, metric)
    np.testing.assert_allclose(again.numpy(), d.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_distances_out_of_range_is_nan():
    rows = torch.ones(4, 3)
    d = reference.distances(rows, torch.zeros(1, 3),
                            torch.tensor([[0, -1, 4]]), "l2")
    assert d[0, 0] == pytest.approx(3 ** 0.5)
    assert torch.isnan(d[0, 1:]).all()


def _toy():
    # a path 0 - 1 - 2 - 3 - 4 on layer 0 and node 4 alone on layer 1:
    # a query at x = 0 starts at 4 and walks the whole path
    rows = torch.tensor([[0.0], [1.0], [2.0], [3.0], [4.0]])
    nb0 = torch.tensor([[1, -1], [0, 2], [1, 3], [2, 4], [3, -1]])
    nb1 = torch.full((5, 2), -1)
    levels = torch.tensor([0, 0, 0, 0, 1])
    return rows, reference.GraphArrays([nb0, nb1], [2, 1], levels, 4)


def test_walk_counts_on_a_toy_graph():
    rows, g = _toy()
    counts = {}
    d, i = reference.walk(g, reference.prepare(rows, "l2"),
                          torch.tensor([[0.0]]), metric="l2", k=2, ef=2,
                          ef_upper=8, expand=1, max_hops=100, counts=counts)
    assert i.tolist() == [[0, 1]]
    assert d.tolist() == [[0.0, 1.0]]
    assert counts["entry_rows"] == 1 and counts["entry_scored"] == 1
    # layer 1: node 4 expanded, no neighbour; layer 0: 4, 3, 2, 1, 0
    # expanded, their not-yet-pooled neighbours 3, 2, 1, 0 scored once
    assert counts["layers"] == [(1, 1, 0, 0), (2, 5, 4, 4)]


def test_graph_faults_counts_each_rule():
    _, g = _toy()
    assert reference.graph_faults(g) == 0
    bad = [t.clone() for t in g.neighbors]
    bad[0][0, 1] = 0          # its own neighbour
    bad[0][2, 1] = 1          # an id twice
    bad[0][3, 0] = 9          # out of range
    bad[1][0, 0] = 4          # a neighbour above the node's level
    bad[1][4, 1] = 3          # past the layer's width, and level too low
    faults = reference.graph_faults(reference.GraphArrays(
        bad, g.widths, g.levels, 1))
    # the five entries, and an entry node below the top layer
    assert faults == 6


@pytest.mark.parametrize("metric,ef", [("l2", 16), ("cosine", 40)])
def test_walk_matches_the_programs_plain_search(metric, ef):
    from hnsw_tpu_torch import Graph
    from hnsw_tpu_torch.config import GraphConfig
    rows, queries = datagen.generate(
        dict(data_seed=5, subspace=12, clusters=8, center_std=2.0,
             spread_log_std=0.3, noise_std=0.05, offset=0.5, scale=3.0),
        1500, 64, 24, 5, "cpu")
    g = Graph(config=GraphConfig(m=8, m0=16, ml=0.25, ef_construction=40,
                                 metric=metric, seed=5, max_hops=128,
                                 search_expand=4), device="cpu")
    g.build(list(range(1500)), rows.numpy(), method="device", wave=256)
    _, ids = g.batch_search_slots(queries.numpy(), 10, ef=ef)
    nb, levels, entry, _ = g.host.arrays()
    ga = reference.GraphArrays(
        [torch.from_numpy(np.array(nb[layer, :1500]))
         for layer in range(nb.shape[0])],
        [16] + [8] * (nb.shape[0] - 1),
        torch.from_numpy(np.array(levels[:1500])), int(entry))
    assert reference.graph_faults(ga) == 0
    _, ref = reference.walk(ga, reference.prepare(rows, metric), queries,
                            metric=metric, k=10, ef=ef, ef_upper=8, expand=4,
                            max_hops=max(128, -(-2 * ef // 4)))
    np.testing.assert_array_equal(ids, ref.numpy())
