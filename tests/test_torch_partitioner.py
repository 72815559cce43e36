"""hnsw_tpu_torch.Partitioner against hnsw_tpu's on the CPU.

Both partitioners get the same seeded keys and vectors. Assignments must
be equal (both score in full f32 and take the first minimum), centroids
within 1e-6 after an update.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.index.partitioner import Partitioner as JPartitioner  # noqa: E402
from hnsw_tpu_torch import Partitioner  # noqa: E402
from hnsw_tpu_torch.convert import partitioner_from_jax  # noqa: E402
from tests.conftest import make_vectors  # noqa: E402


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_assignment_and_rebalance_match_jax(metric):
    v = make_vectors(300, 16, seed=63, kind="clustered")
    keys = list(range(300))
    j = JPartitioner(5, metric=metric)
    t = Partitioner(5, metric=metric, device="cpu")
    assert t.batch_assign(keys, v) == j.batch_assign(keys, v)
    np.testing.assert_array_equal(t.centroids, j.centroids)
    assert t.partition_sizes() == j.partition_sizes()
    assert t.rebalance() == j.rebalance()
    np.testing.assert_allclose(t.centroids, j.centroids, atol=1e-6, rtol=0)
    assert t.assignment == j.assignment
    assert t.stats() == j.stats()


def test_partitioner_assign_and_rebalance():
    """Port twin of tests/test_hybrid.py's partitioner spec."""
    v = make_vectors(200, 16, seed=63, kind="clustered")
    p = Partitioner(4, device="cpu")
    parts = p.batch_assign(list(range(200)), v)
    assert len(parts) == 200
    assert sum(p.partition_sizes()) == 200
    moved = p.rebalance()
    assert sum(p.partition_sizes()) == 200
    assert moved >= 0
    a = p.assign("x", v[0])
    b = p.assign("y", v[0] + 1e-4)
    assert a == b
    assert p.remove("x")
    assert not p.remove("x")
    assert p.stats()["total"] == 201


def test_partitioner_carried_across_assigns_alike():
    v = make_vectors(120, 12, seed=5)
    j = JPartitioner(6, dim=12)
    j.batch_assign(list(range(100)), v[:100])
    j.update_centroids()
    t = partitioner_from_jax(j, device="cpu")
    assert t.assignment == j.assignment and t.partition_sizes() == \
        j.partition_sizes()
    assert t.batch_assign(list(range(100, 120)), v[100:]) == \
        j.batch_assign(list(range(100, 120)), v[100:])


def test_bad_partition_count_raises():
    with pytest.raises(ValueError, match="num_partitions"):
        Partitioner(0, device="cpu")
