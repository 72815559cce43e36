"""The parallel package and batch composition on the card.

Marked ``cuda``: these skip where there is no NVIDIA GPU (decided inside
the fixture, never at import). Imports nothing of JAX, so on a GPU
machine without it run them with
``python -m pytest --noconftest tests/test_torch_cuda_parallel.py``.

* ``sharded_exact_topk`` over 8 shards of one card: ids equal to one
  ``exact_scan`` of the whole table, distances within 1e-5, and K1
  launched once a shard: fed by TMA at D = 128 (every shard view is
  16-byte aligned), by cp.async at D = 50.
* The row-sharded graph's two exchanges, stacked and shard loop: equal
  ids and distances.
* Batch composition (twin of tests/test_determinism.py's first test):
  singles and a shuffled batch give the full batch's keys, distances
  within 1e-5, through the device path; keys equal to the CPU's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hnsw_tpu_torch import Graph  # noqa: E402
from hnsw_tpu_torch.ops import exact_screen as es  # noqa: E402
from hnsw_tpu_torch.parallel import rowsharded as trs  # noqa: E402
from hnsw_tpu_torch.parallel import sharded as tsh  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("d,route", [(128, "wgmma"), (50, "wgmma_cp")])
def test_sharded_exact_runs_k1_on_every_shard(cuda, d, route):
    g = torch.Generator(device=cuda).manual_seed(0)
    n, k = 8 * 32768, 10
    v = torch.randn((n, d), generator=g, device=cuda)
    q = torch.randn((256, d), generator=g, device=cuda)
    sq = (v * v).sum(-1)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    d1, i1 = es.exact_scan(q, v, sq, valid, k=k, metric="l2")
    es.launches_by_route.update(wgmma=0, wgmma_cp=0)
    d8, i8 = tsh.sharded_exact_topk(q, v, sq, valid, k=k, metric="l2",
                                    mesh=tsh.default_mesh(8))
    assert es.launches_by_route == {"wgmma": 0, "wgmma_cp": 0, route: 8}
    assert torch.equal(i8, i1)
    assert float((d8 - d1).abs().max()) <= 1e-5


def test_rowsharded_stacked_equals_shard_loop(cuda):
    rng = np.random.default_rng(36)
    v = rng.standard_normal((4096, 64)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    g = Graph(m=8, seed=0, ef_construction=60, device=cuda)
    g.build(list(range(len(v))), v, wave=512)
    shards = trs.make_row_shards(g, 8)
    mesh = tsh.default_mesh(8)
    kw = dict(k=10, ef=64, seeds=16, metric="cosine", max_hops=128,
              expand=2)
    a = trs._search(trs._StackedRows(shards, mesh, "data"), *shards[3:],
                    q.to(cuda), **kw)
    b = trs._search(trs._ShardLoopRows(shards, mesh, "data"), *shards[3:],
                    q.to(cuda), **kw)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


def _composition_invariant(g, q):
    keys_full, d_full = g.batch_search(q, 5, ef=40)
    for i in (0, 7, 31):
        keys_one, d_one = g.batch_search(q[i:i + 1], 5, ef=40)
        assert keys_one[0] == keys_full[i]
        np.testing.assert_allclose(d_one[0], d_full[i], rtol=0, atol=1e-5)
    perm = np.random.default_rng(3).permutation(len(q))
    keys_p, _ = g.batch_search(q[perm], 5, ef=40)
    for j, i in enumerate(perm):
        assert keys_p[j] == keys_full[i]
    return keys_full, d_full


def test_search_batch_composition_invariant(cuda):
    v = np.random.default_rng(100).standard_normal((400, 16)).astype(
        np.float32)
    q = np.random.default_rng(101).standard_normal((32, 16)).astype(
        np.float32)
    out = []
    for dev in (cuda, "cpu"):
        g = Graph(seed=0, device=dev)
        g.batch_add(list(range(400)), v)
        g.native_serve_max_batch = 0
        out.append(_composition_invariant(g, q))
    assert out[0][0] == out[1][0]
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=0, atol=1e-5)
