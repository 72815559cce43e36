"""Determinism and invariance of hnsw_tpu_torch, twin of
tests/test_determinism.py, on the CPU (``device="cpu"``).

Identical results across runs and batch compositions, held against
hnsw_tpu on the same seeded inputs: keys equal to the JAX graph's
(both build with the shared native builder, so the graphs are equal),
distances within 1e-5. The batch-composition spec runs on the native
latency tier (batches of 32 or fewer, as in JAX) and on the device path
(``native_serve_max_batch = 0``), whose batches are padded to another
shape for each composition. Its CUDA twin
(tests/test_torch_cuda_parallel.py) repeats it on the card, where the
GEMMs may pick another kernel for another batch shape: it guards
query-sharded search, which splits one batch into parts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
from hnsw_tpu_torch import Graph, load_graph, save_graph  # noqa: E402
from hnsw_tpu_torch.core.search import search_graph  # noqa: E402
from hnsw_tpu_torch.core.state import DeviceGraph  # noqa: E402
from tests.conftest import make_vectors  # noqa: E402


def _composition_invariant(g, q):
    keys_full, d_full = g.batch_search(q, 5, ef=40)
    for i in (0, 7, 31):
        keys_one, d_one = g.batch_search(q[i:i + 1], 5, ef=40)
        assert keys_one[0] == keys_full[i]
        np.testing.assert_allclose(d_one[0], d_full[i], rtol=1e-5)
    perm = np.random.default_rng(3).permutation(len(q))
    keys_p, _ = g.batch_search(q[perm], 5, ef=40)
    for j, i in enumerate(perm):
        assert keys_p[j] == keys_full[i]
    return keys_full, d_full


@pytest.mark.parametrize("tier", ["native", "device"])
def test_search_batch_composition_invariant(tier):
    v = make_vectors(400, 16, seed=100)
    q = make_vectors(32, 16, seed=101)
    g = Graph(seed=0, device="cpu")
    g.batch_add(list(range(400)), v)
    jg = hnsw_tpu.Graph(seed=0)
    jg.batch_add(list(range(400)), v)
    if tier == "device":
        g.native_serve_max_batch = jg.native_serve_max_batch = 0
    keys, d = _composition_invariant(g, q)
    jkeys, jd = jg.batch_search(q, 5, ef=40)
    assert keys == jkeys
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5)


def test_repeated_search_identical():
    v = make_vectors(300, 16, seed=102)
    q = make_vectors(8, 16, seed=103)
    g = Graph(seed=0, device="cpu")
    g.batch_add(list(range(300)), v)
    g.native_serve_max_batch = 0
    k1, d1 = g.batch_search(q, 7, ef=30)
    k2, d2 = g.batch_search(q, 7, ef=30)
    assert k1 == k2
    np.testing.assert_array_equal(d1, d2)
    jg = hnsw_tpu.Graph(seed=0)
    jg.batch_add(list(range(300)), v)
    jg.native_serve_max_batch = 0
    assert k1 == jg.batch_search(q, 7, ef=30)[0]


def test_bulk_build_deterministic():
    v = make_vectors(500, 16, seed=104)
    g1 = Graph(seed=11, device="cpu")
    g1.build(list(range(500)), v, wave=128)
    g2 = Graph(seed=11, device="cpu")
    g2.build(list(range(500)), v, wave=128)
    np.testing.assert_array_equal(g1.host.neighbors, g2.host.neighbors)
    np.testing.assert_array_equal(g1.host.levels, g2.host.levels)
    assert g1.host.entry == g2.host.entry
    jg = hnsw_tpu.Graph(seed=11)
    jg.build(list(range(500)), v, wave=128)
    np.testing.assert_array_equal(g1.host.neighbors, jg.host.neighbors)
    np.testing.assert_array_equal(g1.host.levels, jg.host.levels)
    assert g1.host.entry == jg.host.entry


def test_mixed_ops_stay_consistent():
    rng = np.random.default_rng(105)
    v = rng.standard_normal((600, 12)).astype(np.float32)
    g = Graph(seed=0, device="cpu")
    live = set()
    for i in range(300):
        g.add(i, v[i])
        live.add(i)
    for step in range(150):
        op = step % 5
        if op in (0, 1) and len(live) < 600:
            nxt = max(live) + 1 if live else 0
            if nxt < 600:
                g.add(nxt, v[nxt])
                live.add(nxt)
        elif op == 2 and len(live) > 10:
            victim = min(live)
            assert g.delete(victim)
            live.discard(victim)
        else:
            q = rng.standard_normal(12).astype(np.float32)
            res = g.search(q, 5)
            assert all(k in live for k, _ in res)
    assert len(g) == len(live)


def _line_graph():
    """65,536 nodes on a line, layer 0 joined to +-8 neighbors, every 64th
    node on layer 1 joined to +-8 strided neighbors (coordinates centred
    at 0: the Gram-based l2 epilogue cancels at |x| ~ 1e4)."""
    cap, d, m = 65536, 8, 16
    xs = np.arange(cap, dtype=np.float32) - cap // 2
    vecs = np.zeros((cap, d), np.float32)
    vecs[:, 0] = xs
    vecs[:, 1] = 1.0
    sq = np.sum(vecs * vecs, axis=1)
    nb = np.full((2, cap, m), -1, np.int32)
    offs = np.array([o for o in range(-8, 9) if o != 0][:m])
    idx = np.arange(cap, dtype=np.int64)[:, None] + offs[None, :]
    np.clip(idx, 0, cap - 1, out=idx)
    nb[0] = idx
    coarse = np.arange(0, cap, 64)
    cidx = coarse[:, None] + offs[None, :] * 64
    np.clip(cidx, 0, cap - 1, out=cidx)
    nb[1, coarse] = cidx
    levels = np.zeros(cap, np.int32)
    levels[coarse] = 1
    return cap, d, vecs, sq, nb, levels


def test_hash_visited_path_large_cap():
    """The 65,536-node line graph (the JAX search switches to a hashed
    visited table at this size; the port keeps no visited set): exact
    neighbors, equal to the JAX search's."""
    import jax.numpy as jnp
    from hnsw_tpu.core.search import search_graph as jsearch
    from hnsw_tpu.core.state import DeviceGraph as JDeviceGraph
    cap, d, vecs, sq, nb, levels = _line_graph()
    g = DeviceGraph(vectors=torch.from_numpy(vecs),
                    sq_norms=torch.from_numpy(sq),
                    neighbors=torch.from_numpy(nb),
                    levels=torch.from_numpy(levels),
                    alive=torch.ones(cap, dtype=torch.bool),
                    entry=torch.tensor(cap // 2, dtype=torch.int32))
    rng = np.random.default_rng(7)
    targets = rng.integers(cap // 2 - 3000, cap // 2 + 3000, 16)
    q = np.zeros((16, d), np.float32)
    q[:, 0] = targets - cap // 2
    q[:, 1] = 1.0
    kw = dict(k=5, ef=32, metric="l2", max_hops=4096, expand=4)
    dists, ids = search_graph(g, torch.from_numpy(q), **kw)
    ids = ids.numpy()
    for i, t in enumerate(targets):
        assert ids[i, 0] == t, (t, ids[i])
        assert set(ids[i]).issubset(set(range(t - 8, t + 9)))
    jg = JDeviceGraph(vectors=jnp.asarray(vecs), sq_norms=jnp.asarray(sq),
                      neighbors=jnp.asarray(nb), levels=jnp.asarray(levels),
                      alive=jnp.ones(cap, bool),
                      entry=jnp.asarray(np.int32(cap // 2)))
    jd, ji = jsearch(jg, jnp.asarray(q), **kw)
    np.testing.assert_array_equal(ids, np.asarray(ji))
    np.testing.assert_allclose(dists.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-5)


def test_random_op_fuzz_with_checkpoints(tmp_path):
    """Seeded random batch adds, overwrites, deletes, batch deletes,
    searches and checkpoint round trips keep the graph consistent with a
    plain dict model at every step."""
    rng = np.random.default_rng(321)
    d = 10
    pool = rng.standard_normal((800, d)).astype(np.float32)
    g = Graph(seed=0, device="cpu")
    model = {}
    next_key = 0
    path = str(tmp_path / "fuzz.npz")
    for step in range(60):
        op = int(rng.integers(0, 6))
        if op == 0 and next_key < 700:      # batch add
            nb = int(rng.integers(1, 40))
            ks = list(range(next_key, min(next_key + nb, 700)))
            g.batch_add(ks, pool[ks])
            model.update({kk: kk for kk in ks})
            next_key = ks[-1] + 1
        elif op == 1 and model:             # duplicate overwrite
            kk = int(rng.choice(list(model)))
            g.add(kk, pool[(kk + 13) % 800])
            model[kk] = (kk + 13) % 800
        elif op == 2 and len(model) > 5:    # single delete
            kk = int(rng.choice(list(model)))
            assert g.delete(kk)
            del model[kk]
        elif op == 3 and len(model) > 20:   # batch delete
            ks = [int(x) for x in
                  rng.choice(list(model), size=5, replace=False)]
            assert all(g.batch_delete(ks))
            for kk in ks:
                del model[kk]
        elif op == 4 and model:             # checkpoint round trip
            save_graph(g, path)
            g = load_graph(path, device="cpu")
        else:                               # search
            q = rng.standard_normal(d).astype(np.float32)
            res = g.search(q, 5)
            assert all(k in model for k, _ in res)
            assert len(res) == min(5, len(model))
        assert len(g) == len(model)
    for kk in list(model)[:20]:
        np.testing.assert_allclose(g.lookup(kk), pool[model[kk]], rtol=1e-6)
        hit = g.search(pool[model[kk]], 1)[0]
        assert hit[0] == kk and hit[1] < 1e-4
    # the last checkpoint opens in the JAX package with the same keys
    save_graph(g, path)
    jg = hnsw_tpu.load_graph(path)
    assert sorted(jg.keys()) == sorted(model)
