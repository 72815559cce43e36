"""The capacity and serving modes, and the hybrid tiers, on the card against
the same code on the CPU.

Marked ``cuda``: skipped where there is no NVIDIA GPU (decided inside the
fixture, never at import). Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda_modes.py``.

The same seeded inputs go through an index on the card and one on the
CPU. The scans' f32 sums run in another order on the two devices, so a
near tie may resolve differently: ids overlap >= 0.99; both rerank with
the same numpy code, so matched distances agree within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hnsw_tpu_torch  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these paths run on the card")
    return torch.device("cuda")


def _data(seed, n, d=48):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


def _agree(a, b):
    (da, ia), (db, ib) = a, b
    hits = sum(len(set(x) & set(y)) for x, y in zip(ia, ib))
    assert hits / ib.size >= 0.99
    same = ia == ib
    np.testing.assert_allclose(da[same], db[same], atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp16"])
def test_capacity_rungs_on_card_match_cpu(cuda, dtype):
    v = _data(1, 70_000)
    batches = [_data(2 + b, 300) for b in range(3)]
    out = {}
    for dev in (cuda, "cpu"):
        idx = hnsw_tpu_torch.ExactIndex(metric="l2", hbm_dtype=dtype,
                                        device=dev)
        idx.batch_add(list(range(len(v))), v)
        out[str(dev)] = [idx.batch_search_slots(b, 10) for b in batches]
        assert idx._dev[0].device.type == torch.device(dev).type
        streamed = list(idx.batch_search_stream(iter(batches), 10))
        for (ds, is_), (d, i) in zip(streamed, out[str(dev)]):
            np.testing.assert_array_equal(is_, i)
            np.testing.assert_array_equal(ds, d)
    for a, b in zip(out["cuda"], out["cpu"]):
        _agree(a, b)


@pytest.mark.parametrize("mode", ["blocks", "float16", "quantized",
                                  "compact"])
def test_graph_modes_on_card_match_cpu(cuda, mode):
    v = _data(3, 6000)
    q = _data(4, 64)
    out = []
    for dev in (cuda, "cpu"):
        g = hnsw_tpu_torch.Graph(m=8, ef_construction=64, seed=0,
                                 device=dev)
        g.build(list(range(len(v))), v, method="host")
        g.native_serve_max_batch = 0
        if mode == "blocks":
            g.fast_math = True
            g.block_layout = True
            g.entry_mode = "pivots"
        elif mode == "compact":
            g.split_layers = "compact"
        else:
            g.hbm_mode = mode
        out.append(g.batch_search_slots(q, 10, ef=64))
    _agree(*out)


def _agree_keys(a, b, atol=1e-4):
    """Keyed results (rows of keys, distance array) of the card against
    the CPU: ids overlap >= 0.99, matched distances within ``atol``."""
    (ka, da), (kb, db) = a, b
    hits = sum(len(set(x) & set(y)) for x, y in zip(ka, kb))
    assert hits / db.size >= 0.99
    for ra, rb, xa, xb in zip(ka, kb, da, db):
        at = dict(zip(rb, xb))
        for key, dist in zip(ra, xa):
            if key in at:
                assert abs(dist - at[key]) <= atol


def test_ivf_on_card_matches_cpu(cuda):
    """One trained index, carried to both devices (k-means on the card
    sums in another order, so each device would train other centroids)."""
    from hnsw_tpu_torch.convert import ivf_from_jax
    v = _data(5, 20_000)
    q = _data(6, 256)
    cpu = hnsw_tpu_torch.IVFIndex(num_partitions=64, nprobe=8, device="cpu")
    cpu.build(list(range(len(v))), v)
    card = ivf_from_jax(cpu, device=cuda)
    out_card = card.batch_search(q, 10)
    assert card._dev[0].device.type == "cuda"
    _agree_keys(out_card, cpu.batch_search(q, 10))
    # trained on the card, a full probe is the exact answer
    own = hnsw_tpu_torch.IVFIndex(num_partitions=64, nprobe=64, device=cuda)
    own.build(list(range(len(v))), v)
    from hnsw_tpu_torch.ops.topk import np_exact_topk
    gd, gi = np_exact_topk(q, v, 10, "cosine")
    _agree_keys(own.batch_search(q, 10), ([list(r) for r in gi], gd))


def test_lsh_on_card_matches_cpu(cuda):
    v = _data(7, 20_000)
    q = v[:200] + 0.01 * _data(8, 200)
    out = []
    for dev in (cuda, "cpu"):
        idx = hnsw_tpu_torch.LSHIndex(num_tables=6, num_bits=8, device=dev)
        idx.batch_add(list(range(len(v))), v)
        out.append(idx.batch_search(q, 10))
        assert idx._dev[0].device.type == torch.device(dev).type
    _agree_keys(*out)


def test_hybrid_on_card_matches_cpu(cuda):
    v = _data(9, 6000)
    q = _data(10, 64)
    out, exact = [], []
    for dev in (cuda, "cpu"):
        h = hnsw_tpu_torch.HybridIndex(
            hnsw_tpu_torch.HybridConfig(exact_threshold=500, metric="l2"),
            device=dev)
        h.batch_add(list(range(len(v))), v)
        out.append(h.batch_search(q, 10))
        assert h.stats.last_strategy == "hnsw"
        exact.append(h.batch_search(q, 10, target_recall=1.0))
    _agree_keys(*out)
    _agree_keys(*exact)


def test_adaptive_exact_arm_launches_the_screen_kernel(cuda):
    from hnsw_tpu_torch.ops import exact_screen as es
    v = _data(11, 40_000, d=64)
    a = hnsw_tpu_torch.AdaptiveHybridIndex(
        hnsw_tpu_torch.HybridConfig(exact_threshold=500, metric="l2"),
        device=cuda)
    a.exact.batch_add(list(range(len(v))), v)      # the exact arm alone
    before = dict(es.launches_by_route)
    rows = a._run_batch("exact", v[:256], 10)
    assert [r[0][0] for r in rows] == list(range(256))
    assert es.launches_by_route["wgmma"] > before["wgmma"]
    probe = a._probe_oracle(v[:32], 10)
    assert [r[0] for r in probe] == list(range(32))
    assert es.launches_by_route["wgmma"] > before["wgmma"] + 1
    assert a.fallback_errors == 0


def _equal_up_to_ties(a, b, tol=1e-5):
    """Equal ids, except where two neighbours whose distances agree within
    ``tol`` swapped places (f32 sums in another order); distances of
    equal ids within 1e-5."""
    (da, ia), (db, ib) = a, b
    diff = ia != ib
    assert np.all(np.abs(da[diff] - db[diff]) <= tol), int(diff.sum())
    assert diff.mean() <= 0.001
    np.testing.assert_allclose(da[~diff], db[~diff], atol=1e-5, rtol=0)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_streaming_scan_through_the_kernel_equals_plain(cuda, metric,
                                                        tmp_path,
                                                        monkeypatch):
    """float32 chunks of 40,000 rows take K1, the short last chunk the
    plain scan; the same index with every chunk on the plain scan, and
    the same index on the CPU, give the same results. The device chunk
    cache serves the same ids from pinned chunks."""
    from hnsw_tpu_torch.index import streaming as sm
    from hnsw_tpu_torch.ops import exact_screen as es
    from hnsw_tpu_torch.ops.topk import exact_topk
    v = _data(21, 90_000, d=64)
    q = _data(22, 300, d=64)
    dead = np.arange(0, len(v), 7)

    def index(dev, sub, **kw):
        idx = sm.StreamingExactIndex(str(tmp_path / sub), metric=metric,
                                     chunk_rows=40_000, device=dev, **kw)
        idx.batch_add(list(range(len(v))), v)
        idx.batch_delete(dead.tolist())
        return idx

    out = []
    for j, dev in enumerate((cuda, torch.device("cpu"))):
        idx = index(dev, f"d{j}", hbm_cache_bytes=1 << 30)
        before = es.launches
        out.append(idx.batch_search_slots(q, 10))
        assert es.launches - before == (2 if dev.type == "cuda" else 0)
        assert len(idx._cache) == 2
        assert all(e[0].device.type == dev.type
                   for e in idx._cache.values())
        cached = idx.batch_search_slots(q, 10)
        np.testing.assert_array_equal(cached[1], out[j][1])
    assert not np.isin(out[0][1], dead).any()
    monkeypatch.setattr(sm, "exact_scan",
                        lambda qq, vv, ss, aa, **kw: exact_topk(
                            qq, vv, ss, aa, **kw))
    plain = index(cuda, "plain")
    before = es.launches
    _equal_up_to_ties(out[0], plain.batch_search_slots(q, 10))
    assert es.launches == before
    _equal_up_to_ties(*out)


@pytest.mark.parametrize("dt", ["bf16", "fp16", "int8"])
def test_streaming_reduced_rungs_on_card_match_cpu(cuda, dt, tmp_path):
    from hnsw_tpu_torch.index.streaming import StreamingExactIndex
    v = _data(23, 50_000)
    q = _data(24, 200)
    out = []
    for j, dev in enumerate((cuda, "cpu")):
        idx = StreamingExactIndex(
            str(tmp_path / f"d{j}"), metric="l2", chunk_rows=20_000,
            stream_dtype=dt, device=dev)
        idx.batch_add(list(range(len(v))), v)
        out.append(idx.batch_search_slots(q, 10))
    _agree(*out)


def test_batch_search_exact_through_the_kernel_equals_plain(cuda,
                                                            monkeypatch):
    """FacetedGraph's masked exact scan on a 40,000-row graph on the card
    launches K1 once a batch and equals the plain exact_topk scan, f32,
    under a 1% filter and without one."""
    import hnsw_tpu_torch.facets as fm
    from hnsw_tpu_torch.ops import exact_screen as es
    from hnsw_tpu_torch.ops.topk import exact_topk
    v = _data(25, 40_000, d=64)
    q = _data(26, 100, d=64)
    g = hnsw_tpu_torch.Graph(m=8, ef_construction=32, device=cuda)
    g.build(list(range(len(v))), v, method="host")
    g.fast_math = True                       # not inherited by the scan
    fg = hnsw_tpu_torch.FacetedGraph(g)
    for i in range(len(v)):
        fg.store.add(i, [hnsw_tpu_torch.Facet("b", i % 100)])
    flt = [hnsw_tpu_torch.EqualityFilter("b", 3)]

    def run():
        res = [fg.batch_search_exact(q, 10, f) for f in (flt, ())]
        return [(np.array([[d for _, d in r] for r in rows], np.float32),
                 np.array([[kk for kk, _ in r] for r in rows]))
                for rows in res]

    before = es.launches
    kern = run()
    assert es.launches - before == 2
    assert all(int(kk) % 100 == 3 for kk in kern[0][1].ravel())
    monkeypatch.setattr(fm, "exact_scan", lambda qq, vv, ss, aa, **kw:
                        exact_topk(qq, vv, ss, aa, **kw))
    for a, b in zip(kern, run()):
        _equal_up_to_ties(a, b)
