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
