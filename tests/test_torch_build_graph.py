"""Graph.build(method="device"), refine and delete repair through
hnsw_tpu_torch on the CPU, against hnsw_tpu on the same data and seeds.

* Multi-wave builds sample levels equal to JAX's bit for bit (one
  ``rng.random(n)`` draw from the same seed), link upper layers only to
  their members, and serve recall@10 within 0.05 of JAX's build on the
  same data.
* The rest is the Graph contract of tests/test_build.py and
  tests/test_compact_upper.py run through the port, with the JAX
  package's thresholds.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu_torch.config import GraphConfig  # noqa: E402
from hnsw_tpu_torch.ops.topk import np_exact_topk  # noqa: E402


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


def _data(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)) \
        .astype(np.float32)


def _graph(**kw):
    return hnsw_tpu_torch.Graph(device="cpu", **kw)


def _recall(g, q, gt, k=10, ef=80):
    g.native_serve_max_batch = 0
    keys, _ = g.batch_search(q, k, ef=ef)
    return float(np.mean([len({kk for kk in keys[i] if kk is not None}
                              & set(map(int, gt[i][:k]))) / k
                          for i in range(len(gt))]))


def test_multi_wave_build_levels_and_recall_match_jax():
    n, d = 1000, 32
    v = _data(40, n, d)
    q = _data(41, 40, d)
    _, gt = np_exact_topk(q, v, 10, "cosine")
    j = hnsw_tpu.Graph(m=8, seed=0)
    t = _graph(m=8, seed=0)
    for g in (j, t):
        g.build(list(range(n)), v, method="device", wave=256)
    np.testing.assert_array_equal(t.host.levels[:n], j.host.levels[:n])
    assert (t.host.entry, t.host.top) == (j.host.entry, j.host.top)
    # the port's upper rows link only layer members (fault F9)
    nb, lv = t.host.neighbors[:, :n], t.host.levels[:n]
    for layer in range(1, nb.shape[0]):
        edge = nb[layer] >= 0
        assert not edge[lv < layer].any()
        assert (lv[np.where(edge, nb[layer], 0)][edge] >= layer).all()
    r_j, r_t = _recall(j, q, gt), _recall(t, q, gt)
    assert r_t >= r_j - 0.05, (r_j, r_t)
    assert r_t >= 0.85
    assert t.search(v[700], 1)[0][0] == 700


def test_scoped_refine_recovers_post_delete_recall(tmp_path):
    n, d, k = 800, 24, 10
    v = _data(93, n, d)
    q = _data(94, 48, d)
    doomed = np.random.default_rng(7).choice(n, n // 4, replace=False)
    keep = np.ones(n, bool)
    keep[doomed] = False

    def recall(g, mask):
        live = np.flatnonzero(mask)
        _, li = np_exact_topk(q, v[live], k, "cosine")
        return _recall(g, q, live[li], k, ef=96)

    g1 = _graph(ef_construction=100)
    g1.build(list(range(n)), v, method="device", wave=512)
    pre = recall(g1, np.ones(n, bool))
    hnsw_tpu_torch.save_graph(g1, str(tmp_path / "g.npz"))
    g2 = hnsw_tpu_torch.load_graph(str(tmp_path / "g.npz"), device="cpu")
    g1.batch_delete([int(s) for s in doomed])
    post_plain = recall(g1, keep)
    g2.batch_delete([int(s) for s in doomed], refine=True)
    post_refined = recall(g2, keep)
    assert post_refined >= post_plain - 0.02, (post_plain, post_refined)
    assert post_refined >= 0.95 * pre, (pre, post_plain, post_refined)
    keys, _ = g2.batch_search(q, k, ef=96)
    assert not {kk for row in keys for kk in row} & set(doomed.tolist())


@pytest.mark.parametrize("variant", ["reverse_diversify", "block_m",
                                     "float16"])
def test_build_variants_keep_quality(variant):
    """reverse_diversify (heuristic re-selection of rows hit by reverse
    edges), the quant-descent build with narrow int8 blocks, and the fp16
    descent store each serve within the parity band of the default
    device build."""
    n, d, k = 600, 24, 10
    v = _data(50, n, d)
    q = _data(51, 40, d)
    _, gt = np_exact_topk(q, v, k, "cosine")
    g0 = _graph(ef_construction=100)
    g0.build(list(range(n)), v, method="device", wave=256)
    if variant == "reverse_diversify":
        g1 = hnsw_tpu_torch.Graph(config=GraphConfig(
            seed=0, ef_construction=100, reverse_diversify=True),
            device="cpu")
        g1.build(list(range(n)), v, method="device", wave=256)
    elif variant == "block_m":
        g1 = _graph(ef_construction=100)
        g1.build(list(range(n)), v, method="device", wave=256,
                 quant_descent=True, block_m=8)
    else:
        g1 = _graph(ef_construction=100)
        g1.build(list(range(n)), v, method="device", wave=256,
                 descent_dtype="fp16")
    r0, r1 = _recall(g0, q, gt), _recall(g1, q, gt)
    assert r1 >= r0 - (0.03 if variant == "float16" else 0.1), (r0, r1)
    assert r1 >= 0.85
    if variant == "block_m":
        # serving with narrow blocks: the capacity trade
        g1.fast_math = True
        g1.block_layout = True
        g1.block_m = 8
        assert g1.device_graph().nbr_blocks.shape[1] == 8
        assert _recall(g1, q, gt) >= 0.6


def test_device_build_wave_clamped():
    v = _data(80, 500, 16)
    g = _graph()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        g.build(list(range(500)), v, method="device", wave=32768)
    assert any("clamped" in str(x.message) for x in w)
    assert g.search(v[7], 1)[0][0] == 7
