"""Device graph layouts: hnsw_tpu_torch.core against hnsw_tpu.core on the CPU.

Every serving layout of ``DeviceGraph`` — fp16 / bf16 stores, the int8
traversal store with and without device vectors, int8 / fp16 / narrow
neighbor blocks, dense-split and compact upper layers:

* ``from_host`` gives every field equal to JAX's (int8, fp16 and bf16
  bit for bit; the compact tuple layer by layer);
* ``device_graph_from_numpy`` carries JAX's fields into the port equal
  to the port's own ``from_host``;
* the f32 rerank of the pool head is skipped where the int8 capacity
  mode leaves only a placeholder for the vectors.

``tests/test_torch_layout_search.py`` serves a graph in each layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
from hnsw_tpu.core import search as jsearch  # noqa: E402
from hnsw_tpu.core import state as jstate  # noqa: E402
from hnsw_tpu_torch.convert import device_graph_from_numpy  # noqa: E402
from hnsw_tpu_torch.core import search as tsearch  # noqa: E402
from hnsw_tpu_torch.core import state as tstate  # noqa: E402

#: name -> (JAX from_host kwargs, port from_host kwargs)
LAYOUTS = {
    "fp16-store": ({"store_dtype": np.float16},
                   {"store_dtype": np.float16}),
    "bf16-store": ({"store_dtype": jnp.bfloat16},
                   {"store_dtype": "bfloat16"}),
    "int8-store": ({"quantize": True}, {"quantize": True}),
    "quantized": ({"quantize": True, "hbm_vectors": False},
                  {"quantize": True, "hbm_vectors": False}),
    "blocks-int8": ({"block_layout": True, "block_dtype": "int8"},
                    {"block_layout": True, "block_dtype": "int8"}),
    "blocks-fp16": ({"block_layout": True, "block_dtype": "float16"},
                    {"block_layout": True, "block_dtype": "float16"}),
    "blocks-auto-narrow": ({"block_layout": True, "block_m": 5},
                           {"block_layout": True, "block_m": 5}),
    "split": ({"split_layers": True, "upper_m": 4},
              {"split_layers": True, "upper_m": 4}),
    "compact": ({"split_layers": "compact", "upper_m": 4},
                {"split_layers": "compact", "upper_m": 4}),
}


def _data(seed, n, d=32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


def _np(x):
    """Tensor or JAX array -> numpy, bf16 as its int16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_fields_equal(tg, jg):
    for name, want in jg._asdict().items():
        got = getattr(tg, name)
        if want is None:
            assert got is None, name
        elif isinstance(want, tuple):
            assert isinstance(got, tuple) and len(got) == len(want), name
            for lyr, (a, b) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(_np(a), _np(b),
                                              f"{name}[{lyr}]")
        else:
            assert _np(got).dtype == _np(want).dtype, name
            np.testing.assert_array_equal(_np(got), _np(want), name)
    assert (tg.cap, tg.dim, tg.num_layers) == (jg.cap, jg.dim,
                                               jg.num_layers)
    for lyr in range(tg.num_layers):
        assert tg.layer_width(lyr) == jg.layer_width(lyr)


def _random_host(n=37, L=3, m=8, d=16, seed=5):
    r = np.random.default_rng(seed)
    vec = _data(seed + 1, n, d)
    sq = np.sum(vec * vec, axis=1)
    nb = r.integers(-1, n, (L, n, m)).astype(np.int32)
    lv = r.integers(-1, L, n).astype(np.int32)
    alive = r.random(n) > 0.2
    return vec, sq, nb, lv, alive, 4


def jax_fields(jg):
    return {k: (tuple(np.asarray(t) for t in v) if isinstance(v, tuple)
                else np.asarray(v))
            for k, v in jg._asdict().items() if v is not None}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_from_host_matches_jax_in_every_layout(layout):
    jkw, tkw = LAYOUTS[layout]
    host = _random_host()
    jg = jstate.from_host(*host, metric="l2", **jkw)
    tg = tstate.from_host(*host, metric="l2", device="cpu", **tkw)
    _assert_fields_equal(tg, jg)
    if layout == "quantized":
        assert tuple(tg.vectors.shape) == (1, 16) and tg.cap == 64
    if layout == "compact":
        ids = torch.arange(tg.cap)
        for lyr in range(1, tg.num_layers):
            np.testing.assert_array_equal(
                tg.gather_neighbors(lyr, ids).numpy(),
                np.asarray(jg.gather_neighbors(lyr, jnp.arange(jg.cap))))
        with pytest.raises(ValueError, match="compact"):
            tg.layer_neighbors(1)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_device_graph_from_numpy_round_trips(layout):
    jkw, tkw = LAYOUTS[layout]
    host = _random_host(seed=7)
    jg = jstate.from_host(*host, metric="cosine", **jkw)
    tg = device_graph_from_numpy(jax_fields(jg), "cpu")
    _assert_fields_equal(tg, jg)
    _assert_fields_equal(
        tstate.from_host(*host, metric="cosine", device="cpu", **tkw), jg)


def test_quantize_rows_and_block_fit_match_jax():
    v = _data(8, 300)
    v[3] = 0.0
    for a, b in zip(tstate.quantize_rows(v), jstate.quantize_rows(v)):
        np.testing.assert_array_equal(a, b)
    r = np.random.default_rng(9)
    clustered = (np.repeat(r.standard_normal((6, 24)) * 5, 200, axis=0)
                 + 0.01 * r.standard_normal((1200, 24))).astype(np.float32)
    for rows in (v, clustered):
        for metric in ("cosine", "l2"):
            assert tstate._int8_block_fit(rows, metric) == \
                jstate._int8_block_fit(rows, metric)


def built_graph():
    """One natively built graph (m=8, ml=0.06: three layers, 2000 x 32,
    tombstones) as from_host arguments per metric — prenormalized rows
    for cosine, as Graph.device_graph lays them out — and 48 queries."""
    g = hnsw_tpu.Graph(m=8, ml=0.06, ef_construction=64, metric="l2",
                       seed=3)
    v = _data(1, 2000)
    g.build(list(range(len(v))), v, method="host")
    g.batch_delete(list(range(0, 2000, 50)))
    n = g.slots.capacity_used
    nb, lv, entry, _ = g.host.arrays()
    sq = g.store.sq_norms[:n]
    unit = g.store.vectors[:n] / np.sqrt(np.maximum(sq, 1e-30))[:, None]
    rest = (nb[:, :n], lv[:n], g.store.alive[:n], entry)
    return ({"cosine": (unit, np.ones_like(sq)) + rest,
             "l2": (g.store.vectors[:n], sq) + rest}, _data(2, 48))


def overlap_and_err(dj, ij, dt, it):
    """(share of ij's ids found in it, max |dist| difference over ids in
    both)."""
    hits, err = 0, 0.0
    for rdj, rij, rdt, rit in zip(dj, ij, dt, it):
        pos = {int(x): p for p, x in enumerate(rit) if x >= 0}
        for p, x in enumerate(rij):
            if x >= 0 and int(x) in pos:
                hits += 1
                err = max(err, abs(float(rdt[pos[int(x)]]) - float(rdj[p])))
    return hits / max(1, int((ij >= 0).sum())), err


@pytest.fixture(scope="module")
def built():
    return built_graph()


def test_rerank_guard_in_quantized_mode(built):
    """In the int8 capacity mode ``vectors`` is a [1, D] placeholder. The
    f32 rerank of the pool head must not run against it even when
    fast_math asks for it: gathering slot ids from a one-row table either
    fails (torch) or clamps every candidate to row 0 (JAX's gather)."""
    hosts, q = built
    jg = jstate.from_host(*hosts["l2"], metric="l2", quantize=True,
                          hbm_vectors=False)
    tg = device_graph_from_numpy(jax_fields(jg), "cpu")
    kw = dict(k=10, ef=48, metric="l2", expand=2, merge="sort",
              fast_math=True)
    dj, ij = jsearch.search_graph(jg, jnp.asarray(q), **kw)
    dt, it = tsearch.search_graph(tg, torch.from_numpy(q), **kw)
    ov, err = overlap_and_err(np.asarray(dj), np.asarray(ij), dt.numpy(),
                              it.numpy())
    assert ov >= 0.99 and err <= 1e-5, (ov, err)
    # traversal-ordered, distinct results: nothing collapsed onto row 0
    assert np.all(np.diff(dt.numpy(), axis=1) >= 0)
    assert len(np.unique(it.numpy()[:, 0])) > 1
