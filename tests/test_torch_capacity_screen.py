"""The capacity screen (the port of K3, the capacity scan) on the CPU.

The capacity modes' scan over a reduced table (int8 rows with per-row
scales, bf16, fp16) is ``ops/exact_screen.capacity_scan``: the CUDA
screen of ``csrc/exact_screen.cu`` with the table's store where
``capacity_applies`` (a CUDA table of any size, min(kk, N) <= 256, a
built-in metric), else the plain ``ops/topk.quantized_topk_candidates``. The
kernel runs only on the card (tests/test_torch_cuda_kernels.py); here:

* the plain version against ``hnsw_tpu.ops.topk.quantized_topk_candidates``
  on the same seeded numpy inputs (JAX's CPU path selects with the exact
  ``lax.top_k``, so both sides select exactly): every store x the four
  metrics x D in {7, 32, 50}, a masked range, kk 1 / 14 / 26, one chunk
  and several. Candidate id overlap >= 0.99 (the products are exact in
  f32, the sums run in another order, so a near tie at the kk boundary
  may resolve differently) and matched distances within 1e-5;
* ties go to the lower id (duplicated integer rows, exact sums: ids and
  distances equal JAX's), masked and missing slots are (INF_DIST, -1);
* the dispatch: ``capacity_applies`` is false on CPU tables and off its
  limits, ``capacity_scan`` on the CPU is the plain version and counts no
  launch, ``capacity_route`` picks the producer by row pitch and
  alignment and "bf16_ws" (the warp-specialised bf16 kernel of int8 and
  bf16 tables) where its lists fit registers (kk <= 32) and its block
  shared memory (``ws_smem_bytes``, held to the source's constants and to
  sums by hand), launches are counted by route,
  the wrapper's checks refuse what the kernel does not take;
* the plain version's selection (``ops/topk.topk_keyed``: a top-k over
  unique int64 keys) equals a stable sort, ties and signs included;
* the callers: ``ExactIndex`` per ``hbm_dtype``, ``StreamingExactIndex``'s
  reduced chunks and ``sharded_quantized_candidates`` against the JAX
  objects: overlap >= 0.99, matched distances within 1e-5 (final results
  reranked in f32 by the same numpy code in both packages).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
from hnsw_tpu.index.streaming import (  # noqa: E402
    StreamingExactIndex as JStreamingExactIndex)
from hnsw_tpu.ops import topk as jtopk  # noqa: E402
from hnsw_tpu.parallel import sharded as jsh  # noqa: E402
import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu_torch.index.streaming import StreamingExactIndex  # noqa: E402
from hnsw_tpu_torch.ops import distance as tdist  # noqa: E402
from hnsw_tpu_torch.ops import exact_screen as es  # noqa: E402
from hnsw_tpu_torch.ops import topk as ttopk  # noqa: E402
from hnsw_tpu_torch.ops.distance import INF_DIST  # noqa: E402
from hnsw_tpu_torch.parallel import sharded as tsh  # noqa: E402

STORES = ["int8", "bf16", "fp16"]
METRICS = ["cosine", "l2", "sqeuclidean", "dot"]
N = 1500


def _data(seed, n, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


def _tables(v, store, unit_scales=False):
    """(jax table, jax scales, torch table, torch scales): ExactIndex's
    per-row int8 quantisation (or scales of 1 for integer rows), or a
    bf16 / fp16 cast."""
    if store == "int8":
        if unit_scales:
            s = np.ones(len(v), np.float32)
        else:
            amax = np.max(np.abs(v), axis=1)
            s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(v / s[:, None]), -127, 127).astype(np.int8)
        return (jnp.asarray(q), jnp.asarray(s), torch.from_numpy(q),
                torch.from_numpy(s))
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "fp16": (jnp.float16, torch.float16)}[store]
    return jnp.asarray(v, jdt), None, torch.from_numpy(v).to(tdt), None


def _both(q, v, valid, store, kk, metric, chunk, unit_scales=False):
    sq = np.sum(v * v, axis=1).astype(np.float32)
    jt, js, tt, ts = _tables(v, store, unit_scales)
    dj, ij = jtopk.quantized_topk_candidates(
        jnp.asarray(q), jt, js, jnp.asarray(sq), jnp.asarray(valid), kk=kk,
        metric=metric, chunk=chunk)
    dt, it = ttopk.quantized_topk_candidates(
        torch.from_numpy(q), tt, ts, torch.from_numpy(sq),
        torch.from_numpy(valid), kk=kk, metric=metric, chunk=chunk)
    return np.asarray(dj), np.asarray(ij, np.int64), dt.numpy(), it.numpy()


def _overlap(a, b):
    return sum(len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
               for x, y in zip(a, b)) / max(1, int((b >= 0).sum()))


def _matched_err(da, ia, db, ib):
    err = 0.0
    for ra, rb, xa, xb in zip(ia, ib, da, db):
        pos = {int(i): j for j, i in enumerate(rb) if i >= 0}
        for j, i in enumerate(ra):
            if i >= 0 and int(i) in pos:
                err = max(err, abs(float(xa[j]) - float(xb[pos[int(i)]])))
    return err


#: (D, kk, chunk): each D with two of kk 1 / 14 / 26, one chunk (65,536)
#: and several (256 or 512 rows: 3-6 chunks, the last one short)
SHAPES = [(7, 1, 65536), (7, 26, 256), (32, 14, 65536), (32, 26, 512),
          (50, 1, 512), (50, 14, 256)]


@pytest.mark.parametrize("d,kk,chunk", SHAPES)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("store", STORES)
def test_plain_scan_matches_jax(store, metric, d, kk, chunk):
    v = _data(1 + d, N, d)
    q = _data(2 + d, 16, d)
    valid = np.ones(N, bool)
    valid[100:160] = False
    dj, ij, dt, it = _both(q, v, valid, store, kk, metric, chunk)
    assert it.shape == ij.shape == (16, kk) and it.dtype == np.int64
    assert not np.isin(it, np.arange(100, 160)).any()
    assert np.all(np.diff(dt, axis=1) >= 0)
    assert _overlap(it, ij) >= 0.99
    assert _matched_err(dt, it, dj, ij) <= 1e-5


@pytest.mark.parametrize("metric", ["sqeuclidean", "dot"])
@pytest.mark.parametrize("store", STORES)
def test_ties_go_to_the_lower_id(store, metric):
    """300 integer rows, each also at three later positions (several
    chunks apart): every sum is exact, so equal distances are equal bit
    for bit in both packages. Ids and distances equal JAX's, and within
    a run of equal distances the ids ascend."""
    r = np.random.default_rng(30)
    base = r.integers(-6, 7, (300, 16)).astype(np.float32)
    v = np.concatenate([base, base[::-1], base, base[::-1]])
    q = r.integers(-3, 4, (12, 16)).astype(np.float32)
    valid = np.ones(len(v), bool)
    dj, ij, dt, it = _both(q, v, valid, store, 26, metric, 256,
                           unit_scales=True)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    for row_d, row_i in zip(dt, it):
        eq = row_d[1:] == row_d[:-1]
        assert eq.any()
        assert np.all(row_i[1:][eq] > row_i[:-1][eq])


@pytest.mark.parametrize("chunk", [65536, 256])
@pytest.mark.parametrize("store", STORES)
def test_masked_and_missing_slots_are_inf_and_minus_one(store, chunk):
    """Six valid rows of 1,000 and kk = 26: six candidates, then
    (INF_DIST, -1); kk past N gives N columns."""
    v = _data(31, 1000, 32)
    q = _data(32, 9, 32)
    valid = np.zeros(1000, bool)
    valid[[3, 250, 251, 600, 777, 999]] = True
    dj, ij, dt, it = _both(q, v, valid, store, 26, "cosine", chunk)
    assert it.shape == (9, 26)
    np.testing.assert_array_equal(np.sort(it[:, :6], axis=1),
                                  np.tile([3, 250, 251, 600, 777, 999],
                                          (9, 1)))
    assert np.all(it[:, 6:] == -1) and np.all(dt[:, 6:] == INF_DIST)
    np.testing.assert_array_equal(it[:, :6], ij[:, :6])
    np.testing.assert_allclose(dt[:, :6], dj[:, :6], atol=1e-5, rtol=0)
    _, _, dt, it = _both(q[:2], v[:20], np.ones(20, bool), store, 26,
                         "l2", chunk)
    assert it.shape == (2, 20) and (it >= 0).all()


def _fake_table(dtype, cuda=True):
    return types.SimpleNamespace(dtype=dtype, is_cuda=cuda)


F32 = torch.float32


@pytest.mark.parametrize("n,kk,metric,dtype,scales,want", [
    (32768, 26, "l2", torch.int8, F32, True),
    (10_000_000, 128, "cosine", torch.bfloat16, None, True),
    (40_000, 1, "dot", torch.float16, None, True),
    (32767, 26, "l2", torch.int8, F32, True),        # no row switch
    (40_000, 257, "l2", torch.bfloat16, None, False),  # past CAPACITY_K_MAX
    (40_000, 256, "l2", torch.int8, F32, True),
    (200, 1000, "l2", torch.float16, None, True),
    (0, 26, "l2", torch.int8, F32, False),             # an empty table
    (40_000, 0, "l2", torch.bfloat16, None, False),
    (40_000, 14, "my_metric", torch.float16, None, False),
    (40_000, 26, "l2", torch.int8, None, False),       # int8 without scales
    (40_000, 26, "l2", torch.int8, torch.float64, False),
    (40_000, 14, "l2", torch.float16, F32, False),     # scales off int8
    (40_000, 14, "l2", torch.float32, None, False),    # K1's table
])
def test_capacity_applies_holds_only_within_its_limits(
        monkeypatch, n, kk, metric, dtype, scales, want):
    """A registered custom metric ("my_metric") takes the plain scan."""
    monkeypatch.setitem(tdist._registry, "my_metric", {
        "point": lambda a, b: 0.0, "pairwise": lambda q, v: q @ v.T})
    sc = None if scales is None else _fake_table(scales)
    assert es.capacity_applies(n, kk, metric, _fake_table(dtype), sc) is want
    # never on the CPU
    assert not es.capacity_applies(n, kk, metric, _fake_table(dtype, False),
                                   sc)


@pytest.mark.parametrize("store", STORES)
def test_capacity_scan_on_the_cpu_is_the_plain_version(store):
    v = _data(33, 40_000, 8)
    q = torch.from_numpy(_data(34, 5, 8))
    _, _, t, s = _tables(v, store)
    sq = torch.from_numpy(np.sum(v * v, axis=1))
    valid = torch.ones(40_000, dtype=torch.bool)
    assert not es.capacity_applies(40_000, 26, "l2", t, s)
    es.launches = es.capacity_launches = es.capacity_plain_on_cuda = 0
    es.capacity_launches_by_store.update(int8=0, bf16=0, fp16=0)
    d, i = es.capacity_scan(q, t, s, sq, valid, kk=26, metric="euclidean")
    dp, ip = ttopk.quantized_topk_candidates(q, t, s, sq, valid, kk=26,
                                             metric="l2")
    assert torch.equal(i, ip) and torch.equal(d, dp)
    assert es.launches == es.capacity_launches == 0
    assert es.capacity_plain_on_cuda == 0      # a CPU table is not counted
    assert es.capacity_launches_by_store == {"int8": 0, "bf16": 0,
                                             "fp16": 0}


def _view(dtype, n, d, off):
    """An [n, d] view whose base pointer is ``off`` bytes past 16-byte
    alignment."""
    size = torch.empty((), dtype=dtype).element_size()
    buf = torch.zeros(n * d + 32, dtype=dtype)
    skip = ((-buf.data_ptr()) % 16 + off) // size
    return buf[skip:skip + n * d].view(n, d)


@pytest.mark.parametrize("dtype,d,off,want", [
    (torch.int8, 128, 0, "bf16_ws"), (torch.int8, 16, 0, "bf16_ws"),
    (torch.int8, 64, 4, "wgmma_ld"), (torch.int8, 52, 0, "wgmma_ld"),
    (torch.int8, 50, 0, "wgmma_ld"), (torch.int8, 25, 0, "wgmma_ld"),
    (torch.int8, 64, 1, "wgmma_ld"), (torch.bfloat16, 128, 0, "bf16_ws"),
    (torch.bfloat16, 8, 0, "bf16_ws"), (torch.float16, 50, 0, "wgmma_ld"),
    (torch.float16, 64, 8, "wgmma_ld"), (torch.float16, 7, 0, "wgmma_ld"),
    (torch.bfloat16, 64, 2, "wgmma_ld"), (torch.float16, 128, 0, "wgmma")])
def test_capacity_route_by_row_pitch_and_alignment(dtype, d, off, want):
    """At kk 14: TMA-aligned int8 and bf16 tables take "bf16_ws", fp16
    K1's kernel through TMA; any other pitch or offset ordinary loads."""
    t = _view(dtype, 40, d, off)
    q = _view(torch.float32, 3, d, 0)
    assert t.data_ptr() % 16 == off and t.is_contiguous()
    assert es.capacity_route(q, t, 14) == want
    assert set(es.CAPACITY_ROUTES) == {"wgmma", "wgmma_ld", "bf16_ws"}


@pytest.mark.parametrize("dtype,d,kk,n,want", [
    (torch.int8, 128, 26, 40, "bf16_ws"), (torch.int8, 128, 32, 40,
                                           "bf16_ws"),
    (torch.int8, 128, 33, 40, "wgmma"), (torch.int8, 128, 150, 400,
                                         "wgmma"),
    (torch.int8, 128, 150, 30, "bf16_ws"),      # min(kk, N) = 30 fits
    (torch.int8, 128, 256, 400, "wgmma"), (torch.bfloat16, 128, 14, 64,
                                           "bf16_ws"),
    (torch.bfloat16, 128, 33, 64, "wgmma"), (torch.int8, 64, 32, 100,
                                             "bf16_ws"),
    (torch.bfloat16, 16, 1, 100, "bf16_ws"), (torch.bfloat16, 192, 32, 40,
                                              "bf16_ws"),
    (torch.int8, 192, 26, 40, "bf16_ws"), (torch.int8, 256, 1, 40,
                                           "wgmma"),
    (torch.bfloat16, 256, 14, 40, "wgmma"), (torch.bfloat16, 960, 1, 40,
                                             "wgmma"),
    (torch.float16, 128, 1, 40, "wgmma")])
def test_capacity_route_takes_bf16_ws_where_its_block_fits(dtype, d, kk, n,
                                                           want):
    """"bf16_ws" takes an aligned int8 or bf16 table where its lists fit a
    warp's registers (min(kk, N) <= 32) and its ring and resident queries
    fit 227 KB of shared memory (D <= 192); past that, K1's kernel on
    TMA."""
    t = _view(dtype, n, d, 0)
    q = _view(torch.float32, 3, d, 0)
    assert es.capacity_route(q, t, kk) == want
    store = {torch.int8: "int8", torch.bfloat16: "bf16",
             torch.float16: "fp16"}[dtype]
    assert es.ws_applies(d, min(kk, n), store) == (want == "bf16_ws")


@pytest.mark.parametrize("d,store,want", [
    (128, "bf16", 136_256), (128, "int8", 151_920), (64, "int8", 78_192),
    (16, "bf16", 70_720), (192, "bf16", 201_792), (192, "int8", 225_648),
    (256, "bf16", 267_328), (256, "int8", 299_376)])
def test_ws_smem_bytes_by_hand(d, store, want):
    """The byte count, added up by hand: 1 KiB slack + 4 x 8 KiB query
    boxes a 64-wide k block + the ring (bf16 4 x 8 KiB, int8 3 x 8 KiB
    widened + 4 x 4 KiB raw, a k block) + 768 B of norms / mask / scales
    a ring stage + 1 KiB of query norms + 8 B a barrier; it fits 227 KB
    up to D = 192."""
    assert es.ws_smem_bytes(d, store) == want
    assert (want <= es.WS_SMEM_MAX) == es.ws_applies(d, 14, store)


def test_ws_constants_match_the_library_source():
    """ws_smem_bytes repeats csrc/exact_screen.cu's ws_smem_bytes; the
    constants it reads are the source's (the card's test holds the byte
    counts equal to the compiled library's)."""
    import re
    src = open(es.SOURCE).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);",
                             src).group(1).split("*")[-1].strip(" ()"))
    assert const("WS_NC") == es.WS_CONSUMERS
    assert const("WS_TC") == es.WS_TILE_COLUMNS
    assert const("WS_KB") == es.WS_KB
    assert const("WS_STAGES_BF16") == es.WS_STAGES["bf16"]
    assert const("WS_STAGES_I8") == es.WS_STAGES["int8"]
    assert const("WS_RAW") == es.WS_RAW
    assert const("WS_K_MAX") == es.WS_K_MAX
    assert "constexpr int WS_TQ = 64 * WS_NC;" in src
    assert "constexpr int WS_QBOX = 64 * 128;" in src
    assert "constexpr int WS_VBOX = WS_TC * 128;" in src
    assert "constexpr int WS_RBOX = WS_TC * WS_KB;" in src
    assert "constexpr int ERR_REGS = 90000;" in src
    assert es._ERR_REGS == 90000
    assert es.CAPACITY_ROUTES["bf16_ws"] == 4
    assert "WGMMA_WS = 4" in src


def test_capacity_launches_count_by_route(monkeypatch):
    """Each launch the wrapper makes adds one to its route's count (and
    its store's); forcing "bf16_ws" where its block does not fit, or on
    fp16, raises before anything is loaded or counted. The launch itself
    is stubbed: there is no card here."""
    def fake_launch(queries, table, scales, v_sq, valid, k_sel, *a, **kw):
        return torch.full((queries.shape[0], k_sel), es._EMPTY_KEY,
                          dtype=torch.int64)
    monkeypatch.setattr(es, "_launch", fake_launch)
    es.capacity_launches = 0
    es.capacity_launches_by_store.update(int8=0, bf16=0, fp16=0)
    es.capacity_launches_by_route.update(wgmma=0, wgmma_ld=0, bf16_ws=0)
    for route, dtype, reps in (("bf16_ws", torch.int8, 2),
                               ("wgmma", torch.float16, 1),
                               ("wgmma_ld", torch.bfloat16, 3),
                               ("bf16_ws", torch.bfloat16, 1)):
        args = _args(d=16, dtype=dtype)
        for _ in range(reps):
            d, i = es._capacity_cuda(*args, 8, "l2", route)
            assert (i == -1).all() and (d == es.INF_DIST).all()
    assert es.capacity_launches_by_route == {"bf16_ws": 3, "wgmma": 1,
                                             "wgmma_ld": 3}
    assert es.capacity_launches_by_store == {"int8": 2, "bf16": 4,
                                             "fp16": 1}
    assert es.capacity_launches == 7
    monkeypatch.setattr(es, "_launch", lambda *a, **kw: pytest.fail("ran"))
    for dtype, kk, d in ((torch.float16, 8, 16), (torch.int8, 150, 128),
                         (torch.bfloat16, 8, 256)):
        with pytest.raises(ValueError, match="bf16_ws"):
            es._capacity_cuda(*_args(n=300, d=d, dtype=dtype), kk, "l2",
                              "bf16_ws")
    assert es.capacity_launches == 7


def _args(n=300, d=16, dtype=torch.int8):
    q = torch.zeros((4, d))
    t = torch.zeros((n, d), dtype=dtype)
    s = torch.ones(n) if dtype == torch.int8 else None
    return q, t, s, torch.zeros(n), torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize("change,kk,metric,err", [
    (lambda a: (a[0], a[1], None, *a[3:]), 8, "l2", ValueError),
    (lambda a: (a[0], a[1].to(torch.bfloat16), *a[2:]), 8, "l2",
     ValueError),
    (lambda a: (a[0].double(), *a[1:]), 8, "l2", TypeError),
    (lambda a: (a[0], a[1].to(torch.float32), None, *a[3:]), 8, "l2",
     TypeError),
    (lambda a: (a[0], a[1].to(torch.int16), None, *a[3:]), 8, "l2",
     TypeError),
    (lambda a: (a[0], a[1], a[2].double(), *a[3:]), 8, "l2", TypeError),
    (lambda a: (a[0][:, :8], *a[1:]), 8, "l2", ValueError),
    (lambda a: (a[0], a[1].t().contiguous().t(), *a[2:]), 8, "l2",
     ValueError),
    (lambda a: (a[0], a[1], a[2][:10], *a[3:]), 8, "l2", ValueError),
    (lambda a: (a[0], *(x[:100] for x in a[1:])), 129, "l2",
     ValueError),                                   # kk past N
    (lambda a: a, 257, "l2", ValueError),           # past CAPACITY_K_MAX
    (lambda a: a, 0, "l2", ValueError),
    (lambda a: a, 8, "my_metric", ValueError),
])
def test_capacity_wrapper_refuses_what_the_kernel_does_not_take(
        monkeypatch, change, kk, metric, err):
    """The checks run before the library is loaded: here nothing is
    built, and each bad argument raises instead ("my_metric" is a
    registered custom metric, which the kernel does not score)."""
    monkeypatch.setitem(tdist._registry, "my_metric", {
        "point": lambda a, b: 0.0, "pairwise": lambda q, v: q @ v.T})
    monkeypatch.setattr(es, "_load", lambda: pytest.fail("loaded"))
    launches = es.capacity_launches
    with pytest.raises(err):
        es._capacity_cuda(*change(_args()), kk, metric, "wgmma")
    assert es.capacity_launches == launches


def _pair(metric, dtype, v):
    j = hnsw_tpu.ExactIndex(metric=metric, hbm_dtype=dtype)
    t = hnsw_tpu_torch.ExactIndex(metric=metric, hbm_dtype=dtype,
                                  device="cpu")
    j.host_serve_max_batch = t.host_serve_max_batch = 0
    keys = list(range(len(v)))
    j.batch_add(keys, v)
    t.batch_add(keys, v)
    return j, t


@pytest.mark.parametrize("k", [1, 20])
@pytest.mark.parametrize("metric", ["cosine", "sqeuclidean"])
@pytest.mark.parametrize("dtype", STORES)
def test_exact_index_capacity_rungs_match_jax(dtype, metric, k):
    v = _data(35, 1800, 24)
    j, t = _pair(metric, dtype, v)
    q = np.concatenate([v[:4], _data(36, 21, 24)])
    dj, ij = j.batch_search_slots(q, k)
    dt, it = t.batch_search_slots(q, k)
    assert it.shape == (25, k)
    assert _overlap(it, ij) >= 0.99
    assert _matched_err(dt, it, dj, ij) <= 1e-5


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("dtype", STORES)
def test_streaming_reduced_chunks_match_jax(tmp_path, dtype, metric):
    """Chunks of 384 rows (the last one short), every 50th row deleted."""
    v = _data(37, 2000, 16)
    q = _data(38, 20, 16)
    kw = dict(metric=metric, stream_dtype=dtype, chunk_rows=384)
    j = JStreamingExactIndex(str(tmp_path / "j"), **kw)
    t = StreamingExactIndex(str(tmp_path / "t"), device="cpu", **kw)
    for idx in (j, t):
        idx.batch_add(list(range(len(v))), v)
        idx.batch_delete(list(range(0, len(v), 50)))
    dj, ij = j.batch_search_slots(q, 10)
    dt, it = t.batch_search_slots(q, 10)
    assert not np.isin(it, np.arange(0, len(v), 50)).any()
    assert _overlap(it, ij) >= 0.99
    assert _matched_err(dt, it, dj, ij) <= 1e-5


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("dtype", STORES)
def test_sharded_capacity_candidates_match_jax(dtype, metric):
    """Eight row shards of 512 (a masked range across two of them): the
    merged candidates overlap JAX's >= 0.99, matched distances within
    1e-5, no masked id."""
    n, d, kk = 4096, 32, 14
    v = _data(39, n, d)
    q = _data(40, 24, d)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    valid = np.ones(n, bool)
    valid[1000:1100] = False
    jt, js, tt, ts = _tables(v, dtype)
    jd, ji = jsh.sharded_quantized_candidates(
        jnp.asarray(q), jt, js, jnp.asarray(sq), jnp.asarray(valid), kk=kk,
        metric=metric, mesh=jsh.default_mesh())
    td, ti = tsh.sharded_quantized_candidates(
        torch.from_numpy(q), tt, ts, torch.from_numpy(sq),
        torch.from_numpy(valid), kk=kk, metric=metric,
        mesh=tsh.Mesh(["cpu"] * 8))
    td, ti = td.numpy(), ti.numpy()
    jd, ji = np.asarray(jd), np.asarray(ji, np.int64)
    assert ti.shape == (24, kk)
    assert not np.isin(ti, np.arange(1000, 1100)).any()
    assert _overlap(ti, ji) >= 0.99
    assert _matched_err(td, ti, jd, ji) <= 1e-5


@pytest.mark.parametrize("fn", ["topk_keyed", "topk_lowest_ids"])
@pytest.mark.parametrize("seed,q,c,k,tie_share", [
    (0, 3, 1000, 1, 0.0), (1, 5, 4096, 26, 0.5), (2, 2, 300, 300, 0.9),
    (3, 4, 70_000, 150, 0.3), (4, 6, 2000, 40, 0.0)])
def test_topk_keyed_is_a_stable_sort(fn, seed, q, c, k, tie_share):
    """Negative, zero (both signs), INF_DIST and repeated distances: both
    selections return the stable sort's first k, distance and id (seed
    4: distinct values, where topk_lowest_ids keeps torch.topk's
    winners)."""
    r = np.random.default_rng(seed)
    d = r.standard_normal((q, c)).astype(np.float32)
    rep_ = r.random((q, c)) < tie_share
    d[rep_] = np.round(d[rep_], 1)          # many equal values
    if tie_share:
        d[:, ::7] = INF_DIST
        d[:, 3::11] = 0.0
        d[:, 5::13] = -0.0
    dt = torch.from_numpy(d)
    ids = torch.arange(c) + 5
    dk, ik = getattr(ttopk, fn)(dt, ids, k)
    ds, pos = torch.sort(dt, dim=1, stable=True)
    assert torch.equal(ik, ids[pos[:, :k]])
    assert torch.equal(dk, ds[:, :k])


def test_topk_lowest_ids_settles_a_cut_tie_by_id():
    """Row 0's 3rd distance (1.0) sits at ids 2, 4 and 6: the 3 winners
    are ids 0, 2, 4 whatever torch.topk picks; row 1 has no tie."""
    d = torch.tensor([[0.5, 3.0, 1.0, 3.0, 1.0, 3.0, 1.0, 0.125],
                      [7.0, 6.0, 5.0, 4.0, 3.0, 2.0, 1.0, 0.0]])
    dk, ik = ttopk.topk_lowest_ids(d, torch.arange(8), 3)
    assert ik.tolist() == [[7, 0, 2], [7, 6, 5]]
    assert dk.tolist() == [[0.125, 0.5, 1.0], [0.0, 1.0, 2.0]]
    ik2 = ttopk.topk_lowest_ids(d, torch.arange(8).expand(2, 8), 4)[1]
    assert ik2.tolist() == [[7, 0, 2, 4], [7, 6, 5, 4]]
