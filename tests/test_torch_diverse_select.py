"""The wave builder's neighbour selection (K4) on the CPU:
``hnsw_tpu_torch.core.build._diverse_select_dev``, its twin
``_diverse_select_reference`` and ``ops/diverse_select``.

The same seeded numpy inputs go through both packages, at the widths the
builder's callers give the selection: C 96 / deg 32 (a layer-0 wave row:
n_cand 64 + intra_k 32 at m 16), C 64 / deg 32 (the reverse update: Wd +
deg), C 64 / deg 16 (an upper layer), C 20 / deg 32 (fewer candidates
than the degree). Every batch holds an all-pad row, a row whose nearest
candidates repeat an id (with ``diversify=False`` the duplicate leaves a
-1 gap inside the first deg), a row of equal distances and a short row.

Tolerances: integer-valued vectors (|x| <= 4) make every bf16 operand,
product and f32 sum exact, so the port's DEFAULT (bf16 operands) and
JAX's CPU DEFAULT (f32) score alike and the rows must be EQUAL for l2,
sqeuclidean and dot. Cosine goes through rsqrt, which may differ by an
ulp between the packages: row overlap >= 0.99.

The kernel itself needs the card (tests/test_torch_cuda_select.py). Here:
its steps written in numpy (rank by counting, conflict bits, the one-warp
scan, the ballot backfill and compaction) give the twin's rows; a CPU call
takes the twin and never builds or loads the library; the predicate's
reasons; ``utils/roofline.select_bound_s``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.core import build as jbuild  # noqa: E402
from hnsw_tpu_torch.core import build as tbuild  # noqa: E402
from hnsw_tpu_torch.ops import diverse_select as ds  # noqa: E402
from hnsw_tpu_torch.ops.distance import (INF_DIST,  # noqa: E402
                                         np_bf16_round, register_distance)
from hnsw_tpu_torch.utils import roofline  # noqa: E402

INF = float(INF_DIST)
METRICS = ["l2", "sqeuclidean", "dot", "cosine"]
#: (C, deg) of the builder's calls
WIDTHS = [(96, 32), (64, 32), (64, 16), (20, 32)]


def _ints(seed, n, d, lo=-4, hi=4):
    r = np.random.default_rng(seed)
    return r.integers(lo, hi + 1, (n, d)).astype(np.float32)


def _sq(v):
    return np.sum(v.astype(np.float64) ** 2, axis=1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(row):
    return set(row[row >= 0].tolist())


def _row_overlap(a, b):
    hits = sum(len(_ids(x) & _ids(y)) for x, y in zip(a, b))
    return hits / max(1, sum(len(_ids(y)) for y in b))


def _batch(seed, n_vec, P, C, metric, vecs):
    """[P, C] candidate ids and distances to an anchor a row (INF on
    pads): random ids with pads and a repeated id, row 0 all pads, row 1
    its nearest id twice among its first columns, row 2 one distance for
    every candidate, row 3 all pads but five."""
    r = np.random.default_rng(seed)
    ci = r.integers(0, n_vec, (P, C)).astype(np.int32)
    ci[:, C // 2] = ci[:, 1]
    ci[r.random((P, C)) < 0.15] = -1
    anchors = r.integers(0, n_vec, P)
    d = tbuild._np_dist_rows(vecs, _sq(vecs), anchors[:, None],
                             np.clip(ci, 0, None), metric)
    cd = np.where(ci >= 0, d, INF).astype(np.float32)
    ci[0], cd[0] = -1, INF
    ci[1] = r.permutation(n_vec)[:C]
    ci[1, 3] = ci[1, 0]
    cd[1] = np.sort(r.random(C)).astype(np.float32)
    cd[1, 3] = cd[1, 0]
    cd[2] = np.float32(1.5)
    ci[3, 5:], cd[3, 5:] = -1, INF
    return ci, cd


def _jax(ci, cd, vecs, sq, deg, metric, diversify):
    return np.asarray(jbuild._diverse_select_dev(
        jnp.asarray(ci), jnp.asarray(cd), jnp.asarray(vecs), jnp.asarray(sq),
        deg=deg, metric=metric, diversify=diversify))


def _kernel_steps(ci_in, cd_in, vecs, sq, deg, metric, diversify):
    """csrc/diverse_select.cu's steps in numpy, a row at a time: A (rank by
    counting, dedup), G (conflict bits over pairs e < j) and S (one warp:
    the scan on 32-bit kept masks, the backfill and compaction 32
    candidates a step)."""
    P, C = ci_in.shape
    N, W, out_w = vecs.shape[0], -(-C // 32), min(C, deg)
    out = np.full((P, out_w), -1, np.int32)
    cols = np.arange(C)
    for p in range(P):
        d, i = cd_in[p], ci_in[p]
        rank = [int(((d < d[j]) | ((d == d[j]) & (cols < j))).sum())
                for j in range(C)]
        cd, ci = np.empty(C, np.float32), np.empty(C, np.int32)
        cd[rank], ci[rank] = d, i
        dup = np.array([ci[j] >= 0 and bool((ci[:j] == ci[j]).any())
                        for j in range(C)])
        cd = np.where(dup, np.float32(INF), cd)
        valid = (cd < INF) & (ci >= 0)
        if not diversify:
            out[p] = np.where(valid[:out_w], ci[:out_w], -1)
            continue
        safe = np.clip(ci, 0, N - 1)
        rows = np_bf16_round(vecs[safe])
        g = (rows @ rows.T).astype(np.float32)
        s = sq[safe]
        if metric == "cosine":
            pd = 1 - g * (1 / np.sqrt(s[:, None] * s[None, :]
                                      + np.float32(1e-30)))
        elif metric == "dot":
            pd = -g
        else:
            pd = np.maximum(s[:, None] + s[None, :] - 2 * g, 0)
            if metric == "l2":
                pd = np.sqrt(pd)
        bits = np.zeros((C, W), np.uint64)
        for j in range(C):
            for e in range(j):
                if pd[j, e] < cd[j]:
                    bits[j, e // 32] |= np.uint64(1 << (e % 32))
        kept, count = np.zeros(W, np.uint64), 0
        for j in range(C):
            if count >= deg:
                break
            if valid[j] and not (bits[j] & kept).any():
                kept[j // 32] |= np.uint64(1 << (j % 32))
                count += 1
        for b in range(W):
            if count >= deg:
                break
            js = b * 32 + np.arange(32)
            on = (int(kept[b]) >> np.arange(32)) & 1
            cand = (js < C) & valid[np.minimum(js, C - 1)] & (on == 0)
            before = np.cumsum(cand) - cand
            take = cand & (count + before < deg)
            kept[b] |= np.uint64(int((take << np.arange(32)).sum()))
            count += int(take.sum())
        pos = 0
        for b in range(W):
            for lane in range(32):
                if (int(kept[b]) >> lane) & 1:
                    out[p, pos] = ci[b * 32 + lane]
                    pos += 1
    return out


@pytest.mark.parametrize("diversify", [True, False])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("C,deg", WIDTHS)
def test_twin_matches_jax(C, deg, metric, diversify):
    vecs = _ints(0, 300, 16)
    sq = _sq(vecs)
    ci, cd = _batch(1, 300, 24, C, metric, vecs)
    want = _jax(ci, cd, vecs, sq, deg, metric, diversify)
    got = tbuild._diverse_select_reference(
        _t(ci), _t(cd), _t(vecs), _t(sq), deg=deg, metric=metric,
        diversify=diversify).numpy()
    assert got.shape == want.shape == (24, min(C, deg))
    assert (got[0] == -1).all()
    if metric == "cosine":
        assert _row_overlap(got, want) >= 0.99
    else:
        np.testing.assert_array_equal(got, want)
    if not diversify:
        assert got[1, 1] == -1           # the nearest id's repeat: a gap


@pytest.mark.parametrize("diversify", [True, False])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("C,deg", [(96, 32), (20, 32), (40, 8)])
def test_kernel_steps_give_the_twins_rows(C, deg, metric, diversify):
    """The kernel's algorithm (a numpy copy of its steps) returns the
    twin's rows on integer-valued data: every row; cosine overlap >= 0.99
    (numpy's 1 / sqrt against torch's rsqrt)."""
    vecs = _ints(2, 200, 12)
    sq = _sq(vecs)
    ci, cd = _batch(3, 200, 16, C, metric, vecs)
    want = tbuild._diverse_select_reference(
        _t(ci), _t(cd), _t(vecs), _t(sq), deg=deg, metric=metric,
        diversify=diversify).numpy()
    got = _kernel_steps(ci, cd, vecs, sq, deg, metric, diversify)
    if metric == "cosine":
        assert _row_overlap(got, want) >= 0.99
    else:
        np.testing.assert_array_equal(got, want)


def test_each_row_is_selected_alone():
    """The kernel's premise: one block a row needs nothing of another row.
    The twin on each row alone returns its row of the batch."""
    vecs = _ints(4, 300, 16)
    sq = _sq(vecs)
    ci, cd = _batch(5, 300, 12, 64, "l2", vecs)
    whole = tbuild._diverse_select_reference(
        _t(ci), _t(cd), _t(vecs), _t(sq), deg=16, metric="l2",
        diversify=True).numpy()
    for p in range(12):
        one = tbuild._diverse_select_reference(
            _t(ci[p:p + 1]), _t(cd[p:p + 1]), _t(vecs), _t(sq), deg=16,
            metric="l2", diversify=True).numpy()
        np.testing.assert_array_equal(one[0], whole[p])


def test_cpu_call_takes_the_twin_and_never_loads_the_library(monkeypatch):
    def broken():
        raise RuntimeError("the CPU path built the selection kernel")
    monkeypatch.setattr(ds, "_lib", None)
    monkeypatch.setattr(ds, "build", broken)
    monkeypatch.setattr(ds, "launches", 0)
    monkeypatch.setattr(ds, "plain_on_cuda",
                        {"mode": 0, "size": 0, "other": 0})
    vecs = _ints(6, 300, 16)
    sq = _sq(vecs)
    for C, deg in WIDTHS:
        ci, cd = _batch(7, 300, 8, C, "l2", vecs)
        for diversify in (True, False):
            kw = dict(deg=deg, metric="l2", diversify=diversify)
            got = tbuild._diverse_select_dev(_t(ci), _t(cd), _t(vecs),
                                             _t(sq), **kw)
            want = tbuild._diverse_select_reference(_t(ci), _t(cd),
                                                    _t(vecs), _t(sq), **kw)
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert ds.launches == 0 and ds._lib is None
    assert ds.plain_on_cuda == {"mode": 0, "size": 0, "other": 0}
    assert not ds.select_kernel_applies(_t(ci), _t(cd), _t(vecs), _t(sq),
                                        metric="l2", diversify=True)
    with pytest.raises(ValueError):
        ds.diverse_select_cuda(_t(ci), _t(cd), _t(vecs), _t(sq), deg=8,
                               metric="l2", diversify=True)


def test_twin_refuses_a_nan_distance():
    vecs = _ints(8, 50, 4)
    ci, cd = _batch(9, 50, 4, 20, "l2", vecs)
    cd[2, 3] = np.nan
    with pytest.raises(AssertionError):
        tbuild._diverse_select_reference(_t(ci), _t(cd), _t(vecs),
                                         _t(_sq(vecs)), deg=8, metric="l2",
                                         diversify=True)


def test_calls_the_kernel_lacks_are_counted_by_reason(monkeypatch):
    """count_plain: a registered metric or a row store the kernel lacks is
    "mode" (not without diversify, which reads no row), more than
    SELECT_MAX_C candidates "size", a covered call "other"."""
    monkeypatch.setattr(ds, "plain_on_cuda",
                        {"mode": 0, "size": 0, "other": 0})
    register_distance("select_test_l1",
                      lambda a, b: float(np.abs(a - b).sum()),
                      pairwise_fn=lambda a, b: torch.cdist(a, b, p=1))
    v32 = torch.zeros((10, 4))
    ci = torch.zeros((2, 8), dtype=torch.int32)
    wide = torch.zeros((2, ds.SELECT_MAX_C + 1), dtype=torch.int32)
    assert ds.count_plain(ci, v32, metric="select_test_l1",
                          diversify=True) == "mode"
    assert ds.count_plain(ci, v32.double(), metric="l2",
                          diversify=True) == "mode"
    assert ds.count_plain(ci, v32, metric="select_test_l1",
                          diversify=False) == "other"
    assert ds.count_plain(wide, v32, metric="l2", diversify=True) == "size"
    for dt in ds.STORES:
        assert ds.count_plain(ci, v32.to(dt), metric="cosine",
                              diversify=True) == "other"
    assert ds.plain_on_cuda == {"mode": 2, "size": 1, "other": 4}


def test_select_bound_s():
    peaks = roofline.PEAKS[roofline.H100_SXM]
    P, C, D, deg = 2048, 96, 128, 32
    t, by = roofline.select_bound_s(P, C, D, deg)
    moved = 8 * P * C + (4 * D + 4) * P * C + 4 * P * deg
    ops = 2.0 * D * P * C * (C - 1) // 2
    assert by == "bytes" and t == pytest.approx(moved / peaks["hbm_bytes_s"])
    assert ops / peaks["bf16"] < t
    # with reuse: the distinct rows only, and the operations can bind
    t2, by2 = roofline.select_bound_s(P, C, D, deg, rows=3000)
    assert by2 == "operations" and t2 == pytest.approx(ops / peaks["bf16"])
    t3, _ = roofline.select_bound_s(P, C, D, deg, rows=3000, pairs=10)
    moved3 = 8 * P * C + (4 * D + 4) * 3000 + 4 * P * deg
    assert t3 == pytest.approx(moved3 / peaks["hbm_bytes_s"])
    # without diversify: ids and distances in, ids out
    t4, by4 = roofline.select_bound_s(P, 20, D, 32, diversify=False)
    assert by4 == "bytes" and t4 == pytest.approx(
        (8 * P * 20 + 4 * P * 20) / peaks["hbm_bytes_s"])
