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
its steps written in numpy in its order (rank by counting; each row
gathered once, C and D padded to 16; the m16n8 fragments of the lower
triangle, accumulated across D slabs; conflict bits masked at e >= j and
on the pads, a triangle of words; the one-warp scan, the ballot backfill
and compaction) give the twin's rows, whole and in slabs; the wrapper's
copy of the shared layout at the boundary between whole rows and slabs; a
CPU call takes the twin and never builds or loads the library; the
predicate's reasons; ``utils/roofline.select_bound_s``.
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


def _pair_dist(g, sj, se, metric):
    """csrc/diverse_select.cu pair_dist in float32."""
    f = np.float32
    if metric == "cosine":
        return f(1) - g * (f(1) / np.sqrt(sj * se + f(1e-30)))
    if metric == "dot":
        return -g
    t = np.maximum(sj + se - f(2) * g, f(0))
    return np.sqrt(t) if metric == "l2" else t


def _kernel_steps(ci_in, cd_in, vecs, sq, deg, metric, diversify,
                  row_budget=ds.ROW_BUDGET):
    """csrc/diverse_select.cu's steps in numpy, a row at a time, in the
    kernel's order and layout (``ops/diverse_select.layout`` at
    ``row_budget``): A (rank by counting, dedup); G-stage (each valid
    candidate's row once, bf16, C and D padded to 16 with zeros; an id
    past the store reads row N - 1, as the twin's clamp), a D slab at a
    time; G-product over the units of the lower triangle (m-tile r of
    16 candidates x word g of 32, g <= r // 2; two n-tiles of 8 on the
    diagonal word of an even m-tile, else four), accumulated across slabs;
    G-bits (pair_dist < cd[j], masked at e >= j and on padded rows) into the
    triangle of words, each written once; S (one warp: the scan on 32-bit
    kept masks, the backfill and compaction 32 candidates a step)."""
    P, C = ci_in.shape
    N, D = vecs.shape
    L = ds.layout(C, D, row_budget)
    assert L["total"] > 0 and L["pitch"] * 2 % 32 == 16
    c_pad, d_pad, slab = L["c_pad"], L["d_pad"], L["slab"]
    W, out_w = -(-C // 32), min(C, deg)
    out = np.full((P, out_w), -1, np.int32)
    cols = np.arange(C)
    units = [(r, g) for r in range(c_pad // 16) for g in range(r // 2 + 1)]
    assert len(units) == L["units"]
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
        s = sq[np.clip(ci, 0, N - 1)].astype(np.float32)
        rows = np.zeros((c_pad, d_pad), np.float32)
        rows[:C][valid, :D] = np_bf16_round(vecs[np.minimum(ci[valid],
                                                           N - 1)])
        acc = {u: np.zeros((16, 32), np.float32) for u in units}
        for k0 in range(0, d_pad, slab):
            part = rows[:, k0:k0 + slab]         # one slab, every row
            for r, g in units:
                nt = 4 if 2 * r + 2 - 4 * g >= 4 else 2
                assert 32 * g + 8 * nt <= c_pad  # B rows inside the pad
                acc[r, g][:, :8 * nt] += (
                    part[16 * r:16 * r + 16]
                    @ part[32 * g:32 * g + 8 * nt].T).astype(np.float32)
        bits = np.zeros(ds.bit_words(C), np.int64)
        written = np.zeros(ds.bit_words(C), np.int64)
        for (r, g), a in acc.items():
            for jj in range(16):
                j = 16 * r + jj
                if j >= C:
                    continue
                word = 0
                for at in range(32):
                    e = 32 * g + at
                    if e < j and _pair_dist(a[jj, at], s[j], s[e],
                                            metric) < cd[j]:
                        word |= 1 << at
                bits[ds.bit_words(j) + g] = word
                written[ds.bit_words(j) + g] += 1
        assert (written == 1).all()              # the triangle, once each
        kept, count = np.zeros(W, np.int64), 0
        for j in range(C):
            if count >= deg:
                break
            q = j >> 5
            row = bits[ds.bit_words(j):ds.bit_words(j) + q + 1]
            if valid[j] and not (row & kept[:q + 1]).any():
                kept[q] |= 1 << (j % 32)
                count += 1
        for b in range(W):
            if count >= deg:
                break
            js = b * 32 + np.arange(32)
            on = (int(kept[b]) >> np.arange(32)) & 1
            cand = (js < C) & valid[np.minimum(js, C - 1)] & (on == 0)
            before = np.cumsum(cand) - cand
            take = cand & (count + before < deg)
            kept[b] |= int((take.astype(np.int64) << np.arange(32)).sum())
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
@pytest.mark.parametrize("C,deg", [(96, 32), (20, 32), (40, 8), (5, 4),
                                   (17, 8), (33, 16), (97, 32)])
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


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("C,deg", [(96, 32), (40, 8), (257, 32)])
def test_kernel_steps_in_slabs_give_the_same_rows(C, deg, metric):
    """The kernel's steps with D staged in slabs (a row budget that cannot
    hold the rows whole) return the rows of the whole-row steps and the
    twin's on integer-valued data (cosine: overlap >= 0.99)."""
    vecs = _ints(10, 400, 40)
    sq = _sq(vecs)
    ci, cd = _batch(11, 400, 6, C, metric, vecs)
    budget = ds.layout(C, 40)["c_pad"] * (32 + 8) * 2   # slabs of 32
    assert ds.layout(C, 40, budget)["n_slabs"] == 2
    assert ds.layout(C, 40)["n_slabs"] == 1
    slabs = _kernel_steps(ci, cd, vecs, sq, deg, metric, True, budget)
    whole = _kernel_steps(ci, cd, vecs, sq, deg, metric, True)
    np.testing.assert_array_equal(slabs, whole)
    want = tbuild._diverse_select_reference(
        _t(ci), _t(cd), _t(vecs), _t(sq), deg=deg, metric=metric,
        diversify=True).numpy()
    if metric == "cosine":
        assert _row_overlap(slabs, want) >= 0.99
    else:
        np.testing.assert_array_equal(slabs, want)


def test_layout_at_the_boundary_between_whole_rows_and_slabs():
    """ops/diverse_select.layout: the rows whole while C_pad x (D_pad + 8)
    x 2 bytes fit ROW_BUDGET, else slabs of 16k columns; at C 96 the last
    whole D_pad is 496, at D 128 the last whole C_pad 352; the phase-8b
    shapes whole, C 1,024 at D 128 and C 256 at D 300 in slabs."""
    whole = ds.layout(96, 496)
    assert whole["n_slabs"] == 1 and whole["slab"] == 496
    assert 96 * (496 + 8) * 2 <= ds.ROW_BUDGET < 96 * (512 + 8) * 2
    cut = ds.layout(96, 497)
    assert cut["d_pad"] == 512 and cut["n_slabs"] == 2
    assert cut["slab"] == 496 and 96 * cut["pitch"] * 2 <= ds.ROW_BUDGET
    assert ds.layout(352, 128)["n_slabs"] == 1
    assert ds.layout(353, 128)["n_slabs"] == 2
    for C in (96, 64, 252):
        assert ds.layout(C, 128)["n_slabs"] == 1
    for C, D in ((1024, 128), (256, 300)):
        L = ds.layout(C, D)
        assert L["n_slabs"] > 1 and L["slab"] % 16 == 0
        assert L["c_pad"] * L["pitch"] * 2 <= ds.ROW_BUDGET
        assert (L["n_slabs"] - 1) * L["slab"] < L["d_pad"]
        assert L["n_slabs"] * L["slab"] >= L["d_pad"]
    # C 96, D 128: 1,152 bytes of arrays, 192 words of bits, rows at
    # 1,920: 28,032 bytes, 8 blocks an SM (228 KB, 1 KB reserved a block)
    assert ds.layout(96, 128) == dict(
        c_pad=96, d_pad=128, bits=1152, rows=1920, plain=1920 + 768,
        units=12, slab=128, n_slabs=1, pitch=136, total=1920 + 96 * 136 * 2)
    assert 8 * (ds.layout(96, 128)["total"] + 1024) <= 228 * 1024
    # a budget that moves the threshold either way
    assert ds.layout(256, 300, row_budget=200 * 1024)["n_slabs"] == 1
    assert ds.layout(96, 128, row_budget=8 * 1024)["n_slabs"] == 4


@pytest.mark.parametrize("C", [1, 15, 16, 17, 31, 32, 33, 96, 255, 256, 257,
                               511, 1000, 1024])
def test_layout_holds_the_kernels_invariants(C):
    """Every C the kernel takes, at several D: the block fits SMEM_MAX; the
    rows start 128-byte aligned; a row pitch of 16 (mod 32) bytes keeps
    ldmatrix's eight rows in eight bank groups; the triangle of bits and
    the units count what they index (brute force); smem_bytes is the
    total, -1 past the kernel's limits."""
    words = sum(j // 32 + 1 for j in range(C))
    assert ds.bit_words(C) == words
    for D in (1, 7, 16, 50, 65, 128, 300, 1000, 4096):
        L = ds.layout(C, D)
        assert 0 < L["total"] <= ds.SMEM_MAX
        assert L["rows"] % 128 == 0 and L["rows"] >= 12 * C + 4 * words
        assert L["rows"] + 8 * C <= L["plain"] <= L["total"]
        assert L["pitch"] * 2 % 32 == 16 and L["slab"] % 16 == 0
        assert L["c_pad"] % 16 == 0 and C <= L["c_pad"] < C + 16
        assert L["units"] == sum(r // 2 + 1 for r in range(L["c_pad"] // 16))
        for store in ds.STORES.values():
            assert ds.smem_bytes(C, D, store) == L["total"]
    assert ds.smem_bytes(C, 128, 3) == -1
    assert ds.smem_bytes(C, -1, 0) == -1


def test_smem_bytes_past_the_limits():
    assert ds.smem_bytes(0, 128, 0) == -1
    assert ds.smem_bytes(ds.SELECT_MAX_C + 1, 128, 0) == -1
    assert ds.smem_bytes(ds.SELECT_MAX_C, 128, 2) == ds.layout(
        ds.SELECT_MAX_C, 128)["total"]


def test_select_bound_s_of_a_16_bit_store():
    """A float16 or bfloat16 store moves 2 bytes an element of each row."""
    peaks = roofline.PEAKS[roofline.H100_SXM]
    P, C, D, deg = 2048, 96, 128, 32
    t, by = roofline.select_bound_s(P, C, D, deg, store_bytes=2)
    moved = 8 * P * C + (2 * D + 4) * P * C + 4 * P * deg
    assert by == "bytes" and t == pytest.approx(moved / peaks["hbm_bytes_s"])
    assert t < roofline.select_bound_s(P, C, D, deg)[0]


def _l2_limit(c):
    """csrc/diverse_select.cu l2_limit in numpy float32 (numpy's float32
    square root rounds to nearest, as __fsqrt_rn)."""
    f = np.float32
    c = f(c)
    if not c > 0:
        return f(-1)
    with np.errstate(over="ignore"):
        y = f(c * c)
        while y > 0 and np.sqrt(y) >= c:
            y = np.nextafter(y, f(0))
        while True:
            z = np.nextafter(y, f(np.inf))
            if np.isinf(z) or np.sqrt(z) >= c:
                return y
            y = z


def test_l2_limit_is_the_strict_compare():
    """The kernel's l2 epilogue tests max(t, 0) <= l2_limit(cd) in place
    of sqrt_rn(max(t, 0)) < cd: the same answer for every t, at limits
    from the tiny to INF_DIST and at t around each limit and its square."""
    r = np.random.default_rng(12)
    cs = np.concatenate([r.random(300) * 50, r.random(100) * 1e-3,
                         [1e-30, 1.0, 2.0, 3.0, 0.0, -1.0, 1e19, INF]])
    for c in cs.astype(np.float32):
        lim = _l2_limit(c)
        with np.errstate(over="ignore"):
            ts = [lim, np.nextafter(lim, np.float32(np.inf)),
                  np.nextafter(lim, np.float32(-np.inf)), np.float32(0),
                  np.float32(c) * np.float32(c), np.float32(-3)]
            ts += list(np.minimum(r.random(8) * 2 * max(float(c), 1.0) ** 2,
                                  3e38).astype(np.float32))
        for t in ts:
            m = np.maximum(np.float32(t), np.float32(0))
            want = bool(np.sqrt(m) < c)
            assert bool(m <= lim) == want, (c, t, lim)


@pytest.mark.parametrize("diversify", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_kernel_steps_read_ids_past_the_store_as_the_twin(metric, diversify):
    """Ids at or past the store's N (no caller makes them, nothing refuses
    them): the twin clamps the row it gathers and its norm to N - 1 and
    keeps the id; the kernel's steps, whole and in slabs, return the same
    rows (cosine: overlap >= 0.99)."""
    vecs = _ints(13, 300, 40)
    sq = _sq(vecs)
    ci, cd = _batch(14, 300, 8, 64, metric, vecs)
    past = (np.arange(64) % 5 == 2) & (ci >= 0)
    ci = np.where(past, 300 + ci * 7, ci).astype(np.int32)
    ci[4, 6] = np.iinfo(np.int32).max
    assert (ci >= 300).sum() > 20
    want = tbuild._diverse_select_reference(
        _t(ci), _t(cd), _t(vecs), _t(sq), deg=16, metric=metric,
        diversify=diversify).numpy()
    assert (want >= 300).any()
    budget = ds.layout(64, 40)["c_pad"] * (32 + 8) * 2    # slabs of 32
    for row_budget in (ds.ROW_BUDGET, budget):
        got = _kernel_steps(ci, cd, vecs, sq, 16, metric, diversify,
                            row_budget)
        if metric == "cosine":
            assert _row_overlap(got, want) >= 0.99
        else:
            np.testing.assert_array_equal(got, want)


def test_the_workspace_size_is_asked_once_a_shape():
    """ops/diverse_select.workspace_bytes asks the library once for each
    (device, P, C, D, store) and answers repeats from the library's own
    table (a library built with another row budget has its own)."""
    class Lib:
        def __init__(self, size):
            self.workspace_sizes, self.asked, self.size = {}, [], size

        def diverse_select_workspace_bytes(self, P, C, D, store):
            self.asked.append((P, C, D, store))
            return self.size if C > 512 else 0

    lib, other = Lib(4096), Lib(8192)
    for _ in range(3):
        assert ds.workspace_bytes(lib, 0, 2048, 96, 128, 0) == 0
        assert ds.workspace_bytes(lib, 0, 64, 1024, 128, 0) == 4096
    assert ds.workspace_bytes(lib, 1, 64, 1024, 128, 0) == 4096
    assert ds.workspace_bytes(other, 0, 64, 1024, 128, 0) == 8192
    assert lib.asked == [(2048, 96, 128, 0), (64, 1024, 128, 0),
                         (64, 1024, 128, 0)]
    assert other.asked == [(64, 1024, 128, 0)]
