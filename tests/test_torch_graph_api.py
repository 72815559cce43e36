"""Graph's compact upper layers, ef calibration, batch delete, lookup and
negative-example search: hnsw_tpu_torch.Graph against hnsw_tpu.Graph on
the CPU (graphs built as in tests/test_torch_graph_modes.py, so their host
arrays are equal). Compact uppers must serve the dense layout's exact
ids; calibration must pick JAX's ef; the rest must equal JAX's results
(the single queries and small batches of the negative searches take the
shared native engine in both packages).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu_torch  # noqa: E402
from tests.test_torch_graph_modes import (D, N, _build,  # noqa: E402
                                          _data, _host_equal)


def test_compact_upper_layers_serve_as_dense():
    _, t, v = _build()
    t.native_serve_max_batch = 0
    q = _data(8, 40)
    assert t.split_layers == "auto" and t.device_graph().nbr_upper is None
    d0, i0 = t.batch_search_slots(q, 10, ef=48)
    for mode in (True, "compact"):
        t.split_layers = mode
        t._dirty = True
        dev = t.device_graph()
        assert dev.nbr_upper is not None
        assert isinstance(dev.nbr_upper, tuple) == (mode == "compact")
        d1, i1 = t.batch_search_slots(q, 10, ef=48)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_allclose(d1, d0, rtol=1e-6)


def test_calibrate_ef_matches_jax_and_round_trips():
    j, t, _ = _build(metric="l2")
    res_j = j.calibrate_ef(0.9, k=10, sample=48, seed=1)
    res_t = t.calibrate_ef(0.9, k=10, sample=48, seed=1)
    assert res_t[0] == res_j[0] and abs(res_t[1] - res_j[1]) <= 0.01
    assert t.ef_search == res_t[0]
    q = _data(9, 5)
    np.testing.assert_array_equal(np.sort(t._host_oracle_slots(q, 10)),
                                  np.sort(j._host_oracle_slots(q, 10)))
    state = t.calibration_state()
    assert state["ef_default"] == j.calibration_state()["ef_default"]
    fresh = hnsw_tpu_torch.Graph(device="cpu")
    fresh.restore_calibration(state)
    fresh.restore_calibration(None)
    assert fresh.calibration_state() == state
    assert fresh.ef_search == res_t[0]
    # cached per (k, target) while the size holds
    calls = []
    t._host_oracle_slots = lambda *a, **kw: calls.append(a)
    assert t.calibrate_ef(0.9, k=10, sample=48, seed=1) == res_t
    assert not calls
    with pytest.raises(ValueError):
        t.calibrate_ef(0.9, ladder=())


def test_batch_delete_lookup_and_negatives_match_jax():
    j, t, v = _build()
    for g in (j, t):
        assert g.batch_delete([3, 4, 99999, 3]) == [True, True, False,
                                                    False]
        assert g.lookup(3) is None
        g.validate()
    assert _host_equal(j, t)
    np.testing.assert_array_equal(t.lookup(7), j.lookup(7))
    assert t.dims() == j.dims() == D
    assert len(t) == len(j) == N - 2
    q = _data(10, 3)
    negs = [v[10:12], v[20:21], np.zeros((0, D), np.float32)]
    # single queries and small batches take the shared native engine
    assert t.search_with_negative(q[0], v[10], 5, 0.7) == \
        j.search_with_negative(q[0], v[10], 5, 0.7)
    got = t.batch_search_with_negatives(q, negs, 5, 0.5)
    want = j.batch_search_with_negatives(q, negs, 5, 0.5)
    assert [[k for k, _ in r] for r in got] == \
        [[k for k, _ in r] for r in want]
    for rg, rw in zip(got, want):
        np.testing.assert_allclose([s for _, s in rg], [s for _, s in rw],
                                   atol=1e-6)
    with pytest.raises(ValueError, match="negWeight"):
        t.search_with_negatives(q[0], v[:1], 5, 1.5)
    assert t.parallel_search(v[7], 3, num_workers=4) == t.search(v[7], 3)
