"""The end-to-end metrics' arithmetic."""

import numpy as np
import pytest

from portbench import check, stats


def test_qps_is_all_work_over_the_window():
    assert stats.qps(8192 * 150, 10.0) == pytest.approx(122880.0)


def test_p95_is_over_every_call_and_moves_with_a_stall():
    calm = [0.010] * 200
    stalled = list(calm)
    for j in range(0, 200, 10):        # one call in ten stalls
        stalled[j] = 0.050
    assert stats.p95_ms(calm) == pytest.approx(10.0)
    assert stats.p95_ms(stalled) == pytest.approx(50.0)
    # the median of chunks of ten would not see the stall at all
    chunks = [np.median(stalled[i:i + 10]) for i in range(0, 200, 10)]
    assert max(chunks) == pytest.approx(0.010)


def test_hits_and_recall():
    truth = np.array([[1, 2, 3], [4, 5, 6]])
    ids = np.array([[3, 2, 9], [-1, 4, 6]])
    assert stats.hits(ids, truth) == 4
    assert check.walk_misses(ids, truth) == 2


def test_cut_batches_repeat_for_a_seed():
    t = {"batch": 5, "batches": 3}
    a = stats.cut_batches(t, 20, 7)
    b = stats.cut_batches(t, 20, 7)
    assert len(a) == 3 and all(len(x) == 5 == len(set(x)) for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        stats.cut_batches({"batch": 21, "batches": 1}, 20, 7)


def test_invalid_rows_and_judge():
    d = np.array([[1.0, 2.0], [2.0, 1.0], [1.0, np.inf], [1.0, 2.0]],
                 np.float32)
    ids = np.array([[0, 1], [0, 1], [0, 1], [3, 3]])
    assert check.invalid_rows(d, ids, 4).tolist() == [False, True, True,
                                                      True]
    ok, out, lines = check.judge({"a": 0, "b": 0.5}, {"a": 0, "b": 1.0})
    assert ok and out["b"] == {"value": 0.5, "limit": 1.0}
    assert len(lines) == 2
    assert not check.judge({"a": 1}, {"a": 0})[0]
    assert not check.judge({"a": 0}, {"a": 0, "b": 1})[0]
    assert not check.judge({"a": float("nan")}, {"a": 1})[0]
