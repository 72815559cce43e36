"""The concurrency contract of hnsw_tpu_torch, twin of
tests/test_concurrency.py, on the CPU (``device="cpu"``).

Graph mutations take the write side of utils.rwlock.RWLock, searches the
read side: one process may mutate while other threads search. The lock
specs run against the port's RWLock; the storms also hold the port
against hnsw_tpu on the same seeded inputs: the graph a storm leaves
behind has the host arrays of a JAX graph given the same mutations with
no readers (readers never change the graph), and the exact tier's
answers under concurrent readers equal JAX's. Every join has a timeout,
and each test asserts the threads ended.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
from hnsw_tpu_torch import ExactIndex, Graph  # noqa: E402
from hnsw_tpu_torch.utils.rwlock import RWLock  # noqa: E402


def make_vectors(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)


def _join(threads, timeout):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a thread did not end"


# ---- lock primitives ------------------------------------------------------

def test_rwlock_reentrancy_shapes():
    rw = RWLock()
    with rw.read():
        with rw.read():
            pass
    with rw.write():
        with rw.write():
            pass
        with rw.read():
            pass
    with rw.read():
        with pytest.raises(RuntimeError, match="upgrade"):
            rw.acquire_write()


def test_rwlock_writer_excludes_readers():
    rw = RWLock()
    order = []
    rw.acquire_write()

    def reader():
        with rw.read():
            order.append("read")

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.05)
    order.append("write-done")
    rw.release_write()
    _join([t], 5)
    assert order == ["write-done", "read"]


def test_rwlock_readers_share():
    rw = RWLock()
    n_inside = []
    barrier = threading.Barrier(4, timeout=10)

    def reader():
        with rw.read():
            barrier.wait()      # all 4 hold the read side at once
            n_inside.append(1)

    ts = [threading.Thread(target=reader) for _ in range(4)]
    for t in ts:
        t.start()
    _join(ts, 10)
    assert len(n_inside) == 4


def test_rwlock_queued_writer_does_not_deadlock_nested_read():
    rw = RWLock()
    done = []
    rw.acquire_read()
    w = threading.Thread(target=lambda: (rw.acquire_write(),
                                         rw.release_write(),
                                         done.append("w")))
    w.start()
    time.sleep(0.05)           # the writer is queued
    with rw.read():            # a nested read must not block
        done.append("nested")
    rw.release_read()
    _join([w], 5)
    assert done == ["nested", "w"]


def test_rwlock_writer_priority_beats_read_storm():
    rw = RWLock()
    stop = threading.Event()
    got_write = threading.Event()

    def reader():
        while not stop.is_set():
            with rw.read():
                pass

    ts = [threading.Thread(target=reader) for _ in range(3)]
    for t in ts:
        t.start()
    time.sleep(0.05)           # storm established

    def writer():
        with rw.write():
            got_write.set()

    w = threading.Thread(target=writer)
    w.start()
    ok = got_write.wait(10)
    stop.set()
    _join([w] + ts, 5)
    assert ok, "writer starved by read storm"


# ---- storms ---------------------------------------------------------------

def test_concurrent_add_search_storm():
    """One writer adds and deletes while four readers search; results stay
    well-formed, every live key is served after, and the graph equals a
    JAX graph given the same mutations without readers."""
    n0, d, k = 400, 16, 5
    data = make_vectors(n0 + 400, d, seed=1)
    g = Graph(m=8, metric="cosine", seed=0, device="cpu")
    g.batch_add(list(range(n0)), data[:n0])
    jg = hnsw_tpu.Graph(m=8, metric="cosine", seed=0)
    jg.batch_add(list(range(n0)), data[:n0])

    errors = []
    stop = threading.Event()

    def reader(tid):
        rng = np.random.default_rng(tid)
        try:
            while not stop.is_set():
                q = data[rng.integers(0, n0)]
                res = g.search(q, k)
                assert 0 < len(res) <= k
                assert all(isinstance(dd, float) for _, dd in res)
                qs = data[rng.integers(0, n0, 4)]
                keys, dists = g.batch_search(qs, k)
                assert len(keys) == 4
                # a batch past the native tier takes the device path
                keys, _ = g.batch_search(data[rng.integers(0, n0, 40)], k)
                assert len(keys) == 40
        except Exception as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    readers = [threading.Thread(target=reader, args=(t,))
               for t in range(4)]
    for t in readers:
        t.start()
    try:
        for w0 in range(n0, n0 + 400, 50):
            g.batch_add(list(range(w0, w0 + 50)), data[w0:w0 + 50])
            g.batch_delete(list(range(w0 - n0, w0 - n0 + 10)))
    finally:
        stop.set()
        _join(readers, 30)
    assert not errors, errors[:3]
    for w0 in range(n0, n0 + 400, 50):
        jg.batch_add(list(range(w0, w0 + 50)), data[w0:w0 + 50])
        jg.batch_delete(list(range(w0 - n0, w0 - n0 + 10)))
    for a, b in zip(g.host.arrays(), jg.host.arrays()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for kk in range(n0 + 300, n0 + 400):
        res = g.search(data[kk], 1)
        assert res[0][0] == kk, (kk, res)
    g.validate()


def test_exact_latency_tier_concurrent_readers():
    """Eight threads of single-query searches on one exact index return
    exact results throughout, equal to the JAX index's."""
    n, d, k = 4096, 128, 5
    rng = np.random.default_rng(21)
    docs = rng.standard_normal((n, d)).astype(np.float32)
    ex = ExactIndex(metric="cosine", device="cpu")
    ex.batch_add(list(range(n)), docs)
    ex.search(docs[0], k)          # build the host scan arrays once
    jx = hnsw_tpu.ExactIndex(metric="cosine")
    jx.batch_add(list(range(n)), docs)

    errs = []

    def storm(tid):
        try:
            for i in range(50):
                qi = (tid * 50 + i) % n
                res = ex.search(docs[qi], k)
                assert res[0][0] == qi and res[0][1] < 1e-5, (qi, res[0])
        except Exception as e:      # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=storm, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    _join(threads, 60)
    assert not errs, errs
    for qi in (0, 77, 4095):
        got, want = ex.search(docs[qi], k), jx.search(docs[qi], k)
        assert [kk for kk, _ in got] == [kk for kk, _ in want]
        np.testing.assert_allclose([dd for _, dd in got],
                                   [dd for _, dd in want], rtol=0,
                                   atol=1e-5)
