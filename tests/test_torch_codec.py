"""Checkpoints, deadlines and resume_build through hnsw_tpu_torch, and
checkpoints crossing between hnsw_tpu and hnsw_tpu_torch, on the CPU.

* The build contract of tests/test_build.py (a crash mid-build, then
  resume; a deadline abort, then resume; serving the inserted prefix;
  the host builder's slices) run through the port, with the JAX
  package's thresholds.
* The file format is shared: the payload each package writes for graphs
  with equal host state is equal entry by entry, a file written by
  either loads in the other with equal arrays and keys, and a JAX build
  aborted at its deadline finishes in the port's resume_build.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
import hnsw_tpu.io.codec as jcodec  # noqa: E402
import hnsw_tpu_torch  # noqa: E402
import hnsw_tpu_torch.io.codec as tcodec  # noqa: E402
from hnsw_tpu_torch.core.build_device import \
    BuildDeadlineExceeded  # noqa: E402
from hnsw_tpu_torch.ops.topk import np_exact_topk  # noqa: E402

N, D = 1200, 24


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


def _data(seed, n=N, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)) \
        .astype(np.float32)


def _recall(g, q, gt, k=10, ef=96):
    g.native_serve_max_batch = 0
    keys, _ = g.batch_search(q, k, ef=ef)
    return float(np.mean([len({kk for kk in keys[i] if kk is not None}
                              & set(map(int, gt[i][:k]))) / k
                          for i in range(len(gt))]))


def _complete(g, keys):
    return g.host.count == len(keys) and all(
        g.host.levels[g.slots.key_to_slot[k]] >= 0 for k in keys)


def test_checkpointed_build_resumes_after_crash(tmp_path, monkeypatch):
    vecs = _data(5)
    keys = list(range(N))
    ckpt = str(tmp_path / "build.npz")
    real_save = tcodec.save_graph
    calls = []

    def crashy_save(g, p, **kw):
        real_save(g, p, **kw)
        calls.append(p)
        if len(calls) == 2:
            raise RuntimeError("simulated crash")

    monkeypatch.setattr(tcodec, "save_graph", crashy_save)
    g = hnsw_tpu_torch.Graph(m=8, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="simulated crash"):
        g.build(keys, vecs, method="device", wave=256,
                checkpoint_path=ckpt, checkpoint_every=1)
    monkeypatch.setattr(tcodec, "save_graph", real_save)

    g2 = hnsw_tpu_torch.Graph.resume_build(ckpt, wave=256, device="cpu")
    assert _complete(g2, keys)
    g_ref = hnsw_tpu_torch.Graph(m=8, seed=0, device="cpu")
    g_ref.build(keys, vecs, method="device", wave=256)
    q = _data(99, 48)
    _, gt = np_exact_topk(q, vecs, 10, "cosine")
    assert _recall(g2, q, gt) >= _recall(g_ref, q, gt) - 0.05
    # a COMPLETED checkpoint resumes to a plain load
    assert hnsw_tpu_torch.Graph.resume_build(ckpt, device="cpu") \
        .host.count == N


def test_deadline_abort_serves_prefix_then_resumes(tmp_path):
    vecs = _data(7)
    keys = list(range(N))
    ckpt = str(tmp_path / "deadline.npz")
    g = hnsw_tpu_torch.Graph(m=8, seed=0, device="cpu")
    with pytest.raises(BuildDeadlineExceeded, match="resume_build") as ei:
        g.build(keys, vecs, method="device", wave=256,
                checkpoint_path=ckpt, abort_deadline=0.0)
    assert ei.value.graph is g
    inserted = int((g.host.levels >= 0).sum())
    assert 256 <= inserted < N, inserted

    # the masked prefix serves like a prefix-only oracle
    n_served = g.mask_pending_for_serve()
    assert n_served == inserted
    q = _data(99, 32)
    _, gt = np_exact_topk(q, vecs[:n_served], 10, "cosine")
    assert _recall(g, q, gt, ef=192) >= 0.85
    keys_served, _ = g.batch_search(q, 10, ef=192)
    assert max(k for row in keys_served for k in row) < n_served

    # masking was in memory only: the checkpoint still resumes
    g2 = hnsw_tpu_torch.Graph.resume_build(ckpt, wave=256, device="cpu")
    assert _complete(g2, keys)
    _, gt = np_exact_topk(q, vecs, 10, "cosine")
    assert _recall(g2, q, gt, ef=192) >= 0.85


def test_host_build_checkpoint_deadline_and_resume(tmp_path):
    vecs = _data(6)
    keys = list(range(N))
    ckpt = str(tmp_path / "hostbuild.npz")
    g = hnsw_tpu_torch.Graph(m=8, seed=0, device="cpu")
    with pytest.raises(BuildDeadlineExceeded, match="resume"):
        g.build(keys, vecs, method="host", wave=128,
                checkpoint_path=ckpt, checkpoint_every=2,
                abort_deadline=0.0)
    g2 = hnsw_tpu_torch.Graph.resume_build(ckpt, wave=128, method="host",
                                           device="cpu")
    assert _complete(g2, keys)
    q = _data(98, 48)
    _, gt = np_exact_topk(q, vecs, 10, "cosine")
    assert _recall(g2, q, gt, ef=128) >= 0.9
    assert hnsw_tpu_torch.Graph.resume_build(
        ckpt, method="auto", device="cpu").host.count == N


def test_jax_deadline_checkpoint_resumes_in_port(tmp_path):
    vecs = _data(8)
    keys = list(range(N))
    ckpt = str(tmp_path / "jax.npz")
    from hnsw_tpu.core.build_device import BuildDeadlineExceeded as JaxDE
    j = hnsw_tpu.Graph(m=8, seed=0)
    with pytest.raises(JaxDE):
        j.build(keys, vecs, method="device", wave=256,
                checkpoint_path=ckpt, abort_deadline=0.0)
    inserted = int((j.host.levels >= 0).sum())
    t = hnsw_tpu_torch.Graph.resume_build(ckpt, wave=256, device="cpu")
    assert _complete(t, keys) and inserted < N
    # the prefix JAX built is kept as it was
    part = j.host.levels >= 0
    np.testing.assert_array_equal(t.host.levels[:len(part)][part],
                                  j.host.levels[part])
    q = _data(99, 32)
    _, gt = np_exact_topk(q, vecs, 10, "cosine")
    assert _recall(t, q, gt, ef=192) >= 0.85


def _mutated_pair(keys):
    """The same graph in both packages: shared native build, then the
    same deletes and a calibrated ef."""
    v = _data(9, len(keys))
    graphs = (hnsw_tpu.Graph(m=8, seed=1),
              hnsw_tpu_torch.Graph(m=8, seed=1, device="cpu"))
    for g in graphs:
        g.build(keys, v, method="host")
        g.batch_delete(keys[3:40:3])
        g.ef_search = 48
    return graphs


@pytest.mark.parametrize("kind", ["int", "mixed"])
def test_checkpoints_cross_between_packages(tmp_path, kind):
    keys = (list(range(500)) if kind == "int"
            else [f"doc-{i}" if i % 2 else i for i in range(500)])
    j, t = _mutated_pair(keys)

    # the same payload, entry by entry (config JSON and key table too)
    pj, pt = jcodec._payload(j), tcodec._payload(t)
    assert sorted(pj) == sorted(pt)
    for name in pj:
        np.testing.assert_array_equal(np.asarray(pt[name]),
                                      np.asarray(pj[name]), err_msg=name)

    def same(a, b):
        assert a.slots.slot_to_key == b.slots.slot_to_key
        assert a.slots.free == b.slots.free
        n = a.slots.capacity_used
        np.testing.assert_array_equal(a.store.vectors[:n],
                                      b.store.vectors[:n])
        np.testing.assert_array_equal(a.store.alive[:n], b.store.alive[:n])
        for x, y in zip(a.host.arrays(), b.host.arrays()):
            np.testing.assert_array_equal(x, y)
        assert a.ef_search == b.ef_search == 48

    pj_path, pt_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jcodec.save_graph(j, pj_path)
    hnsw_tpu_torch.save_graph(t, pt_path)
    same(hnsw_tpu_torch.load_graph(pj_path, device="cpu"), j)
    same(jcodec.load_graph(pt_path), t)
    saved = hnsw_tpu_torch.SavedGraph.load(pj_path, device="cpu")
    same(saved.graph, j)
    assert saved.graph.search(_data(9, 500)[1], 1)[0][0] == keys[1]
