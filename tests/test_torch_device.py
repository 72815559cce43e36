"""The port's entry points never pick the CPU by themselves.

``device=None`` means the CUDA device. Without CUDA (here:
``torch.cuda.is_available`` patched to False) every entry point that
takes ``device=None`` raises and names ``device="cpu"``; with
``device="cpu"`` written out the same calls build and answer.
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu_torch.core import build as tbuild  # noqa: E402
from hnsw_tpu_torch.core import build_device as tbd  # noqa: E402
from hnsw_tpu_torch.core import state as tstate  # noqa: E402
from hnsw_tpu_torch.core.state import default_device  # noqa: E402

NO_CPU_DEFAULT = r'device="cpu"'


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _vecs(n=60, d=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _cpu_graph(n=60):
    g = hnsw_tpu_torch.Graph(m=4, ef_construction=16, seed=0, device="cpu")
    g.build(list(range(n)), _vecs(n), method="host")
    return g


def _saved(tmp_path):
    path = str(tmp_path / "g.npz")
    hnsw_tpu_torch.save_graph(_cpu_graph(), path)
    return path


def _stored_host(n=60):
    """A CPU Graph's host graph with keys 0..n-1 stored, not inserted."""
    g = hnsw_tpu_torch.Graph(m=4, ef_construction=16, seed=0, device="cpu")
    slots = g.slots.assign_fresh_batch(list(range(n)))
    g.store.put_batch(slots, _vecs(n))
    return g, np.asarray(slots, np.int64)


def _from_host_args():
    v = _vecs(8)
    nb = np.full((1, 8, 4), -1, np.int32)
    return (v, np.sum(v * v, 1), nb, np.zeros(8, np.int32),
            np.ones(8, bool), 0)


#: entry point -> call with ``device`` (None leaves the keyword out)
def _call(name, tmp_path, device):
    kw = {} if device is None else {"device": device}
    if name == "ExactIndex":
        return hnsw_tpu_torch.ExactIndex(**kw)
    if name == "Graph":
        return hnsw_tpu_torch.Graph(**kw)
    if name == "bulk_insert":
        g, slots = _stored_host()
        return tbuild.bulk_insert(g.host, slots, wave=32, **kw)
    if name == "bulk_insert_device":
        g, slots = _stored_host()
        return tbd.bulk_insert_device(g.host, slots, wave=32, **kw)
    if name == "refine_device":
        return tbd.refine_device(_cpu_graph().host, wave=32, **kw)
    if name == "from_host":
        return tstate.from_host(*_from_host_args(), **kw)
    if name == "load_graph":
        return hnsw_tpu_torch.load_graph(_saved(tmp_path), **kw)
    if name == "SavedGraph.load":
        return hnsw_tpu_torch.SavedGraph.load(str(tmp_path / "new.npz"),
                                              **kw)
    if name == "resume_build":
        return hnsw_tpu_torch.Graph.resume_build(_saved(tmp_path), **kw)
    if name == "Partitioner":
        return hnsw_tpu_torch.Partitioner(4, **kw)
    if name in ("LSHIndex", "IVFIndex", "HybridIndex",
                "AdaptiveHybridIndex"):
        return getattr(hnsw_tpu_torch, name)(**kw)
    if name == "DiskGraph":
        return hnsw_tpu_torch.DiskGraph(str(tmp_path / "dg"), fmt="npz",
                                        **kw)
    if name == "StreamingExactIndex":
        from hnsw_tpu_torch.index.streaming import StreamingExactIndex
        return StreamingExactIndex(str(tmp_path / "st"), **kw)
    raise AssertionError(name)


ENTRY_POINTS = ["ExactIndex", "Graph", "bulk_insert", "bulk_insert_device",
                "refine_device", "from_host", "load_graph",
                "SavedGraph.load", "resume_build", "LSHIndex", "IVFIndex",
                "Partitioner", "HybridIndex", "AdaptiveHybridIndex",
                "DiskGraph", "StreamingExactIndex"]


def test_default_device_is_the_card_or_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=NO_CPU_DEFAULT):
        default_device()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_no_device_without_cuda_raises(name, tmp_path, no_cuda):
    with pytest.raises(RuntimeError, match=NO_CPU_DEFAULT):
        _call(name, tmp_path, None)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_device_cpu_written_out_runs(name, tmp_path, no_cuda):
    _call(name, tmp_path, "cpu")


def test_cpu_index_and_graph_answer(no_cuda):
    """With device="cpu" the exact tier and the graph answer: a stored
    vector finds itself."""
    v = _vecs()
    idx = hnsw_tpu_torch.ExactIndex(metric="l2", device="cpu")
    idx.batch_add(list(range(len(v))), v)
    _, ids = idx.batch_search_slots(v[:5], 1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(5))
    g = _cpu_graph()
    assert g.device.type == "cpu"
    _, ids = g.batch_search_slots(v[:5], 1, ef=32)
    np.testing.assert_array_equal(ids[:, 0], np.arange(5))


def test_bulk_insert_on_cpu_inserts_every_node(no_cuda):
    g, slots = _stored_host()
    tbuild.bulk_insert(g.host, slots, wave=32, device="cpu")
    assert g.host.count == len(slots)
    assert (g.host.levels[:len(slots)] >= 0).all()


def test_hybrid_engines_on_cpu_answer(no_cuda):
    """With device="cpu" the hybrid and the adaptive engine answer: a
    stored vector is its own nearest neighbour."""
    v = _vecs(300, 16)
    for cls in (hnsw_tpu_torch.HybridIndex, hnsw_tpu_torch.AdaptiveHybridIndex):
        idx = cls(hnsw_tpu_torch.HybridConfig(exact_threshold=100),
                  device="cpu")
        idx.batch_add(list(range(300)), v)
        key, dist = idx.search(v[42], 3)[0]
        assert key == 42 and dist < 1e-5
        idx.close()


def _imported_roots(path):
    """Top-level names of every module a file imports, anywhere in it."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_port_imports_neither_jax_nor_the_jax_package():
    root = pathlib.Path(hnsw_tpu_torch.__file__).resolve().parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    assert len(files) > 20 and files[-1].exists()
    bad = {str(f.relative_to(root.parent)): sorted(
        _imported_roots(f) & {"jax", "jaxlib", "hnsw_tpu"}) for f in files}
    assert {f: r for f, r in bad.items() if r} == {}
