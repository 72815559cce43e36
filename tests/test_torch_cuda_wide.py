"""K5, K2 and K4 at rows wider than 128, on the card.

The 1,536-wide configuration (``portbench/configs/
dbpedia-openai1536-cos-hnsw.json``) runs K5's and K2's scoring loop
(``score_list``: one 16-byte load a lane a row for each 128 elements) 12
times a row where the other cells run it once, and stages K4's rows in
slabs. Every test here is marked ``cuda`` (skipped without an NVIDIA GPU;
decided in the fixture):

* K5 at D = 132, 516 and 1,536 against its plain version
  (``_k5_vs_plain``: K2 a layer, and K2's twin a layer) in every row store
  (f32, fp16, bf16, the int8 capacity mode) and in f32 and bf16 scoring,
  cosine and l2; on integer rows bit for bit; a misaligned view of the
  rows (scalar loads) and a batch of 2,048 queries (more blocks than the
  card holds at once);
* K2, one layer a launch, against its twin at those widths;
* K4's slab path at C 96, D 1,536 against ``_diverse_select_reference``,
  and the launches it counts by layout (``launches_by_layout``), also
  through a device build of 1,536-wide rows;
* the registers and spills ptxas reports for the D <= 128 f32
  instantiations that the benchmark's other cells run (K5 f32+f32 and
  K2's f32 kernels), as the parent commit reported them.

Run on a GPU machine with ``python3 -m pytest --noconftest
tests/test_torch_cuda_wide.py -m cuda``. This file imports no JAX.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu_torch.core import search as tsearch  # noqa: E402
from hnsw_tpu_torch.core.state import from_host  # noqa: E402
from hnsw_tpu_torch.ops import beam_search as bs  # noqa: E402
from hnsw_tpu_torch.ops import diverse_select as ds  # noqa: E402
from hnsw_tpu_torch.ops import graph_search as gs  # noqa: E402
from hnsw_tpu_torch.ops.distance import INF_DIST  # noqa: E402

from .test_torch_cuda_graph_search import (LAYOUTS, _arrays,  # noqa: E402
                                           _k5_vs_plain)
from .test_torch_cuda_select import _batch, _both, _hold, _store  # noqa: E402

WIDTHS = [132, 516, 1536]
#: the row stores K5 scores wide rows from, with fast_math
STORES = {"f32": ("dense", False), "bf16": ("dense", True),
          "fp16rows": ("float16", False), "bf16rows": ("bfloat16", False),
          "qrows": ("quantized", False)}
#: ptxas's registers and spill bytes (stores, loads) of the instantiations
#: the D <= 128 cells run, as the parent commit's build reports them
NARROW_F32 = {"K5 f32+f32/vec": (64, 104, 376), "f32/vec": (64, 0, 0),
              "f32/scalar": (64, 0, 0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


_HOSTS = {}


def _host(D, kind):
    """Host arrays of a 3,000-row graph of width D (kept for the module):
    Gaussian rows for "cosine" / "l2", integer rows in -2..2 (a fifth
    copies) for "int"."""
    if (D, kind) not in _HOSTS:
        r = np.random.default_rng(D)
        if kind == "int":
            v = r.integers(-2, 3, (3000, D)).astype(np.float32)
            v[2400:] = v[:600]
        else:
            v = (r.standard_normal((3000, D)) / np.sqrt(D)).astype(
                np.float32)
        _HOSTS[D, kind] = _arrays("l2" if kind == "int" else kind, v)
    return _HOSTS[D, kind]


def _queries(D, n, device, seed=0, integer=False):
    r = np.random.default_rng(seed)
    q = (r.integers(-2, 3, (n, D)) if integer
         else r.standard_normal((n, D)) / np.sqrt(D)).astype(np.float32)
    return torch.from_numpy(q).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("D", WIDTHS)
def test_k5_at_wide_rows_matches_the_plain_version(cuda, D, store, metric):
    layout, fast_math = STORES[store]
    g = from_host(*_host(D, metric), metric=metric, device=cuda,
                  **LAYOUTS[layout])
    q = _queries(D, 64, cuda, seed=1)
    ki, hops = _k5_vs_plain(g, q, k=10, ef=64, metric=metric, expand=4,
                            merge="bitonic", fast_math=fast_math,
                            store_normalized=metric == "cosine")
    assert (ki >= 0).all() and len(hops) == g.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("D", WIDTHS)
def test_k5_at_wide_rows_equals_the_plain_version_on_integer_data(cuda, D):
    """Integer rows: every sum is exact in f32, so K5 gives K2 a layer's
    and the twin's ids, distances and hops bit for bit."""
    g = from_host(*_host(D, "int"), metric="sqeuclidean", device=cuda)
    q = _queries(D, 64, cuda, seed=2, integer=True)
    for merge in ("bitonic", "sort"):
        ki, _ = _k5_vs_plain(g, q, k=10, ef=64, metric="sqeuclidean",
                             expand=4, merge=merge, exact=True)
        assert (ki >= 0).all()


def _misaligned(t):
    """``t`` as a view one element into a buffer of its dtype: the same
    values at an address 16-byte loads cannot take."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("D", WIDTHS)
def test_k5_misaligned_rows_and_a_batch_past_one_wave(cuda, D):
    """A view of the rows off 16-byte alignment (K5 takes its scalar
    loads) gives the aligned rows' results on a batch of 2,048 queries,
    more blocks than the card holds resident at once; integer rows, so
    both loops' sums are exact and the results equal bit for bit."""
    g = from_host(*_host(D, "int"), metric="sqeuclidean", device=cuda)
    q = _queries(D, 2048, cuda, seed=3, integer=True)
    plan = gs.search_kernel_applies(g, "sqeuclidean", q, 64, 8, 4,
                                    "bitonic")
    per_sm = gs._load().graph_search_blocks_per_sm(0, 0, 1, plan["smem"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert 0 < per_sm * sms < q.shape[0]
    kw = dict(k=10, ef=64, metric="sqeuclidean", expand=4, merge="bitonic",
              exact=True)
    ki, _ = _k5_vs_plain(g, q, **kw)
    view = g._replace(vectors=_misaligned(g.vectors))
    assert view.vectors.data_ptr() % 16
    kv, _ = _k5_vs_plain(view, q, **kw)
    np.testing.assert_array_equal(kv, ki)


def _k2_vs_twin(g, layer, q, P, metric):
    """One K2 launch for ``layer`` from the graph's entry against the twin:
    ids overlap >= 0.99, distances of shared ids within 1e-5 x max(1,
    |d|), hop counts equal."""
    q_sq = torch.sum(q * q, dim=-1)
    ids = g.entry.expand(q.shape[0]).to(torch.int32)[:, None]
    d = tsearch._score_hop(g, q, q_sq, torch.clamp(ids, 0, g.cap - 1),
                           metric, "highest")
    kw = dict(pool_size=P, max_hops=64, metric=metric, precision="highest",
              expand=4, merge="bitonic",
              store_normalized=metric == "cosine")
    bs.launches = 0
    ks, ts = {}, {}
    kd, ki = tsearch.beam_search_layer(g, layer, q, q_sq, ids, d, stats=ks,
                                       **kw)
    torch.cuda.synchronize()
    assert bs.launches == 1
    rd, ri = tsearch.beam_search_layer_reference(g, layer, q, q_sq, ids, d,
                                                 stats=ts, **kw)
    kd, ki, rd, ri = (t.cpu().numpy() for t in (kd, ki, rd, ri))
    assert ((ki < 0) == (kd >= float(INF_DIST))).all()
    hits, n, err = 0, 0, 0.0
    for a_d, a_i, b_d, b_i in zip(kd, ki, rd, ri):
        pos = {int(x): j for j, x in enumerate(a_i) if x >= 0}
        for j, x in enumerate(b_i):
            if x >= 0:
                n += 1
                if int(x) in pos:
                    hits += 1
                    err = max(err, abs(float(a_d[pos[int(x)]]) - float(
                        b_d[j])) / max(1.0, abs(float(b_d[j]))))
    assert hits >= 0.99 * n and err <= 1e-5, (hits, n, err)
    assert ks["hops"] == ts["hops"]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("D", WIDTHS)
def test_k2_at_wide_rows_matches_its_twin(cuda, D, metric):
    g = from_host(*_host(D, metric), metric=metric, device=cuda)
    q = _queries(D, 64, cuda, seed=4)
    for layer in range(g.num_layers - 1, -1, -1):
        _k2_vs_twin(g, layer, q, 64 if layer == 0 else 8, metric)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("gaussian", [False, True])
def test_k4_slab_path_at_the_1536_layer0_shape(cuda, gaussian, metric):
    """C 96, D 1,536: the staged rows (96 x 1,544 bf16) do not fit the
    block's row budget, so D is staged in slabs; the kernel gives the
    twin's rows (integer rows exactly in l2, >= 0.99 of them in cosine) and
    counts one launch by slabs."""
    assert ds.layout(96, 1536)["n_slabs"] > 1
    vectors, sq = _store(17, 4000, 1536, cuda, gaussian=gaussian)
    ci, cd = _batch(18, vectors, sq, 256, 96, metric, near=gaussian)
    ds.launches_by_layout.update(whole=0, slabs=0)
    got, want = _both(ci, cd, vectors, sq, 32, metric, True)
    assert ds.launches_by_layout == {"whole": 0, "slabs": 1}
    _hold(got, want, metric)
    # without diversify no row is staged: counted whole
    _both(ci, cd, vectors, sq, 32, metric, False)
    assert ds.launches_by_layout == {"whole": 1, "slabs": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("D,layout", [(128, "whole"), (1536, "slabs")])
def test_device_build_counts_its_selections_by_layout(cuda, D, layout):
    """A device build of 4,000 rows on the card runs K2 and K4 alone (no
    twin) and stages every selection whole at D = 128, and the wide ones
    in slabs at 1,536 (a call of at most 16 candidates fits whole); the
    graph finds >= 0.9 of the exact top 10."""
    r = np.random.default_rng(D)
    v = (r.standard_normal((4000, D)) / np.sqrt(D)).astype(np.float32)
    g = hnsw_tpu_torch.Graph(m=16, ef_construction=100, metric="cosine",
                             seed=1, device=cuda)
    ds.launches = 0
    ds.launches_by_layout.update(whole=0, slabs=0)
    ds.plain_on_cuda.update(mode=0, size=0, other=0)
    bs.twin_layers_on_cuda.update(mode=0, size=0, other=0)
    g.build(list(range(len(v))), v, method="device", wave=512)
    torch.cuda.synchronize()
    assert ds.plain_on_cuda == {"mode": 0, "size": 0, "other": 0}
    assert bs.twin_layers_on_cuda == {"mode": 0, "size": 0, "other": 0}
    assert ds.launches_by_layout[layout] > 0
    assert sum(ds.launches_by_layout.values()) == ds.launches
    if layout == "whole":
        assert ds.launches_by_layout["slabs"] == 0
    q = v[:200] + 0.01 * r.standard_normal((200, D)).astype(np.float32)
    _, ids = g.batch_search_slots(q, 10, ef=64)
    u = v / np.linalg.norm(v, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    truth = np.argsort(-(qn @ u.T), axis=1)[:, :10]
    hits = (ids[:, :, None] == truth[:, None, :]).any(-1).sum()
    assert hits / ids.size >= 0.9


@pytest.mark.cuda
def test_narrow_f32_instantiations_keep_their_registers(cuda):
    """ptxas's report of the shipped build: the f32 instantiations that
    the D <= 128 cells run keep the parent commit's registers and spills,
    so a change for wide rows leaves their code as it was."""
    from hnsw_tpu_torch.tools.hop_split import parse_ptxas
    bs._load()
    with open(os.path.join(bs.BUILD_DIR, "beam_search.ptxas.txt")) as f:
        regs = parse_ptxas(f.read())
    for name, (n_reg, stores, loads) in NARROW_F32.items():
        got = regs[name]
        assert (got["registers"], got.get("spill_stores", 0),
                got.get("spill_loads", 0)) == (n_reg, stores, loads), name
