"""The capacity and serving modes on the card against the same code on the CPU.

Marked ``cuda``: skipped where there is no NVIDIA GPU (decided inside the
fixture, never at import). Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda_modes.py``.

The same seeded inputs go through an index on the card and one on the
CPU. The scans' f32 sums run in another order on the two devices, so a
near tie may resolve differently: ids overlap >= 0.99; both rerank with
the same numpy code, so matched distances agree within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hnsw_tpu_torch  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these paths run on the card")
    return torch.device("cuda")


def _data(seed, n, d=48):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


def _agree(a, b):
    (da, ia), (db, ib) = a, b
    hits = sum(len(set(x) & set(y)) for x, y in zip(ia, ib))
    assert hits / ib.size >= 0.99
    same = ia == ib
    np.testing.assert_allclose(da[same], db[same], atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp16"])
def test_capacity_rungs_on_card_match_cpu(cuda, dtype):
    v = _data(1, 70_000)
    batches = [_data(2 + b, 300) for b in range(3)]
    out = {}
    for dev in (cuda, "cpu"):
        idx = hnsw_tpu_torch.ExactIndex(metric="l2", hbm_dtype=dtype,
                                        device=dev)
        idx.batch_add(list(range(len(v))), v)
        out[str(dev)] = [idx.batch_search_slots(b, 10) for b in batches]
        assert idx._dev[0].device.type == torch.device(dev).type
        streamed = list(idx.batch_search_stream(iter(batches), 10))
        for (ds, is_), (d, i) in zip(streamed, out[str(dev)]):
            np.testing.assert_array_equal(is_, i)
            np.testing.assert_array_equal(ds, d)
    for a, b in zip(out["cuda"], out["cpu"]):
        _agree(a, b)


@pytest.mark.parametrize("mode", ["blocks", "float16", "quantized",
                                  "compact"])
def test_graph_modes_on_card_match_cpu(cuda, mode):
    v = _data(3, 6000)
    q = _data(4, 64)
    out = []
    for dev in (cuda, "cpu"):
        g = hnsw_tpu_torch.Graph(m=8, ef_construction=64, seed=0,
                                 device=dev)
        g.build(list(range(len(v))), v, method="host")
        g.native_serve_max_batch = 0
        if mode == "blocks":
            g.fast_math = True
            g.block_layout = True
            g.entry_mode = "pivots"
        elif mode == "compact":
            g.split_layers = "compact"
        else:
            g.hbm_mode = mode
        out.append(g.batch_search_slots(q, 10, ef=64))
    _agree(*out)
