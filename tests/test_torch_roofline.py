"""utils/roofline of the port against hnsw_tpu/utils/roofline.py.

``scan_flops`` and ``roofline_fields(platform="cpu")`` equal JAX's for
the same arguments (exactly: both round the same float expressions);
``platform="gpu"`` divides by the card's bf16 peak from ``PEAKS``;
``screen_bound_s`` reproduces the bounds PERF.md section 6 records for
K1 within 0.001 ms (those were printed to three decimals from peaks
rounded to 495 and 989 TFLOP/s; the table holds the data sheet's 494.7
and 989.4, 0.06% apart).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.utils import roofline as jroof  # noqa: E402

from hnsw_tpu_torch.utils import roofline  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
SHAPES = [(1024, 1 << 20, 128), (8192, 8 << 20, 128), (256, 10_000, 512),
          (64, 800, 32)]


@pytest.fixture(autouse=True)
def _no_override(monkeypatch):
    monkeypatch.delenv("HNSW_TPU_PEAK_FLOPS", raising=False)


@pytest.mark.parametrize("shape", SHAPES)
def test_scan_flops_equals_jax(shape):
    assert roofline.scan_flops(*shape) == jroof.scan_flops(*shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("floor_dt", [None, 0.0031, 0.0])
def test_roofline_fields_on_the_cpu_equal_jax(shape, floor_dt):
    n_q, n, d = shape
    for dt in (1e-3, 0.0417, 2.5):
        kw = dict(n_q=n_q, n=n, d=d, dt=dt, floor_dt=floor_dt,
                  platform="cpu")
        assert roofline.roofline_fields(**kw) == jroof.roofline_fields(**kw)


def test_gpu_mfu_is_against_the_cards_bf16_peak():
    n_q, n, d, dt = 8192, 1 << 20, 128, 0.0123
    fl = 2.0 * n_q * n * d
    got = roofline.roofline_fields(n_q=n_q, n=n, d=d, dt=dt, floor_dt=0.01,
                                   platform="gpu", device_name=H100)
    assert got == {"achieved_tflops": round(fl / dt / 1e12, 2),
                   "mfu": round(fl / dt / 989.4e12, 4),
                   "floor_frac": round(0.01 / dt, 3)}
    assert roofline.PEAKS[H100] == {"bf16": 989.4e12, "tf32": 494.7e12,
                                    "int8": 1979e12, "fp32": 66.9e12,
                                    "hbm_bytes_s": 3.35e12}


def test_hop_bound_counts_the_rows_it_scores():
    """K2's bound: bytes of the query rows, start entries, ids of the
    distinct expanded nodes, the distinct scored rows and the pools
    written, over 3.35 TB/s; or 2 d operations a scored row over the
    operands' peak, when larger. A row scored by many queries counts once;
    with the totals over the queries the bound is the one without reuse."""
    t, by = roofline.hop_bound_s(1024, 128, 64, 1, 32, 40_000, 90_000,
                                 600_000, 516, "fp32")
    per_query = 1024 * (512 + 4 + 8 + 512 + 12)
    moved = per_query + 4 * 32 * 40_000 + 516 * 90_000
    assert by == "bytes" and t == moved / 3.35e12
    t_all, _ = roofline.hop_bound_s(1024, 128, 64, 1, 32, 80_000, 600_000,
                                    600_000, 516, "fp32")
    assert t_all == (per_query + 4 * 32 * 80_000 + 516 * 600_000) / 3.35e12
    assert t_all > t
    t, by = roofline.hop_bound_s(1, 1 << 16, 8, 1, 8, 1, 1, 1 << 20, 4,
                                 "fp32")
    assert by == "operations" and t == 2.0 * (1 << 16) * (1 << 20) / 66.9e12


def test_unknown_card_and_no_card_give_no_mfu(monkeypatch):
    kw = dict(n_q=64, n=4096, d=64, dt=1e-3, platform="gpu")
    assert "mfu" not in roofline.roofline_fields(**kw, device_name="Tesla X")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert roofline.peak_flops() is None
    assert "mfu" not in roofline.roofline_fields(**kw)


def test_peak_override_from_the_environment(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_PEAK_FLOPS", "1e15")
    got = roofline.roofline_fields(n_q=10, n=100, d=10, dt=1e-6,
                                   platform="gpu", device_name="Tesla X")
    assert got["mfu"] == round(2e4 / 1e-6 / 1e15, 4)


def test_floor_frac_is_not_clipped():
    got = roofline.roofline_fields(n_q=8, n=64, d=8, dt=1e-3, floor_dt=3e-3,
                                   platform="cpu")
    assert got["floor_frac"] == 3.0


@pytest.mark.parametrize("fast", [False, True])
def test_matmul_floor_runs_in_both_precisions_on_the_cpu(fast):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((16, 32), generator=g)
    v = torch.randn((1000, 32), generator=g)
    q0, v0 = q.clone(), v.clone()
    dt = roofline.matmul_floor_dt(q, v, fast_math=fast, reps=3, chunk=384)
    assert np.isfinite(dt) and dt > 0
    assert torch.equal(q, q0) and torch.equal(v, v0)


@pytest.mark.parametrize("nq,n,d,fast,perf_ms", [
    (1024, 1 << 20, 128, False, 1.666),    # PERF section 6, f32
    (1024, 1 << 20, 128, True, 0.278),     # fast_math
    (1024, 1_183_514, 50, False, 0.734),   # glove-50's shape, f32
])
def test_screen_bound_reproduces_the_recorded_bounds(nq, n, d, fast,
                                                     perf_ms):
    s, by, peak = roofline.screen_bound_s(nq, n, d, 18, fast)
    assert by == "operations"
    assert peak == roofline.PEAKS[H100]["bf16" if fast else "tf32"]
    assert s * 1e3 == pytest.approx(perf_ms, abs=1e-3)


def test_screen_bound_of_a_single_query_is_the_bytes():
    n, d = 1 << 20, 128
    s, by, _ = roofline.screen_bound_s(1, n, d, 18, False)
    moved = 4 * (d + n * d + n) + n + 8 * 18
    assert by == "bytes" and s == moved / 3.35e12


@pytest.mark.parametrize("store,passes,kind,ms", [
    ("int8", 1, "bf16", 0.278),    # one bf16 pass (int8 exact in bf16)
    ("bf16", 1, "bf16", 0.278),
    ("fp16", 2, "tf32", 1.111),    # 2xTF32: the f32 query split hi + lo
])
def test_capacity_screen_bound_by_store(store, passes, kind, ms):
    """The capacity screen's bound at the exact tier's shape (Q=1024,
    N=2^20, D=128; kk 26 for int8, 14 for the 16-bit tables): operations,
    its product's passes at the peak of their type; fast_math and f32
    keep their bounds whatever the store argument's default."""
    nq, n, d = 1024, 1 << 20, 128
    kk = 26 if store == "int8" else 14
    s, by, peak = roofline.screen_bound_s(nq, n, d, kk, store=store)
    assert roofline.CAPACITY_PRODUCT[store][:2] == (passes, kind)
    assert by == "operations" and peak == roofline.PEAKS[H100][kind]
    assert s == passes * 2.0 * nq * n * d / peak
    assert s * 1e3 == pytest.approx(ms, abs=1e-3)
    assert roofline.screen_bound_s(nq, n, d, 18, False) == \
        roofline.screen_bound_s(nq, n, d, 18, False, "float32")


@pytest.mark.parametrize("store,value_bytes,scale_bytes", [
    ("float32", 4, 0), ("int8", 1, 4), ("bf16", 2, 0), ("fp16", 2, 0)])
def test_screen_bound_bytes_by_store(store, value_bytes, scale_bytes):
    """One query: the bytes bound. The table at its value's bytes, the
    f32 norms, the mask, int8's f32 scales, the query and the keys, each
    moved once."""
    n, d, kk = 1 << 20, 128, 26
    s, by, _ = roofline.screen_bound_s(1, n, d, kk, store=store)
    moved = 4 * d + value_bytes * n * d + 4 * n + n + scale_bytes * n \
        + 8 * kk
    assert by == "bytes" and s == moved / 3.35e12
    assert roofline.STORE_BYTES[store] == value_bytes


def test_search_bound_counts_each_layer_once_and_no_pools():
    """K5's bound: every layer's distinct node ids and rows, the rerank's
    rows and the outputs, once; the operations summed by type. It sits at
    or below the sum of hop_bound_s over the same layers, which also
    writes and reads every layer's pool."""
    layers = [(16, 900, 4_000, 30_000, 516, "fp32"),
              (32, 40_000, 90_000, 1_500_000, 516, "fp32")]
    t, by = roofline.search_bound_s(1024, 128, 10, 1, layers, 18_000, 516,
                                    20_480)
    peaks = roofline.PEAKS[roofline.H100_SXM]
    moved = (1024 * (4 * 128 + 4 + 4 + 8 * 10 + 4 * 2)
             + 4 * 16 * 900 + 516 * 4_000 + 4 * 32 * 40_000
             + 516 * 90_000 + 516 * 18_000)
    ops_s = 2.0 * 128 * (30_000 + 1_500_000 + 20_480) / peaks["fp32"]
    assert by == "bytes" and t == pytest.approx(moved / peaks["hbm_bytes_s"])
    assert ops_s < t
    per_layer = sum(roofline.hop_bound_s(1024, 128, 64, 1, w, n, r, sc, rb,
                                         kind)[0]
                    for w, n, r, sc, rb, kind in layers)
    assert t <= per_layer + 516 * 18_000 / peaks["hbm_bytes_s"]
    # int8 operands: the rows' bytes bound it
    t8, by8 = roofline.search_bound_s(
        1024, 128, 10, 16, [(32, 40_000, 90_000, 1_500_000, 128, "int8")])
    assert by8 == "bytes"
    assert t8 == pytest.approx(
        (1024 * (4 * 128 + 4 + 4 * 16 + 8 * 10 + 4) + 4 * 32 * 40_000
         + 128 * 90_000) / peaks["hbm_bytes_s"])
