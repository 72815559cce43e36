"""tools/select_split: where a call of K4, the wave builder's
neighbour-selection kernel, goes.

The report's arithmetic (each phase's share of the slowest block's cycles
and of all blocks' cycles) on synthetic counters; ptxas's ``-v`` report
parsed per instantiation; the phase and store names in the kernel's
order; the cases against the smoke's phase-8b shapes; the slate and its
bound on small CPU rows; and that the tool raises without a CUDA card.
"""

import os
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu_torch.core import build as tbuild  # noqa: E402
from hnsw_tpu_torch.ops import diverse_select as ds  # noqa: E402
from hnsw_tpu_torch.tools import select_split as ss  # noqa: E402
from hnsw_tpu_torch.utils import roofline  # noqa: E402

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121diverse_select_kernelILi0ELb1ELb1EEEvPKiPKfPKvS4_iiiiiiiPiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121diverse_select_kernelILi0ELb1ELb1EEEvPKiPKfPKvS4_iiiiiiiPiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121diverse_select_kernelILi1ELb0ELb1EEEvPKiPKfPKvS4_iiiiiiiPiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121diverse_select_kernelILi1ELb0ELb1EEEvPKiPKfPKvS4_iiiiiiiPiPf
    8 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121diverse_select_kernelILi0ELb0ELb0EEEvPKiPKfPKvS4_iiiiiiiPiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121diverse_select_kernelILi0ELb0ELb0EEEvPKiPKfPKvS4_iiiiiiiPiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121diverse_select_kernelILi2ELb1ELb1EEEvPKiPKfPKvS4_iiiiiiiPiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121diverse_select_kernelILi2ELb1ELb1EEEvPKiPKfPKvS4_iiiiiiiPiPf
    24 bytes stack frame, 24 bytes spill stores, 76 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z11other_kernelv' for 'sm_90a'
ptxas info    : Used 12 registers, 352 bytes cmem[0]
"""


def test_parse_ptxas_reads_each_instantiation():
    """The kernel's (store, vec, diversify) instantiations; another
    kernel's lines are skipped."""
    assert ss.parse_ptxas(PTXAS) == {
        "f32/vec": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                    "registers": 72},
        "fp16/scalar": {"stack": 8, "spill_stores": 12, "spill_loads": 8,
                        "registers": 80},
        "without diversify": {"stack": 0, "spill_stores": 0,
                              "spill_loads": 0, "registers": 30},
        "bf16/vec": {"stack": 24, "spill_stores": 24, "spill_loads": 76,
                     "registers": 64}}


def _source():
    with open(ds.SOURCE) as f:
        return f.read()


def test_phases_and_stores_follow_the_kernel():
    """PHASES names the kernel's PH_* counters in their order; STORE_NAMES
    its ST_* codes, which are the wrapper's STORES."""
    src = _source()
    enum = re.search(r"enum \{ (PH_A = 0,[^}]*)\}", src).group(1)
    names = [n.split("=")[0].strip() for n in enum.split(",") if n.strip()]
    assert names == ["PH_A", "PH_STAGE", "PH_PRODUCT", "PH_BITS", "PH_SCAN",
                     "N_PHASE"]
    assert len(ss.PHASES) == len(names) - 1
    assert [p.split(":")[0] for p in ss.PHASES] == [
        "A", "G-stage", "G-product", "G-bits", "S"]
    assert "SELECT_PHASE_CLOCKS" in src and ss.CLOCKS == "SELECT_PHASE_CLOCKS"
    stores = re.search(r"enum Store \{([^}]*)\}", src).group(1)
    codes = {n.split("=")[0].strip(): int(n.split("=")[1])
             for n in stores.split(",") if n.strip()}
    assert codes == {"ST_F32": 0, "ST_F16": 1, "ST_BF16": 2}
    assert ss.STORE_NAMES == {0: "f32", 1: "fp16", 2: "bf16"}
    assert sorted(ds.STORES.values()) == sorted(ss.STORE_NAMES)


def test_the_layout_constants_follow_the_source():
    """The wrapper's copy of the kernel's row budget and limits."""
    src = _source()
    assert "#define DIVERSE_SELECT_ROW_BUDGET (96 * 1024)" in src
    assert ds.ROW_BUDGET == 96 * 1024
    assert f"kSmemMax = {ds.SMEM_MAX};" in src
    assert f"kMaxC = {ds.SELECT_MAX_C};" in src


def test_phase_report_splits_the_slowest_block():
    cycles = np.zeros((3, len(ss.PHASES)), dtype=np.int64)
    cycles[0] = [10, 50, 20, 10, 10]              # 100 cycles
    cycles[1] = [40, 200, 80, 40, 40]             # 400: the slowest
    cycles[2] = [0, 0, 0, 0, 0]                   # a block with no row
    rep = ss.phase_report(cycles, kernel_ms=0.2)
    assert rep["slowest_block"] == 1 and rep["slowest_cycles"] == 400
    assert sum(rep["shares"].values()) == pytest.approx(1.0)
    assert rep["shares"][ss.PHASES[1]] == pytest.approx(0.5)
    assert rep["ms_by_phase"][ss.PHASES[1]] == pytest.approx(0.1)
    assert rep["all_blocks"][ss.PHASES[0]] == pytest.approx(50 / 500)
    line = ss.format_report(rep)
    assert "slowest block 1 (400 cycles)" in line
    assert "G-stage 0.500" in line and "all blocks: A 0.100" in line


def test_cases_hold_phase_8b_and_the_slab_path():
    """The layer-0 call (P 2,048, C 96, deg 32) in f32 and fp16 on both
    kinds of rows, without diversify, C 64 both ways, C 252 at P 512 / deg
    84 (whole rows) and C 1,024 (slabs at D 128)."""
    by = {c.label: c for c in ss.CASES}
    assert len(by) == len(ss.CASES)
    layer0 = [c for c in ss.CASES if (c.P, c.C, c.deg) == (2048, 96, 32)]
    assert {(c.kind, c.dtype, c.diversify) for c in layer0} >= {
        ("integer", torch.float32, True), ("gaussian", torch.float32, True),
        ("integer", torch.float16, True), ("gaussian", torch.float16, True),
        ("gaussian", torch.float32, False)}
    c64 = {(c.kind, c.diversify) for c in ss.CASES if c.C == 64}
    assert c64 == {(k, d) for k in ("integer", "gaussian")
                   for d in (True, False)}
    wide = by["gaussian C 252 (m = 42)"]
    assert (wide.P, wide.n_cand + wide.intra_k, wide.deg) == (512, 252, 84)
    assert ds.layout(252, ss.DIM)["n_slabs"] == 1
    big = by["gaussian C 1,024"]
    assert big.n_cand + big.intra_k == big.C == ds.SELECT_MAX_C
    assert ds.layout(big.C, ss.DIM)["n_slabs"] > 1
    for c in ss.CASES:
        assert c.C <= c.n_cand + c.intra_k and c.dtype in ds.STORES


def test_inputs_slate_and_bound_on_the_cpu():
    """make_inputs on small CPU rows: each case's slate (its P rows, C
    columns; each row's nearest of the others, then of the wave), the
    store's dtype and its norms; the twin takes them; the data's bound is
    the roofline's over its distinct valid rows and pairs."""
    cases = [ss.Case("i", "integer", torch.float32, 64, 24, 8, 32, 8),
             ss.Case("g", "gaussian", torch.float16, 64, 24, 8, 20, 8),
             ss.Case("g32", "gaussian", torch.float32, 64, 24, 8, 32, 8)]
    inp = ss.make_inputs(cases, device="cpu", n=2000, dim=16)
    for c in cases:
        ci, cd, v, sq = inp[c.label]
        assert ci.shape == cd.shape == (c.P, c.C) and v.dtype == c.dtype
        assert v.shape == (2000, 16) and sq.shape == (2000,)
        np.testing.assert_allclose(sq.numpy(), (v.float() ** 2).sum(-1),
                                   rtol=1e-6)
        assert (ci[:, :min(c.C, c.n_cand)] >= c.P).all()      # the others
        assert (ci[:, c.n_cand:] < c.P).all()                 # the wave
        assert (cd[:, :min(c.C, c.n_cand)].diff(dim=1) >= 0).all()
        rows = tbuild._diverse_select_reference(
            ci, cd, v, sq, deg=c.deg, metric="l2", diversify=True)
        assert rows.shape == (c.P, min(c.C, c.deg))
    assert (inp["i"][2] == inp["i"][2].round()).all()
    ci, cd, v, _ = inp["g32"]
    b = ss.data_bound(ci, cd, 16, 8, True)
    n_rows = len(np.unique(ci.numpy()))
    t, by = roofline.select_bound_s(64, 32, 16, 8, rows=n_rows,
                                    pairs=64 * 32 * 31 // 2)
    assert b["rows"] == n_rows and b["pairs"] == 64 * 32 * 31 // 2
    assert b["bound_ms"] == pytest.approx(t * 1e3) and b["bound_by"] == by
    flat, _ = roofline.select_bound_s(64, 32, 16, 8)
    assert b["no_reuse_bound_ms"] == pytest.approx(flat * 1e3)
    half = ss.data_bound(ci, cd, 16, 8, True, store_bytes=2)
    assert half["no_reuse_bound_ms"] < b["no_reuse_bound_ms"]
    none = ss.data_bound(ci, cd, 16, 8, False)
    assert none["bound_ms"] < b["bound_ms"]


def test_main_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ss.main(["--out", str(tmp_path)])
    assert not os.listdir(tmp_path)               # nothing was built


def test_wrapper_of_loads_another_checkouts_own_wrapper(tmp_path):
    """--parent SRC: the ops/diverse_select.py beside SRC's csrc/, loaded
    as a module of its own (its own counters, SOURCE and build directory;
    this package's module untouched); a source that is not that
    checkout's raises."""
    pkg = tmp_path / "other" / "hnsw_tpu_torch"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    shutil.copy(ds.__file__, pkg / "ops" / "diverse_select.py")
    shutil.copy(ds.SOURCE, pkg / "csrc" / "diverse_select.cu")
    src = str(pkg / "csrc" / "diverse_select.cu")
    mod = ss.wrapper_of(src, str(tmp_path / "out"))
    assert mod is not ds and mod.SOURCE == src
    assert mod.BUILD_DIR == str(tmp_path / "out")
    assert ds.BUILD_DIR != mod.BUILD_DIR and ds.SOURCE != src
    before = ds.launches
    mod.launches = before + 7
    assert ds.launches == before
    assert callable(mod.diverse_select_cuda) and callable(mod._load)
    assert not os.path.exists(tmp_path / "out")       # nothing built
    with pytest.raises(ValueError, match="builds"):
        ss.wrapper_of(str(pkg / "csrc" / "other.cu"), str(tmp_path / "out"))


def test_build_all_runs_every_job_and_raises_their_errors_together():
    done = []

    def ok(name):
        return lambda: done.append(name)

    def bad(name):
        def go():
            raise RuntimeError(f"{name} failed")
        return go

    ss.build_all({"a": ok("a"), "b": ok("b")})
    assert sorted(done) == ["a", "b"]
    with pytest.raises(RuntimeError) as e:
        ss.build_all({"c": ok("c"), "x": bad("x"), "y": bad("y")})
    assert "x: x failed" in str(e.value) and "y: y failed" in str(e.value)
    assert "c" in done


def test_device_ms_refuses_a_trace_without_the_kernels_records(monkeypatch):
    """device_ms reads each launch's time from a torch.profiler trace; a
    trace that holds fewer K4 kernel records than launches (here, on the
    CPU, none) raises instead of reading as a time."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    with pytest.raises(RuntimeError, match="0 kernel records of 3"):
        ss.device_ms(lambda: calls.append(1), calls=3)
    assert len(calls) == 4                        # a warm-up, then 3


CELL = "dbpedia1536-cos.b8192.ef64"


def test_cell_cases_follow_the_configuration():
    """--cell: the builder's layer-0 call (a wave, 64 of the others and 32
    of the wave a row, C 96, deg m0) with and without diversify, and the
    reverse update's C 64, on the cell's own rows."""
    from portbench import cells
    conf = cells.load(CELL).config
    cases = {c.label: c for c in ss.cell_cases(conf)}
    layer0 = cases["cell layer 0"]
    assert (layer0.P, layer0.n_cand, layer0.intra_k, layer0.C,
            layer0.deg) == (conf["wave"], 64, 32, 96, conf["m0"])
    assert not cases["cell layer 0 without diversify"].diversify
    assert cases["cell C 64"].C == 64
    assert {c.kind for c in cases.values()} == {"cell"}
    # at the cell's width the diversifying rows are staged in slabs
    assert ds.layout(96, conf["dim"])["n_slabs"] > 1
    assert ds.layout(64, conf["dim"])["n_slabs"] > 1


def test_make_inputs_takes_given_rows_in_the_cells_metric():
    """Rows of a kind made elsewhere (a cell's normalised store) are used
    as given, and the slate is scored in the metric asked for."""
    r = np.random.default_rng(4)
    v = torch.from_numpy(r.standard_normal((600, 24)).astype(np.float32))
    v = v / v.norm(dim=1, keepdim=True)
    case = ss.Case("c", "cell", torch.float32, 64, 24, 8, 32, 8)
    ((ci, cd, got, sq),) = ss.make_inputs([case], device="cpu",
                                          given={"cell": v},
                                          metric="cosine").values()
    assert got is v and ci.shape == cd.shape == (64, 32)
    anchors = torch.arange(64)
    want = 1.0 - (v[anchors][:, None, :] * v[ci.long()]).sum(-1)
    np.testing.assert_allclose(cd.numpy(), want.numpy(), atol=1e-5)
    rows = tbuild._diverse_select_reference(ci, cd, v, sq, deg=8,
                                            metric="cosine", diversify=True)
    assert rows.shape == (64, 8)


def test_timed_selections_sum_each_calls_event_pair(monkeypatch):
    """Every diverse_select_cuda call inside the block is bracketed by an
    event pair; the block's dict holds their number and summed time, and
    the wrapper is restored."""
    stamps = iter(range(100))

    class Event:
        def __init__(self, **kw):
            self.t = None

        def record(self):
            self.t = next(stamps)

        def elapsed_time(self, end):
            return float(end.t - self.t)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real = ds.diverse_select_cuda
    monkeypatch.setattr(ds, "diverse_select_cuda", lambda *a, **kw: a)
    fake = ds.diverse_select_cuda
    with ss.timed_selections() as sel:
        assert ds.diverse_select_cuda(1, 2) == (1, 2)
        ds.diverse_select_cuda(3)
    assert sel == {"calls": 2, "ms": 2.0}
    assert ds.diverse_select_cuda is fake and fake is not real
