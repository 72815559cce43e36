"""tools/hop_split: where a hop of K2, the graph beam-search kernel, goes.

The report's arithmetic (each phase's share of the slowest block's
cycles, the µs a hop, the clocked block's own µs a hop) on synthetic
counters; ptxas's ``-v`` report parsed per instantiation; the phase names
in the kernel's order; the captured layer-0 calls of the smoke's cases on
a small CPU graph; and that the tool raises without a CUDA card.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu_torch.core.state import DeviceGraph  # noqa: E402
from hnsw_tpu_torch.ops import beam_search as bs  # noqa: E402
from hnsw_tpu_torch.tools import hop_split as hs  # noqa: E402

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118beam_search_kernelILi0ELb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118beam_search_kernelILi0ELb1EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118beam_search_kernelILi3ELb0EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118beam_search_kernelILi3ELb0EEEvNS_6ParamsE
    8 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118beam_search_kernelILi4ELb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118beam_search_kernelILi4ELb1EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers, used 1 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118beam_search_kernelILi6ELb0EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118beam_search_kernelILi6ELb0EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 1 barriers, 576 bytes cmem[0]
ptxas info    : Compiling entry function '_Z11other_kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z11other_kernelv
    0 bytes stack frame, 40 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 12 registers, 352 bytes cmem[0]
"""


def test_parse_ptxas_reads_each_instantiation():
    regs = hs.parse_ptxas(PTXAS)
    assert regs == {
        "f32/vec": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                    "registers": 64},
        "fp16/scalar": {"stack": 8, "spill_stores": 12, "spill_loads": 8,
                        "registers": 64},
        "qrows/vec": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                      "registers": 62},
        "bf16rows/scalar": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                            "registers": 60}}


K5_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119graph_search_kernelILi2ELi1ELb1EEEvNS_11GraphParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119graph_search_kernelILi2ELi1ELb1EEEvNS_11GraphParamsE
    104 bytes stack frame, 104 bytes spill stores, 104 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 1400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119graph_search_kernelILi0ELi0ELb0EEEvNS_11GraphParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119graph_search_kernelILi0ELi0ELb0EEEvNS_11GraphParamsE
    80 bytes stack frame, 80 bytes spill stores, 80 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 1400 bytes cmem[0]
"""


def test_parse_ptxas_names_k5s_instantiations():
    """K5's instantiations by layer 0's mode, the upper layers' and the
    loads."""
    assert hs.parse_ptxas(K5_PTXAS) == {
        "K5 int8+bf16/vec": {"stack": 104, "spill_stores": 104,
                             "spill_loads": 104, "registers": 64},
        "K5 f32+f32/scalar": {"stack": 80, "spill_stores": 80,
                              "spill_loads": 80, "registers": 64}}


def test_score_names_follow_the_kernel_modes():
    """SCORE_NAMES names the kernel's S_* scoring modes by their codes."""
    with open(bs.SOURCE) as f:
        src = f.read()
    enum = re.search(r"enum \{ (S_F32 = 0,[^}]*)\}", src).group(1)
    codes = {n.split("=")[0].strip(): int(n.split("=")[1])
             for n in enum.split(",") if n.strip()}
    assert codes == {"S_F32": 0, "S_BF16": 1, "S_I8": 2, "S_F16": 3,
                     "S_Q8ROW": 4, "S_F16ROW": 5, "S_B16ROW": 6}
    assert sorted(hs.SCORE_NAMES) == sorted(codes.values())


def test_phase_report_splits_the_slowest_block():
    cycles = np.zeros((3, len(hs.PHASES)), dtype=np.int64)
    cycles[0] = [10, 20, 0, 5, 50, 10, 5, 0]      # 100 cycles
    cycles[1] = [40, 40, 0, 20, 200, 50, 40, 10]  # 400: the slowest
    cycles[2] = [1, 1, 0, 1, 1, 1, 1, 0]
    hops = np.array([5, 20, 1])
    rep = hs.phase_report(cycles, hops, kernel_ms=0.5, clock_khz=2_000_000)
    assert rep["slowest_block"] == 1 and rep["slowest_hops"] == 20
    assert rep["max_hops"] == 20
    assert rep["us_per_hop"] == pytest.approx(25.0)     # 500 us / 20
    assert sum(rep["shares"].values()) == pytest.approx(1.0)
    assert rep["shares"]["score"] == pytest.approx(0.5)
    assert rep["shares"]["same-hop dedup"] == 0.0
    assert rep["us_per_hop_by_phase"]["score"] == pytest.approx(12.5)
    assert sum(rep["us_per_hop_by_phase"].values()) == pytest.approx(25.0)
    # 400 cycles over 20 hops at 2 GHz
    assert rep["clocked_us_per_hop"] == pytest.approx(0.01)
    line = hs.format_report("rows ef=64", rep)
    assert "25.00 us a hop (20 hops)" in line and "score 0.500" in line
    assert "slowest block 1 (20 hops)" in line


def test_phase_report_without_a_clock_and_without_hops():
    rep = hs.phase_report(np.ones((2, len(hs.PHASES))), np.zeros(2), 1.0)
    assert "clocked_us_per_hop" not in rep
    assert rep["max_hops"] == 0 and rep["us_per_hop"] == pytest.approx(1e3)


def test_phases_follow_the_kernel_counters():
    """PHASES names the kernel's PH_* counters in their order."""
    with open(bs.SOURCE) as f:
        src = f.read()
    enum = re.search(r"enum \{ (PH_SELECT = 0,[^}]*)\}", src).group(1)
    names = [n.split("=")[0].strip() for n in enum.split(",") if n.strip()]
    assert names[-1] == "N_PHASE"
    assert [n[3:].lower() for n in names[:-1]] == [
        "select", "gather", "dedup", "list", "score", "rank", "merge",
        "compact"]
    assert len(hs.PHASES) == len(names) - 1
    assert "BEAM_PHASE_CLOCKS" in src and hs.CLOCKS == "BEAM_PHASE_CLOCKS"


def test_main_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        hs.main(["--out", str(tmp_path)])
    assert not os.listdir(tmp_path)               # nothing was built


def _meta_graph(blocks=None, store=torch.float32):
    """A graph on "meta" tensors: f32, fp16 or bf16 rows, or (``store``
    torch.int8) the int8 capacity mode's qvec rows and a [1, D]
    placeholder."""
    meta = torch.device("meta")
    quantized = store == torch.int8
    return DeviceGraph(
        vectors=torch.empty((1 if quantized else 4096, 128),
                            dtype=torch.float32 if quantized else store,
                            device=meta),
        sq_norms=torch.empty(4096, device=meta),
        neighbors=torch.empty((1, 4096, 32), dtype=torch.int32, device=meta),
        levels=torch.empty(4096, dtype=torch.int32, device=meta),
        alive=torch.empty(4096, dtype=torch.bool, device=meta),
        entry=torch.empty((), dtype=torch.int32, device=meta),
        qvec=(torch.empty((4096, 128), dtype=torch.int8, device=meta)
              if quantized else None),
        qscale=torch.empty(4096, device=meta) if quantized else None,
        nbr_blocks=(None if blocks is None else
                    torch.empty((4096, 32, 128), dtype=blocks, device=meta)))


@pytest.mark.parametrize("blocks,store,precision,merge,want", [
    (None, torch.float32, "highest", "bitonic", (0, 1)),
    (None, torch.float32, "default", "sort", (1, 1)),
    (torch.int8, torch.float32, "default", "bitonic", (2, 1)),
    (torch.float16, torch.float32, "default", "bitonic", (3, 1)),
    (None, torch.int8, "highest", "bitonic", (4, 1)),
    (None, torch.float16, "default", "bitonic", (5, 1)),
    (None, torch.bfloat16, "default", "sort", (6, 1)),
    (None, torch.bfloat16, "highest", "bitonic", (6, 1)),
    (torch.int8, torch.int8, "default", "bitonic", (2, 1))])
def test_instantiation_and_shared_memory_of_a_case(blocks, store, precision,
                                                   merge, want):
    """A case's kernel instantiation (scoring mode, vector loads) and its
    shared memory as the library computes it (a stand-in library here):
    every store, the capacity ones included."""
    g = _meta_graph(blocks, store)
    case = {"g": g, "args": (), "kw": dict(pool_size=192, max_hops=128,
                                           metric="cosine",
                                           precision=precision, expand=4,
                                           merge=merge, stats={})}
    assert "stats" not in hs.case_kwargs(case)
    assert hs.instantiation(case) == want

    class Lib:
        @staticmethod
        def beam_search_smem_bytes(D, P, E, M, sort):
            return bs.smem_bytes(D, P, E, M, "sort" if sort else "bitonic")

    assert hs.case_smem(Lib, case) == bs.smem_bytes(128, 192, 4, 32, merge)


def test_case_kwargs_fill_the_builders_defaults():
    case = {"kw": dict(pool_size=100, max_hops=128, metric="cosine",
                       precision="default")}
    assert hs.case_kwargs(case) == dict(
        pool_size=100, max_hops=128, metric="cosine", precision="default",
        expand=1, merge="sort", store_normalized=False)


def test_capture_cases_on_a_cpu_graph():
    """Each smoke case's layer-0 call is captured from its entry point,
    and the Graph's serving attributes are left as they were."""
    r = np.random.default_rng(5)
    base = r.standard_normal((1500, 32)).astype(np.float32)
    q = r.standard_normal((16, 32)).astype(np.float32)
    g = hnsw_tpu_torch.Graph(m=8, ef_construction=48, metric="cosine",
                             seed=0, device="cpu")
    g.native_serve_max_batch = 0
    g.build(list(range(len(base))), base, method="host")
    before = (g.fast_math, g.block_layout, g.entry_mode, g.block_dtype)
    cases = hs.capture_cases(g, q, base)
    assert list(cases) == list(hs.CASES)
    assert (g.fast_math, g.block_layout, g.entry_mode,
            g.block_dtype) == before
    want = {"rows ef=64": (64, "highest", None),
            "rows ef=192": (192, "highest", None),
            "int8 blocks ef=192 (bench mode)": (192, "default", torch.int8),
            "float16 blocks ef=192 (bench mode)": (192, "default",
                                                   torch.float16),
            "builder descent DEFAULT/sort ef=100": (100, "default", None),
            hs.CAPACITY_CASES[0]: (192, "highest", None),
            hs.CAPACITY_CASES[1]: (192, "default", None),
            hs.CAPACITY_CASES[2]: (64, "default", None)}
    modes = dict.fromkeys(want, "rows")
    modes.update({"int8 blocks ef=192 (bench mode)": "blocks",
                  "float16 blocks ef=192 (bench mode)": "blocks",
                  hs.CAPACITY_CASES[0]: "qrows",
                  hs.CAPACITY_CASES[1]: "f16rows",
                  hs.CAPACITY_CASES[2]: "bf16rows"})
    for label, case in cases.items():
        P, precision, blocks = want[label]
        kw = hs.case_kwargs(case)
        assert kw["pool_size"] == P and kw["precision"] == precision
        assert len(case["args"][0]) == len(q)
        got = case["g"].nbr_blocks
        assert (got is None if blocks is None else got.dtype == blocks)
        assert bs.layer_mode(case["g"], 0, kw["metric"], P,
                             max(1, min(kw["expand"], P)),
                             kw["merge"]) == modes[label]
    assert g.hbm_mode == "full" and g.cfg.store_dtype == "float32"
    assert g.device_graph().vectors.dtype == torch.float32
    assert hs.case_kwargs(cases["builder descent DEFAULT/sort ef=100"])[
        "merge"] == "sort"
