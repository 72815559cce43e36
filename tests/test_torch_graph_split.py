"""tools/graph_split: where a launch of K5, the whole-search kernel, goes.

The report's arithmetic (each group's and phase's cycles in the slowest
and the mean block, hops and cycles a hop, rows a query), the request
rate, the reuse probe's batch, the groups and phases in the kernel's
order, each group's row bytes, the captured searches of the cases on a
small CPU graph, the arguments, and that the tool raises without a CUDA
card having built nothing; the --rows graph taken from the benchmark's
set-up, and the residency probe's pad, build and launches. No test here
needs CUDA.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu_torch.ops import beam_search as bs  # noqa: E402
from hnsw_tpu_torch.ops import graph_search as gs  # noqa: E402
from hnsw_tpu_torch.tools import graph_split as gsp  # noqa: E402


def _clocks():
    """[3 blocks, 4 groups, 8 phases + rows]: block 1 is the slowest."""
    c = np.zeros((3, len(gsp.GROUPS), len(gsp.PHASES) + 1), dtype=np.int64)
    c[0, 1, 4], c[0, 2, 4] = 100, 100
    c[1, 0, 4] = 10                      # entries: score
    c[1, 1, :8] = [20, 20, 5, 5, 40, 5, 5, 0]       # upper layers: 100
    c[1, 2, :8] = [30, 30, 0, 10, 200, 20, 10, 0]   # layer 0: 300
    c[1, 3, 4], c[1, 3, 5] = 60, 30      # rerank: score, rank
    c[:, 0, 8] = 1                       # rows scored
    c[:, 1, 8] = [40, 50, 60]
    c[:, 2, 8] = [100, 200, 300]
    c[:, 3, 8] = 20
    return c


def test_group_report_splits_the_slowest_block():
    hops = np.array([[2, 3, 1], [4, 5, 0], [10, 20, 30]])   # 2 uppers, l0
    rep = gsp.group_report(_clocks(), hops, n_up=2, clock_khz=2_000_000)
    assert rep["slowest_block"] == 1 and rep["slowest_cycles"] == 500
    assert rep["mean_cycles"] == pytest.approx((200 + 500 + 0) / 3)
    up, l0 = rep["groups"]["upper layers"], rep["groups"]["layer 0"]
    assert up["cycles"] == 100 and up["share"] == pytest.approx(0.2)
    assert up["hops"] == 8 and up["cycles_per_hop"] == pytest.approx(12.5)
    assert l0["hops"] == 20 and l0["cycles_per_hop"] == pytest.approx(15.0)
    assert l0["slowest"]["score"] == 200 and l0["slowest"]["set-up"] == 0
    assert l0["mean"]["score"] == pytest.approx(100.0)
    assert rep["groups"]["entries"]["hops"] is None
    assert rep["groups"]["rerank"]["slowest"]["rank"] == 30
    assert sum(g["share"] for g in rep["groups"].values()) == \
        pytest.approx(1.0)
    assert l0["rows_per_query"] == pytest.approx(200.0)
    assert l0["rows"] == 600 and up["rows"] == 150
    assert rep["slowest_us"] == pytest.approx(0.25)    # 500 cycles, 2 GHz
    lines = gsp.format_report("default ef=64", rep)
    assert lines[0].startswith("  default ef=64: slowest block 1 500 cycles")
    assert any("layer 0: 0.600 of the slowest block (300 cycles; 20 hops, "
               "15 cycles a hop)" in ln for ln in lines)


def test_group_report_without_a_clock_or_upper_layers():
    c = _clocks()
    rep = gsp.group_report(c, np.array([[7, 8, 9]]), n_up=0)
    assert "slowest_us" not in rep
    assert rep["groups"]["upper layers"]["hops"] == 0
    assert rep["groups"]["upper layers"]["cycles_per_hop"] is None
    assert rep["groups"]["layer 0"]["hops"] == 8


def test_request_rate_counts_every_scored_row():
    rows = {"entries": 1024, "upper layers": 10_000, "layer 0": 50_000,
            "rerank": 0}
    nbytes = {"entries": 516, "upper layers": 516, "layer 0": 128,
              "rerank": 516}
    r = gsp.request_rate(rows, nbytes, launch_ms=2.0)
    want = 1024 * 516 + 10_000 * 516 + 50_000 * 128
    assert r["bytes"] == want
    assert r["bytes_s"] == pytest.approx(want / 2e-3)
    assert r["share_of_hbm"] == pytest.approx(want / 2e-3 / 3.35e12)
    assert gsp.request_rate(rows, nbytes, 0.0)["bytes_s"] == 0.0


def test_reuse_queries_repeat_eight_distinct_ones():
    q = np.arange(1024 * 4, dtype=np.float32).reshape(1024, 4)
    r = gsp.reuse_queries(q)
    assert r.shape == q.shape and r.flags["C_CONTIGUOUS"]
    assert len(np.unique(r, axis=0)) == gsp.N_DISTINCT == 8
    np.testing.assert_array_equal(r[8:16], q[:8])
    np.testing.assert_array_equal(r[1023], q[7])


def test_groups_and_phases_follow_the_kernel():
    """GROUPS names csrc/beam_search.cu's G_* in order, PHASES its PH_*,
    and the clocked build's macro is in the source."""
    with open(bs.SOURCE) as f:
        src = f.read()
    groups = re.search(r"enum \{ (G_ENTRY = 0,[^}]*)\}", src).group(1)
    names = [n.split("=")[0].strip() for n in groups.split(",") if n.strip()]
    assert names == ["G_ENTRY", "G_UPPER", "G_LAYER0", "G_RERANK", "N_GROUP"]
    assert len(gsp.GROUPS) == len(names) - 1
    phases = re.search(r"enum \{ (PH_SELECT = 0,[^}]*)\}", src).group(1)
    assert len([n for n in phases.split(",") if n.strip()]) - 1 == len(
        gsp.PHASES)
    assert gsp.PHASES[2] == "set-up" and gsp.PHASES[4] == "score"
    assert f"#ifdef {gsp.CLOCKS}" in src
    assert "graph_search_set_clocks" in src
    assert "graph_search_clock_cols" in src


def _small_graph(**attrs):
    r = np.random.default_rng(3)
    base = r.standard_normal((1200, 32)).astype(np.float32)
    g = hnsw_tpu_torch.Graph(m=8, ef_construction=48, metric="cosine",
                             seed=0, device="cpu")
    g.native_serve_max_batch = 0
    g.build(list(range(len(base))), base, method="host")
    for k, v in attrs.items():
        setattr(g, k, v)
    return g, r.standard_normal((16, 32)).astype(np.float32)


def test_capture_cases_on_a_cpu_graph():
    """Each case's search_graph call is captured from
    Graph.batch_search_slots, and the serving attributes come back."""
    g, q = _small_graph()
    before = (g.fast_math, g.block_layout, g.entry_mode, g.block_dtype)
    cases = gsp.capture_cases(g, q)
    assert list(cases) == list(gsp.CASES)
    assert (g.fast_math, g.block_layout, g.entry_mode,
            g.block_dtype) == before
    for label, c in cases.items():
        ef = int(label.split("ef=")[1])
        assert c["kw"]["ef"] == ef and "stats" not in c["kw"]
        assert len(c["q"]) == len(q)
        bench = label.startswith("bench")
        assert c["kw"]["fast_math"] is bench
        assert (c["kw"]["seed_ids"] is not None) is bench
        assert (c["g"].nbr_blocks is not None) is bench
    plan, _ = gs._plan(cases["bench ef=192"]["g"], "cosine", 192, 8, 1,
                       "bitonic", 16)
    assert plan["mode0"] == "blocks"


def test_row_bytes_by_group():
    g, q = _small_graph()
    c = gsp.capture_cases(g, q, labels=("default ef=64",))["default ef=64"]
    dg = c["g"]
    plan, _ = gs._plan(dg, "cosine", 64, 8, 1, "bitonic", None)
    rb = gsp.row_bytes(dg, plan, 4)
    assert rb == {"entries": 4 * 32 + 4, "upper layers": 4 * 32 + 4,
                  "layer 0": 4 * 32 + 4, "rerank": 4 * 32 + 4}
    plan = dict(plan, mode0="qrows", mode_up="qrows")
    assert gsp.row_bytes(dg, plan, 2)["layer 0"] == 32 + 8
    assert gsp.row_bytes(dg, plan, 2)["rerank"] == 2 * 32 + 4


def test_main_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "split"
    with pytest.raises(RuntimeError, match="CUDA"):
        gsp.main(["--out", str(out), "--parent", str(tmp_path)])
    assert not os.path.exists(out)                 # nothing was built


def test_build_all_builds_the_clocked_variant_only_where_it_exists(
        monkeypatch, tmp_path):
    """Each source as shipped, and with GRAPH_PHASE_CLOCKS where it has
    the counters (a parent from before them gives times alone)."""
    old = tmp_path / "old.cu"
    old.write_text("// a source without the counters\n")
    built = []

    def fake(defines, build_dir, source):
        built.append((tuple(defines), os.path.basename(build_dir),
                      os.path.basename(source)))
        return os.path.join(build_dir, "libbeam_search.so")

    monkeypatch.setattr(bs, "build", fake)
    paths = gsp.build_all(str(tmp_path), {"change": bs.SOURCE,
                                          "parent": str(old)})
    assert sorted(paths) == ["change", "change_clocks", "parent"]
    assert sorted(built) == [
        ((), "change", "beam_search.cu"), ((), "parent", "old.cu"),
        (("GRAPH_PHASE_CLOCKS",), "change_clocks", "beam_search.cu")]


def test_rescore_share_counts_a_hops_copies_once():
    """Two queries of two layers (an upper one, then layer 0); a hop's
    copies of a row count once, rows scored again in a later hop of the
    layer count again."""
    per_query = [
        [[np.array([1, 2, 2])], [np.array([5, 6, 6]), np.array([6, 7])]],
        [[np.array([3])], [np.array([8]), np.array([8, 9]),
                           np.array([9, 8])]]]
    r = gsp.rescore_share(per_query)
    # layer 0: query 1 scores 2 + 2 rows (3 distinct), query 2 1 + 2 + 2
    # (2 distinct)
    assert r["layer0_rows"] == pytest.approx(4.5)
    assert r["layer0_distinct"] == pytest.approx(2.5)
    assert r["layer0_rescored"] == pytest.approx(1 - 5 / 9)
    assert r["upper_rows"] == pytest.approx(1.5)
    assert r["upper_distinct"] == pytest.approx(1.5)
    assert gsp.rescore_share([])["layer0_rescored"] == 1.0


def test_measure_rescore_on_a_cpu_graph():
    g, q = _small_graph()
    c = gsp.capture_cases(g, q, labels=("default ef=64",))["default ef=64"]
    r = gsp.measure_rescore(c, n=4)
    assert r["layer0_rows"] > 0 and 0.0 <= r["layer0_rescored"] < 1.0
    assert r["layer0_distinct"] <= r["layer0_rows"]


def test_same_outputs_compares_bits():
    """Distances are compared as bits (-0.0 and 0.0 differ, a NaN equals
    itself), ids and hop counts as values; an array one run lacks is left
    out."""
    a = {"x dists": np.array([0.0, 1.5, np.nan], np.float32),
         "x ids": np.array([[1, 2]], np.int32),
         "x hops": np.array([[3, 4]], np.int32), "only a": np.zeros(2)}
    b = {"x dists": np.array([0.0, 1.5, np.nan], np.float32),
         "x ids": np.array([[1, 2]], np.int32),
         "x hops": np.array([[3, 5]], np.int32)}
    assert gsp.same_outputs(a, b) == {"x dists": True, "x hops": False,
                                      "x ids": True}
    b["x dists"] = np.array([-0.0, 1.5, np.nan], np.float32)
    assert gsp.same_outputs(a, b)["x dists"] is False
    b["x ids"] = np.array([1, 2], np.int32)
    assert gsp.same_outputs(a, b)["x ids"] is False


def test_rows_graph_is_the_benchmark_cells_build_at_n_rows(monkeypatch):
    """--rows serves ROWS_CELL's graph as the benchmark's own set-up draws
    and builds it, with only the row count changed."""
    import types

    from portbench import cells, run
    seen = []

    def set_up(cell, seed, dev):
        seen.append((cell, seed, dev))
        return types.SimpleNamespace(graph="graph", pool="pool", rows="rows")

    monkeypatch.setattr(run, "set_up", set_up)
    assert gsp.rows_graph(3000) == ("graph", "pool", "rows")
    ((cell, seed, dev),) = seen
    real = cells.load(gsp.ROWS_CELL)
    assert cell.config == dict(real.config, rows=3000)
    assert cell.traffic == real.traffic and cell.name == real.name
    assert seed == 1 and dev == torch.device("cuda")


@pytest.mark.parametrize("blocks", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("smem", [7_224, 10_296, 17_464])
def test_resident_pad_leaves_just_that_many_blocks(smem, blocks):
    """The padded block fits ``blocks`` times in an SM's 228 KB and not
    once more (the occupancy API's count by shared memory: a block's
    dynamic and static bytes and its 1 KB reserve, in 128-byte units)."""
    pad = gsp.resident_pad(smem, blocks)
    unit = -(-(smem + pad + gsp.STATIC_SMEM + gsp.BLOCK_RESERVED_SMEM)
             // gsp.SMEM_UNIT) * gsp.SMEM_UNIT
    assert gsp.SM_SMEM // unit == blocks
    assert smem + pad <= bs.SMEM_LIMIT


def test_the_pad_lives_only_in_the_probes_build():
    """The shipped launch takes no pad: only a build with
    GRAPH_RESIDENCY_PAD has the setter, and adds its bytes to K5's."""
    with open(bs.SOURCE) as f:
        src = f.read()
    launch = src[src.index("int graph_search_launch("):]
    launch = launch[:launch.index("\n}\n")]
    assert "pad" not in launch[:launch.index(") {")]
    assert re.findall(r"#ifdef GRAPH_RESIDENCY_PAD\n\s*smem \+= g_pad;",
                      launch)
    for name in ("int g_pad", "void graph_search_set_pad("):
        at = src.index(name)
        assert src.rindex("#ifdef GRAPH_RESIDENCY_PAD", 0, at) > max(
            src.rfind("#endif", 0, at), src.rfind("#else", 0, at))
    assert gsp.PAD == "GRAPH_RESIDENCY_PAD"


def test_build_all_builds_the_padded_variant_only_when_asked(
        monkeypatch, tmp_path):
    """With pad, each source that has GRAPH_RESIDENCY_PAD is built with it
    too; a source without it, or a run without the probe, is not."""
    old = tmp_path / "old.cu"
    old.write_text("// GRAPH_PHASE_CLOCKS only\n")
    built = []

    def fake(defines, build_dir, source):
        built.append((tuple(defines), os.path.basename(build_dir)))
        return os.path.join(build_dir, "libbeam_search.so")

    monkeypatch.setattr(bs, "build", fake)
    sources = {"change": bs.SOURCE, "parent": str(old)}
    assert sorted(gsp.build_all(str(tmp_path), sources, pad=True)) == [
        "change", "change_clocks", "change_pad", "parent", "parent_clocks"]
    assert (("GRAPH_RESIDENCY_PAD",), "change_pad") in built
    built.clear()
    assert "change_pad" not in gsp.build_all(str(tmp_path), sources)
    assert all(d != ("GRAPH_RESIDENCY_PAD",) for d, _ in built)


def test_resident_probe_pads_each_launch_then_restores(monkeypatch):
    """Each count of blocks runs its launches through the padded build,
    with that count's pad set; then the pad is 0 and the library the
    shipped one again."""
    events = []

    class Padded:
        def graph_search_set_pad(self, n):
            events.append(("pad", n))

        def graph_search_blocks_per_sm(self, s0, su, vec, smem):
            return smem                # the bytes the probe asked about

    plib, shipped = Padded(), bs._lib
    c = {"q": np.zeros((8, 4), np.float32)}
    monkeypatch.setattr(gsp, "_plan", lambda c: {"smem": 10_296})

    def times(c, reps):
        assert bs._lib is plib
        events.append(("time", reps))
        return {"launch_ms": 0.5}

    monkeypatch.setattr(gsp, "_times", times)
    out = gsp.resident_probe(plib, c, 0, 0, (2, 8), reps=3)
    assert bs._lib is shipped
    pads = [gsp.resident_pad(10_296, n) for n in (2, 8)]
    assert events == [("pad", pads[0]), ("time", 3), ("pad", pads[1]),
                      ("time", 3), ("pad", 0)]
    assert [(r["blocks"], r["pad"], r["api_blocks"]) for r in out] == [
        (n, p, 10_296 + p) for n, p in zip((2, 8), pads)]
    assert out[0]["us_per_query"] == pytest.approx(0.5e3 / 8)


def test_fp16_case_serves_fp16_rows():
    """A case of mode fp16 searches fp16 rows (hbm_mode "float16") and
    leaves the graph's store as it was."""
    g, q = _small_graph()
    c = gsp.capture_cases(g, q, labels=("fp16 ef=64",))["fp16 ef=64"]
    assert c["g"].vectors.dtype == torch.float16 and c["kw"]["ef"] == 64
    assert g.hbm_mode == "full"
    plan, _ = gs._plan(c["g"], "cosine", 64, 8, 1, "bitonic", None)
    assert plan["mode0"] == plan["mode_up"] == "f16rows"


def test_rows_graph_serves_another_cell_at_its_own_rows(monkeypatch):
    """--cell: the named cell's configuration, at its own row count
    unless --rows gives one."""
    import types

    from portbench import cells, run
    seen = []

    def set_up(cell, seed, dev):
        seen.append(cell)
        return types.SimpleNamespace(graph="graph", pool="pool", rows="rows")

    monkeypatch.setattr(run, "set_up", set_up)
    name = "dbpedia1536-cos.b8192.ef64"
    real = cells.load(name)
    assert gsp.rows_graph(0, cell=name) == ("graph", "pool", "rows")
    assert gsp.rows_graph(5000, cell=name) == ("graph", "pool", "rows")
    assert seen[0].config == real.config and seen[0].name == name
    assert seen[1].config == dict(real.config, rows=5000)
    assert real.config["dim"] == 1536
