"""The port's public surface: every public name of hnsw_tpu is exported by
hnsw_tpu_torch (hnsw_tpu has no ``__all__``: its names come from
``dir``), the streaming tier imports from its module path, every module
of hnsw_tpu has a counterpart path in the port (or a stated reason why
not), and neither the package nor its modules import JAX or the JAX
package (checked in a fresh interpreter through ``sys.modules``).
"""

import json
import pathlib
import subprocess
import sys
import types

import pytest

pytest.importorskip("torch")

import hnsw_tpu  # noqa: E402
import hnsw_tpu_torch  # noqa: E402

#: modules whose import the fresh-interpreter check covers
MODULES = ["hnsw_tpu_torch", "hnsw_tpu_torch.analyzer",
           "hnsw_tpu_torch.facets", "hnsw_tpu_torch.meta",
           "hnsw_tpu_torch.index.streaming", "hnsw_tpu_torch.io.appender",
           "hnsw_tpu_torch.io.disk_graph", "hnsw_tpu_torch.io.mmap_store",
           "hnsw_tpu_torch.io.wal", "hnsw_tpu_torch.parallel",
           "hnsw_tpu_torch.parallel.sharded",
           "hnsw_tpu_torch.parallel.rowsharded",
           "hnsw_tpu_torch.parallel.partitioned",
           "hnsw_tpu_torch.parallel.multihost",
           "hnsw_tpu_torch.parallel.rpc", "hnsw_tpu_torch.parallel.dryrun",
           "hnsw_tpu_torch.utils.roofline", "hnsw_tpu_torch.utils.profiling",
           "hnsw_tpu_torch.ops.beam_search", "hnsw_tpu_torch.core.search",
           "hnsw_tpu_torch.tools.bench", "hnsw_tpu_torch.tools.sweep",
           "hnsw_tpu_torch.tools.datasets", "hnsw_tpu_torch.tools.entry",
           "hnsw_tpu_torch.examples.quickstart",
           "hnsw_tpu_torch.examples.hybrid_and_facets",
           "hnsw_tpu_torch.examples.disk_and_scale",
           "hnsw_tpu_torch.examples.serving_ops",
           "hnsw_tpu_torch.examples.multichip",
           "hnsw_tpu_torch.examples.large_scale"]

#: modules of hnsw_tpu whose path the port does not repeat, with the
#: port's files that do their job: K1's Pallas kernel became a launcher
#: and a CUDA source; the TPU relay's transfer and warm-up plumbing has
#: no relay to serve on a card, and core/state.upload (pinned staging)
#: moves the tables instead
NO_SAME_PATH = {
    "ops/pallas_exact.py": ("ops/exact_screen.py", "csrc/exact_screen.cu"),
    "utils/transfer.py": ("core/state.py",),
    "utils/warmup.py": ("core/state.py",),
}


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and not isinstance(getattr(mod, n), types.ModuleType))


def test_every_public_name_of_hnsw_tpu_is_exported():
    names = _public(hnsw_tpu)
    assert len(names) >= 42
    assert sorted(set(names) - set(hnsw_tpu_torch.__all__)) == []
    for n in hnsw_tpu_torch.__all__:
        assert hasattr(hnsw_tpu_torch, n), n


@pytest.mark.parametrize("name", _public(hnsw_tpu))
def test_exported_name_is_the_ports_own(name):
    """The same kind of object under the same name, defined in the port."""
    j, t = getattr(hnsw_tpu, name), getattr(hnsw_tpu_torch, name)
    assert type(j) is type(t) or (isinstance(j, type) and isinstance(t, type))
    mod = getattr(t, "__module__", "hnsw_tpu_torch") or ""
    assert mod.startswith("hnsw_tpu_torch"), (name, mod)


def test_streaming_tier_by_its_module_path():
    from hnsw_tpu_torch.index.streaming import StreamingExactIndex
    assert "StreamingExactIndex" not in hnsw_tpu_torch.__all__
    assert not hasattr(hnsw_tpu, "StreamingExactIndex")
    assert StreamingExactIndex.__module__ == "hnsw_tpu_torch.index.streaming"


def test_new_modules_import_no_jax():
    code = ("import importlib, json, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'hnsw_tpu.')) "
            "or m == 'hnsw_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_every_module_of_hnsw_tpu_has_a_counterpart():
    jroot = pathlib.Path(hnsw_tpu.__file__).parent
    troot = pathlib.Path(hnsw_tpu_torch.__file__).parent
    mods = sorted(p.relative_to(jroot).as_posix() for p in jroot.rglob("*.py"))
    assert len(mods) >= 40 and set(NO_SAME_PATH) <= set(mods)
    for rel in mods:
        if rel in NO_SAME_PATH:
            assert not (troot / rel).exists(), rel
            assert all((troot / f).is_file() for f in NO_SAME_PATH[rel]), rel
        else:
            assert (troot / rel).is_file(), rel
    from hnsw_tpu_torch.core.state import upload
    assert callable(upload)
