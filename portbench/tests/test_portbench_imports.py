"""No run loads JAX or the JAX package; the reference alone loads nothing
of the program."""

import json
import subprocess
import sys

from portbench import cells, run

PROBE = ("import sys, json; {body}; "
         "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")


def _top_level(body):
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)],
                         cwd=cells.ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_alone_loads_nothing_of_the_program():
    names = _top_level("import portbench.reference, portbench.datagen, "
                       "portbench.roofline, portbench.stats")
    assert not names & {"hnsw_tpu_torch", "hnsw_tpu", "jax", "jaxlib",
                        "flax"}


def test_a_run_loads_no_jax(tmp_path):
    from .conftest import make_root
    root = make_root(tmp_path, "tiny.easy")
    body = (f"from portbench import run; run.run('tiny.easy', 5, 0.2, "
            f"False, root={root!r}, device='cpu', require_card=False)")
    names = _top_level(body)
    assert "hnsw_tpu_torch" in names
    assert not names & set(run.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hnsw_tpu_torch_x", sys)
    assert "hnsw_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_without_a_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "sift1m-l2.b8192.ef64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True,
        timeout=300)
    if "torch.cuda.is_available()=True" in out.stderr:
        return                      # a card is there: nothing to show
    assert out.returncode != 0
    assert out.stdout.strip() == ""
