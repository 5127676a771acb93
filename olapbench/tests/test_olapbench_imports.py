"""Nothing the benchmark runs loads JAX, the JAX package or the old
benchmarks, compared by whole top-level names (``repro_torch`` begins with
``repro``); the reference loads nothing of the program."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CODE = """
import sys, time
sys.path[:0] = [{src!r}, {root!r}]
sys.path[:] = [p for p in sys.path if not p.endswith("tests")]
{body}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "repro", "benchmarks",
                      "repro_torch"}}))
"""


def _loaded(body):
    p = subprocess.run([sys.executable, "-c", CODE.format(
        src=str(ROOT / "src"), root=str(ROOT), body=body)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_nor_the_jax_package():
    body = """
from olapbench import harness
_, config, _, _ = harness.cell_parts("tpch-sf10-wide-p1.join")
config = dict(config, generator_sf=1.0, lineitem_rows_per_partition=600)
harness.run_cell("tpch-sf10-wide-p1.join", 5, 0.2, True,
                 time.perf_counter(), device="cpu", config_override=config)
assert harness.forbidden_modules() == []
"""
    assert _loaded(body) == "['repro_torch']"


def test_the_reference_loads_nothing_of_the_program():
    body = """
import numpy as np
from olapbench import compare, control, gen, refops
from olapbench.queries import Q1
T = gen.to_host(gen.generate_tables(0.5, 1))
Q1.reference(refops.RefTables(T, "cpu"))
control.readings(T, {"order": ["Q1", "Q6"]})
"""
    assert _loaded(body) == "[]"


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    from olapbench import harness
    for name in [m for m in sys.modules if m.split(".")[0] == "repro"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_lookalike", sys)
    monkeypatch.setitem(sys.modules, "repro_torch.core", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()
