"""The contract's last line, and the refusals of ``run.py``."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import smallcell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_line_has_the_contract_keys(cell, trace):
    line = smallcell.run(cell, trace=trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    group = BENCH["per_layer"] if trace else BENCH["end_to_end"]
    want = {m["name"]: m["unit"] for m in group
            if cell in m.get("workloads", [cell])}
    # on the CPU the device readings read nothing and are left out
    device_only = {m["name"] for m in group if m["source"] == "device_trace"}
    assert set(line["metrics"]) == set(want) - device_only
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name]
        assert isinstance(m["value"], float) or isinstance(m["value"], int)
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "olapbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=env or dict(os.environ))


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run_py(ROOT, env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_alone_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "olapbench", tmp_path / "olapbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
