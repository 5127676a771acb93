"""The port's package rules.

- No file of ``src/repro_torch/``, ``chip_smoke.py`` or the port's examples
  imports ``jax`` or the JAX package ``repro``, and importing every module
  of the port leaves both out of ``sys.modules``.
- Entry points run on the GPU by default: without one they raise instead of
  running on the CPU, and a kernel wrapper given a tensor on a device other
  than the CPU launches its kernel or raises, never falls back.
- The process tier spawns its workers (``distributed/workers.py``); no
  file of the port forks.
- ``chip_smoke.py`` exits non-zero, printing no result, without a GPU and
  in a directory that holds nothing else of the repository.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "examples" / "serve_batch_torch.py",
     ROOT / "examples" / "train_pushdown_pipeline_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_rules_cover_the_cost_based_modules():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES if p.is_relative_to(ROOT / "src")}
    assert {"compiler/multitable.py", "compiler/compile.py",
            "core/optimum.py", "core/cost.py", "core/engine.py",
            "core/runtime.py", "core/simulator.py", "obs/metrics.py",
            "obs/trace.py", "core/result_cache.py",
            "core/faults.py", "obs/export.py", "core/arbitrator.py",
            "core/executor.py", "distributed/__init__.py",
            "distributed/workers.py", "compiler/tensorize.py",
            "data/__init__.py", "data/pipeline.py", "configs/__init__.py",
            "configs/base.py", "configs/olmo_1b.py", "models/__init__.py",
            "models/flags.py", "models/params.py", "models/layers.py",
            "models/attention.py", "models/moe.py", "models/transformer.py",
            "models/api.py", "serve/__init__.py", "serve/engine.py",
            "models/ssm.py", "models/rglru.py", "models/hybrid.py",
            "models/mamba_model.py", "models/whisper.py",
            "configs/mamba2_2_7b.py", "configs/recurrentgemma_2b.py",
            "configs/whisper_small.py", "train/__init__.py",
            "train/optimizer.py", "train/checkpoint.py",
            "train/loop.py"} <= names


def _start_methods(path: Path):
    """The start methods ``path`` asks ``multiprocessing`` for: the first
    argument of every ``get_context``/``set_start_method`` call."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "get_context", "set_start_method"):
            arg = node.args[0] if node.args else None
            yield arg.value if isinstance(arg, ast.Constant) else arg


def test_the_process_tier_spawns_its_workers():
    """A child forked after its parent initialized CUDA cannot use CUDA:
    the port's workers are spawned, and nothing in the port forks."""
    dist = sorted((ROOT / "src" / "repro_torch" / "distributed").rglob(
        "*.py"))
    assert [p.name for p in dist] == ["__init__.py", "workers.py"]
    assert list(_start_methods(dist[1])) == ["spawn"]
    for path in PORT_FILES:
        assert "fork" not in set(_start_methods(path)), path
        assert "os.fork" not in path.read_text(), path


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_without_a_gpu_the_entry_points_raise(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core.engine import EngineConfig, run_query
    from repro_torch.core.runtime import StreamQuery, run_stream
    from repro_torch.data.pipeline import (CorpusQuery, PushdownDataPipeline,
                                           synth_corpus)
    from repro_torch.device import resolve_device
    from repro_torch.models import api
    from repro_torch.queryproc import queries, tpch
    from repro_torch.storage.catalog import Catalog
    from repro_torch.train.loop import TrainConfig, train
    cat = tpch.build_catalog(sf=0.1, num_nodes=1, rows_per_partition=2000,
                             device="cpu")
    cfg = get_config("olmo-1b", reduced=True)
    tree = api.init_params(cfg, device="cpu").tree()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        Catalog(1)
    with pytest.raises(RuntimeError):
        tpch.build_catalog(sf=0.1)
    with pytest.raises(RuntimeError):
        run_query(queries.build_query("Q6"), cat, EngineConfig())
    with pytest.raises(RuntimeError):
        run_stream([StreamQuery(queries.build_query("Q6"))], cat,
                   EngineConfig())
    with pytest.raises(RuntimeError):
        PushdownDataPipeline(synth_corpus(1, 8, 4), CorpusQuery())
    with pytest.raises(RuntimeError):
        api.init_params(cfg)
    with pytest.raises(RuntimeError):
        api.from_reference(cfg, tree)
    with pytest.raises(RuntimeError):
        train(cfg, iter([]), TrainConfig(steps=1))
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_do_not_fall_back_to_the_plain_version():
    from repro_torch.kernels import bitmap_apply as ba
    from repro_torch.kernels import fused_scan_agg as fsa
    from repro_torch.kernels import fused_scan_shuffle as fss
    from repro_torch.kernels import grouped_agg as ga
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import ops as kops
    from repro_torch.queryproc.expressions import Col
    meta = torch.device("meta")
    ids = torch.zeros(64, dtype=torch.int32, device=meta)
    vals = torch.zeros(64, dtype=torch.float64, device=meta)
    with pytest.raises(ValueError):
        ga.grouped_agg(ids, vals, 4)
    with pytest.raises(ValueError):
        fsa.fused_scan_agg(None, (), ids, [vals], 4)
    with pytest.raises(ValueError):
        kops.predicate_bitmap({"a": ids}, Col("a") < 3)
    words = torch.zeros(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        ba.bitmap_apply(words, vals)
    with pytest.raises(ValueError):
        hp.hash_partition(ids, 4)
    with pytest.raises(ValueError):
        fss.fused_scan_shuffle(None, (), ids, 4)
    with pytest.raises(ValueError):
        kops.fused_scan_shuffle({"a": ids}, Col("a") < 3, ids, 4)
    # a CPU tensor of the wrong dtype or shape raises too
    with pytest.raises(TypeError):
        ga.grouped_agg(torch.zeros(4, dtype=torch.int64), None, 4)
    with pytest.raises(ValueError):
        ga.grouped_agg(torch.zeros(4, dtype=torch.int32),
                       torch.zeros(5, dtype=torch.float64), 4)
    with pytest.raises(ValueError):  # words for 64 rows, column of 65
        ba.bitmap_apply(torch.zeros(2, dtype=torch.int32),
                        torch.zeros(65, dtype=torch.float64))
    with pytest.raises(TypeError):
        hp.hash_partition(torch.zeros(4, dtype=torch.float32), 4)
    with pytest.raises(ValueError):
        hp.hash_partition(torch.zeros(4, dtype=torch.int32), 0)


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_env() if cwd == ROOT else None,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_phases_run_on_the_cpu():
    """The script's checks at a small size through the plain versions: sf=10
    with 6000-row partitions has the card run's 100 lineitem partitions over
    4 nodes, so the power-0.1 split check is exercised too, the costed
    phase runs every query's cost-based frontier, the corrector loop, the
    concurrent run and the oracle splits, the compiler phase runs Q18's
    HAVING on a second catalog clustered by l_orderkey, the §4.2 phase
    cuts every partition's words out of unaligned batch words, the cache
    phase runs every query cold, warm and by containment, and the fault
    phase every query under the chaos plan, the stream phase all 15 (and
    Q6 again) through ``run_stream`` in the four configs and under chaos
    with hedging, and the trace phase a traced stream exported."""
    import importlib.util
    import time
    from repro_torch.queryproc import tpch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def host_ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    cat = tpch.build_catalog(sf=10, num_nodes=4, rows_per_partition=6000,
                             device="cpu")
    records, extra = smoke.kernel_phase(cat, host_ms)
    assert set(records) == set(smoke.REPLACES) == set(smoke.SOURCES) == {
        "predicate_bitmap", "fused_scan_agg", "grouped_agg", "bitmap_apply",
        "hash_partition", "fused_scan_shuffle"}
    assert all(r["bound_by"] == "bytes" and r["bound_ms"] > 0
               and r["max_abs_err"] == 0
               for n, r in records.items() if n not in ("fused_scan_agg",
                                                        "grouped_agg"))
    assert all(r["bound_by"] == "bytes" and r["bound_ms"] > 0
               for r in [*records.values(), *extra])
    pooled = [r for r in extra if "pooled In" in r["shape"]]
    assert sorted(r["name"] for r in pooled) == [
        "fused_scan_agg", "fused_scan_shuffle", "predicate_bitmap"]
    # CPU tensors run the plain versions, which count no launch
    zero = dict.fromkeys(records, 0)
    assert smoke.engine_phase(cat, lambda: None) == zero
    assert smoke.costed_phase(cat, lambda: None) == zero
    ccat = tpch.build_catalog(sf=10, num_nodes=4, rows_per_partition=6000,
                              device="cpu", cluster=smoke.CLUSTER)
    launches, having = smoke.compiler_phase(cat, ccat, host_ms, lambda: None)
    assert launches == zero
    assert having["name"] == "predicate_bitmap"
    assert having["bound_by"] == "bytes" and having["bound_ms"] > 0
    assert smoke.section42_phase(cat, lambda: None) == zero
    assert smoke.cache_phase(cat, lambda: None) == zero
    assert smoke.fault_phase(cat, lambda: None) == zero
    assert smoke.stream_phase(cat, lambda: None) == zero
    assert smoke.trace_phase(cat, lambda: None, repeats=1) == zero


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
