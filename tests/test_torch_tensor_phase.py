"""``chip_smoke.py``'s tensor phase rehearsed on the CPU.

The engine phase runs first, as on the card, for its interpreter results;
then the tensor phase on the same catalog (sf=10 over 4 nodes, the card
run's 100 lineitem partitions of 6,000 rows): each query observed, timed
on its eager merged tables and run warm in the four configs against the
interpreter, then the narrow pass over the catalog stored at TPC-H's
narrowest widths (under ``test_torch_dtypes.NoWideKernels``, which
refuses the uint16/32/64 calls torch's CUDA build lacks), the calibrated
crossover, ``residual="auto"`` and the stream with the tensor backend,
all through the plain versions (no kernel launches on the CPU).
"""
import importlib.util
import sys
from pathlib import Path

from repro_torch.compiler import tensorize

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dtypes import NoWideKernels  # noqa: E402


def test_chip_smoke_tensor_phase_runs_on_the_cpu(capsys, monkeypatch):
    from repro_torch.queryproc import tpch
    monkeypatch.setattr(tensorize, "_AUTO_THRESHOLD", {})
    monkeypatch.delenv("REPRO_RESIDUAL_THRESHOLD", raising=False)
    monkeypatch.delenv("REPRO_NO_CALIBRATE", raising=False)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cat = tpch.build_catalog(sf=10, num_nodes=4, rows_per_partition=6000,
                             device="cpu")
    interp = {}
    zero = dict.fromkeys(smoke.REPLACES, 0)
    assert smoke.engine_phase(cat, lambda: None, interp) == zero
    assert len(interp) == 15 * len(smoke.CONFIGS)
    from repro_torch.compiler import QUERY_IDS
    from repro_torch.core.engine import EngineConfig, compile_and_run
    ncat = smoke.narrow_catalog(cat)
    with NoWideKernels():
        kept = {"catalog": ncat, "interp": {
            q: compile_and_run(q, ncat, EngineConfig(
                mode="eager", device="cpu")).result for q in QUERY_IDS}}
    real = smoke.narrow_tensor_pass

    def guarded(*args, **kwargs):
        with NoWideKernels():
            return real(*args, **kwargs)
    monkeypatch.setattr(smoke, "narrow_tensor_pass", guarded)
    assert smoke.tensor_phase(cat, lambda: None, interp, kept,
                              repeats=1) == zero
    out = capsys.readouterr().out
    narrow = [ln for ln in out.splitlines()
              if ln.startswith("tensor narrow: Q")]
    assert len(narrow) == 15 and all(
        "(the wide catalog's)" in ln and "wide tensor=" in ln
        for ln in narrow)
    assert "'l_orderkey': 'uint32'" in next(
        ln for ln in narrow if ln.startswith("tensor narrow: Q18 "))
    assert "tensor narrow: 15 queries warm" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("tensor: Q")]
    assert sum("merged_rows=" in ln for ln in lines) == 15
    assert "stages=2" in next(ln for ln in lines if ln.startswith(
        "tensor: Q15 merged"))
    assert "aggregates=['lex']" in next(ln for ln in lines if ln.startswith(
        "tensor: Q3 merged"))
    assert "calibrate_residual_threshold() = " in out
    assert "stream of 16 adaptive 1.0 residual=tensor" in out
