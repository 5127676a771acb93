"""``chip_smoke.py``'s process-tier phase rehearsed on the CPU.

The phase runs on a 4-node catalog (the card's node count, 100 lineitem
partitions of 1,200 rows) with its workers spawned on the CPU, so every
check of the phase runs through the plain versions: all 15 queries in
three configs on the pool against in-process runs, the seed-7 random
decision vectors, the shuffle plans, the stream on the tier, the kill
mid-stream and its reconciliation, the fail-to-error baseline and the
traced split. No kernel launches on the CPU.
"""
import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_chip_smoke_tier_phase_runs_on_the_cpu(capsys):
    from repro_torch.queryproc import tpch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cat = tpch.build_catalog(sf=2, num_nodes=4, rows_per_partition=1200,
                             device="cpu")
    launches = smoke.tier_phase(cat, lambda: None)
    assert launches == dict.fromkeys(smoke.REPLACES, 0)
    out = capsys.readouterr().out
    assert out.count("agree=bitwise") == 3 * 15
    for line in ("first pool of 4 workers", "second pool",
                 "node 0 killed", "raised: storage crash on node 0",
                 "traced Q6 split", "after the pools closed"):
        assert line in out, line
