"""``chip_smoke.py``'s narrow phase rehearsed on the CPU.

The phase re-stores the TPC-H catalog at its narrowest widths (uint8
codes, int16 dates, a uint16 quantity, uint32 keys), runs every query
eager and adaptive against the wide catalog, the §4.2 paths over the
narrow partitions and each kernel on narrow columns. Here it runs at
sf=1 through the plain versions (CPU tensors count no launch, so the
phase's check that every kernel launched is the card's alone), under
``test_torch_dtypes.NoWideKernels``, which refuses the uint16/32/64
calls torch's CUDA build lacks.
"""
import importlib.util
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.queryproc import tpch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dtypes import NoWideKernels  # noqa: E402


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def test_narrow_catalog_keeps_partitions_and_narrows_every_int(smoke):
    cat = tpch.build_catalog(sf=0.2, num_nodes=3, rows_per_partition=2000,
                             device="cpu")
    ncat = smoke.narrow_catalog(cat)
    for name, parts in cat.tables.items():
        nparts = ncat.partitions_of(name)
        assert [(p.node_id, len(p.data)) for p in parts] == \
            [(p.node_id, len(p.data)) for p in nparts]
        for p, n in zip(parts, nparts):
            for c, v in p.data.cols.items():
                w = n.data.cols[c]
                assert w.dtype == (torch.float64 if v.dtype == torch.float64
                                   else smoke.narrow_dtype(c, v.dtype))
                assert torch.equal(v, w if w.dtype == torch.float64 else
                                   w.to(torch.int64).to(v.dtype))
    got = {str(v.dtype)[6:] for parts in ncat.tables.values()
           for v in parts[0].data.cols.values()}
    assert got == {"uint8", "int16", "uint16", "uint32", "float64"}


def test_narrow_phase_runs_on_the_cpu(smoke, monkeypatch):
    cat = tpch.build_catalog(sf=1, num_nodes=4, rows_per_partition=6000,
                             device="cpu")
    records, _ = smoke.kernel_phase(cat, host_ms)
    # launches: the card's; on the CPU every driven run counts none
    monkeypatch.setattr(smoke, "check", lambda cond, msg: None
                        if cond or "never launched" in msg else
                        pytest.fail(msg))
    with NoWideKernels():
        launches = smoke.narrow_phase(cat, records, host_ms, lambda: None)
    assert launches == dict.fromkeys(records, 0)
