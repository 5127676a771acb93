"""The port's CUDA kernels against their plain torch versions, on the card.

Needs a CUDA GPU and ``nvcc`` (the kernels build at first use); every test
here skips without a GPU. This file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Bitmaps and counts must match bitwise. Sums accumulate in f64 in both
versions, in an atomic order on the card, so they are held to rtol=1e-9.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.cost import StorageResources
from repro_torch.core.engine import EngineConfig, results_equal, run_query
from repro_torch.kernels import fused_scan_agg as fsa
from repro_torch.kernels import grouped_agg as ga
from repro_torch.kernels import ops as kops
from repro_torch.kernels import predicate_bitmap as pb
from repro_torch.kernels import ref
from repro_torch.kernels.program import program_for
from repro_torch.queryproc import queries, tpch
from repro_torch.queryproc.expressions import Col

pytestmark = pytest.mark.gpu
SUM_RTOL = 1e-9
ROWS = (1, 31, 32, 33, 1029, 3 * 1024, 100_003)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _columns(R, seed, device):
    rng = np.random.default_rng(seed)
    cols = {"a": rng.integers(0, 50, R, np.int32),
            "b": rng.integers(-5, 5, R).astype(np.int64),
            "x": rng.uniform(0.0, 1.0, R).astype(np.float32),
            "d": rng.integers(0, 11, R).astype(np.float64) / 100.0}
    cols["e"] = cols["d"][rng.permutation(R)]
    return {k: torch.from_numpy(v).to(device) for k, v in cols.items()}


def _predicates():
    C = Col
    col_col = C("d") < C("e")
    return [
        C("a") < 25,
        C("d").between(0.05, 0.0701),
        C("d") <= float(np.nextafter(0.05, 1.0)),
        C("d") >= float(np.nextafter(0.05, 0.0)),
        C("x") > 0.3,
        C("b").isin((-3, 0, 4)),
        col_col,
        (C("a").isin((1, 2, 3)) & (C("b") >= 0)) | ((C("x") <= 0.5) & col_col),
        C("a").eq(7) | C("a").eq(8) | ((C("d") > 0.08) & (C("b") < -1)),
    ]


@pytest.mark.parametrize("R", ROWS)
def test_predicate_bitmap_matches_plain(cuda, R):
    cols = _columns(R, R, cuda)
    for expr in _predicates():
        prog = program_for(expr, cols)
        pcols = [cols[c] for c in prog.columns]
        words = pb.predicate_bitmap(prog, pcols)
        assert words.shape == (-(-R // 32),)
        assert torch.equal(words, ref.predicate_bitmap(prog, pcols)), expr


@pytest.mark.parametrize("G", (1, 600, 3072, 3073, 120_000))
@pytest.mark.parametrize("R", ROWS)
def test_fused_scan_agg_matches_plain(cuda, R, G):
    cols = _columns(R, R + G, cuda)
    rng = np.random.default_rng(G)
    # ids outside [0, G) must be dropped, never written
    ids = torch.from_numpy(rng.integers(-1, G + 1, R, np.int32)).to(cuda)
    prog = program_for(_predicates()[7], cols)
    pcols = [cols[c] for c in prog.columns]
    for values in (cols["x"], cols["d"], None):
        for p, pc in ((prog, pcols), (None, ())):
            s, c = fsa.fused_scan_agg(p, pc, ids, values, G)
            ps, pcnt = ref.fused_scan_agg(p, pc, ids, values, G)
            assert torch.equal(c, pcnt)
            torch.testing.assert_close(s, ps, rtol=SUM_RTOL, atol=0.0)


@pytest.mark.parametrize("G", (6, 3072, 120_000))
@pytest.mark.parametrize("R", ROWS)
def test_grouped_agg_matches_plain(cuda, R, G):
    rng = np.random.default_rng(R * G)
    ids = torch.from_numpy(rng.integers(0, G, R, np.int32)).to(cuda)
    vals = torch.from_numpy(rng.uniform(-1e3, 1e5, R)).to(cuda)
    s, c = ga.grouped_agg(ids, vals, G)
    ps, pcnt = ref.grouped_agg(ids, vals, G)
    assert torch.equal(c, pcnt)
    torch.testing.assert_close(s, ps, rtol=SUM_RTOL, atol=0.0)
    # op-level signature: sums in the values' dtype, int32 counts
    s32, c32 = kops.grouped_agg(ids, vals.to(torch.float32), G)
    assert s32.dtype == torch.float32 and c32.dtype == torch.int32
    assert torch.equal(c32, pcnt.to(torch.int32))


def test_wrappers_count_their_launches(cuda):
    cols = _columns(1000, 0, cuda)
    ids = torch.zeros(1000, dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    kops.predicate_bitmap(cols, Col("a") < 3)
    kops.fused_scan_agg(cols, Col("a") < 3, ids, cols["d"], 1)
    kops.grouped_agg(ids, cols["d"], 1)
    kops.grouped_agg(ids, cols["d"], 1)
    assert kernels.launches() == {"predicate_bitmap": 1, "fused_scan_agg": 1,
                                  "grouped_agg": 2}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ids = torch.zeros(64, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        ga.grouped_agg(ids, None, 4)
    ids32 = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ga.grouped_agg(ids32, torch.zeros(64, dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        ga.grouped_agg(ids32[::2], None, 4)


@pytest.fixture(scope="module")
def catalogs(cuda):
    return tuple(tpch.build_catalog(sf=2.0, seed=1, num_nodes=2,
                                    rows_per_partition=3000, device=d)
                 for d in (cuda, "cpu"))


@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_engine_on_the_card_matches_the_cpu(cuda, catalogs, qid):
    gpu, cpu = catalogs
    for power in (1.0, 0.1):
        res = StorageResources(storage_power=power)
        kernels.reset_launches()
        g = run_query(queries.build_query(qid), gpu,
                      EngineConfig(res=res, mode="adaptive", device=cuda))
        assert sum(kernels.launches().values()) > 0
        c = run_query(queries.build_query(qid), cpu,
                      EngineConfig(res=res, mode="adaptive", device="cpu"))
        assert results_equal(g.result, c.result)
        assert g.sim.decisions() == c.sim.decisions()
        assert g.real_net_bytes == c.real_net_bytes
