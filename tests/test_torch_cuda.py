"""The port's CUDA kernels against their plain torch versions, on the card.

Needs a CUDA GPU and ``nvcc`` (the kernels build at first use); every test
here skips without a GPU. This file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Bitmaps, pids, histograms, masked columns and counts must match bitwise.
Sums accumulate in f64 in both versions, in an atomic order on the card,
so they are held to rtol=1e-9.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.cost import StorageResources
from repro_torch.core.engine import EngineConfig, results_equal, run_query
from repro_torch.core import bitmap, shuffle
from repro_torch.core.executor import compile_push_plan
from repro_torch.kernels import bitmap_apply as ba
from repro_torch.kernels import fused_scan_agg as fsa
from repro_torch.kernels import fused_scan_shuffle as fss
from repro_torch.kernels import grouped_agg as ga
from repro_torch.kernels import hash_partition as hp
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


def _bits(t):
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("R", ROWS)
def test_bitmap_apply_matches_plain(cuda, R):
    cols = _columns(R, R, cuda)
    rng = np.random.default_rng(R)
    words = ref.pack_bitmap(torch.from_numpy(rng.random(R) < 0.3)).to(cuda)
    words[-1] |= -(1 << 31)  # a set bit past R (when R % 32) is ignored
    for c in ("a", "b", "x", "d"):
        masked, count = ba.bitmap_apply(words, cols[c])
        pmasked, pcount = ref.bitmap_apply(words, cols[c])
        assert masked.dtype == cols[c].dtype and masked.shape == (R,)
        assert torch.equal(_bits(masked), _bits(pmasked)), c
        assert int(count) == int(pcount)


def _keys(R, dtype, device):
    rng = np.random.default_rng(R + 7)
    info = np.iinfo(dtype)
    keys = rng.integers(info.min, info.max, R, dtype=dtype)
    keys[:3] = np.asarray([-1, 0, -(2 ** 31)], dtype)[:R]
    return torch.from_numpy(keys).to(device)


@pytest.mark.parametrize("P", (1, 4, 7, 8192))
@pytest.mark.parametrize("R", ROWS)
def test_hash_partition_matches_plain(cuda, R, P):
    for dtype in (np.int32, np.int64):
        keys = _keys(R, dtype, cuda)
        pids, hist = hp.hash_partition(keys, P)
        ppids, phist = ref.hash_partition(keys, P)
        assert torch.equal(pids, ppids) and torch.equal(hist, phist)


@pytest.mark.parametrize("P", (1, 4, 7))
@pytest.mark.parametrize("R", ROWS)
def test_fused_scan_shuffle_matches_plain(cuda, R, P):
    cols = _columns(R, R, cuda)
    keys = _keys(R, np.int32, cuda)
    for expr in [None, *_predicates()]:
        prog = program_for(expr, cols) if expr is not None else None
        pcols = [cols[c] for c in prog.columns] if prog is not None else []
        out = fss.fused_scan_shuffle(prog, pcols, keys, P)
        plain = ref.fused_scan_shuffle(prog, pcols, keys, P)
        for a, b in zip(out, plain):
            assert torch.equal(a, b), expr


def test_wrappers_count_their_launches(cuda):
    cols = _columns(1000, 0, cuda)
    ids = torch.zeros(1000, dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    kops.predicate_bitmap(cols, Col("a") < 3)
    kops.fused_scan_agg(cols, Col("a") < 3, ids, cols["d"], 1)
    kops.grouped_agg(ids, cols["d"], 1)
    kops.grouped_agg(ids, cols["d"], 1)
    words = kops.predicate_bitmap(cols, Col("a") < 3)
    kops.bitmap_apply(words, cols["d"])
    kops.hash_partition(ids, 4)
    kops.fused_scan_shuffle(cols, Col("a") < 3, ids, 4)
    kops.fused_scan_shuffle(cols, None, ids, 4)
    assert kernels.launches() == {"predicate_bitmap": 2, "fused_scan_agg": 1,
                                  "grouped_agg": 2, "bitmap_apply": 1,
                                  "hash_partition": 1,
                                  "fused_scan_shuffle": 2}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ids = torch.zeros(64, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        ga.grouped_agg(ids, None, 4)
    ids32 = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ga.grouped_agg(ids32, torch.zeros(64, dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        ga.grouped_agg(ids32[::2], None, 4)
    with pytest.raises(ValueError):
        hp.hash_partition(ids32, 8193)
    with pytest.raises(ValueError):
        ba.bitmap_apply(torch.zeros(1, dtype=torch.int32, device=cuda),
                        torch.zeros(64, dtype=torch.float64, device=cuda))


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


def _to_cpu(t):
    return {c: v.cpu() for c, v in t.cols.items()}


def _same(g, c):
    gc = _to_cpu(g)
    return list(gc) == list(c.cols) and all(
        torch.equal(_bits(gc[k]), _bits(c.cols[k])) for k in gc)


def test_section42_paths_on_the_card_match_the_cpu(cuda, catalogs):
    """Fig 3 (bitmap_only aux and bitmap_apply on the cache), Fig 4, the
    table shuffle and the query shuffle plans, on partitions that are not
    32-row aligned, bitwise against the same paths on the CPU."""
    gpu, cpu = catalogs
    pred = (Col("l_quantity") <= 25) & Col("l_shipmode").isin((0, 1))
    gparts = [p.data for p in gpu.partitions_of("lineitem")]
    cparts = [p.data for p in cpu.partitions_of("lineitem")]
    assert len(cparts[0]) % 32
    kernels.reset_launches()
    gw, gt = bitmap.storage_side_bitmap_batched(gparts, pred, ["l_quantity"])
    cw, ct = bitmap.storage_side_bitmap_batched(cparts, pred, ["l_quantity"])
    gm, gn = bitmap.apply_bitmap_to_cache(
        [p.select(["l_extendedprice"]) for p in gparts], gw)
    cm, cn = bitmap.apply_bitmap_to_cache(
        [p.select(["l_extendedprice"]) for p in cparts], cw)
    assert torch.equal(gn.cpu(), cn)
    for a, b, x, y, m, n in zip(gw, cw, gt, ct, gm, cm):
        assert torch.equal(a.cpu(), b) and _same(x, y) and _same(m, n)
    got = bitmap.compute_side_apply_batched(gparts, gw, ["l_orderkey"])
    want = bitmap.compute_side_apply_batched(cparts, cw, ["l_orderkey"])
    assert all(_same(a, b) for a, b in zip(got, want))
    for table, key in (("lineitem", "l_orderkey"), ("orders", "o_custkey")):
        got = shuffle.shuffle_at_storage_batched(gpu, table, key, 4)
        want = shuffle.shuffle_at_storage_batched(cpu, table, key, 4)
        assert all(_same(a, b) for a, b in zip(got, want))
    for qid in ("Q3", "Q12", "Q19"):
        gq, cq = queries.build_query(qid), queries.build_query(qid)
        for table, key in gq.shuffle_keys.items():
            plans = []
            for q in (gq, cq):
                plan = q.plans[table]
                cols = (plan.columns if key in plan.columns
                        else (*plan.columns, key))
                plans.append(compile_push_plan(dataclasses.replace(
                    plan, columns=cols, shuffle=(key, 4))))
            gt, ga_ = plans[0].execute_batch_parts(
                [p.data for p in gpu.partitions_of(table)])
            ct, ca = plans[1].execute_batch_parts(
                [p.data for p in cpu.partitions_of(table)])
            for x, y, a, b in zip(gt, ct, ga_, ca):
                assert _same(x, y)
                assert torch.equal(a["position_vector"].cpu(),
                                   b["position_vector"])
                assert all(_same(s, t) for s, t in zip(a["shuffle_parts"],
                                                       b["shuffle_parts"]))
    assert all(v > 0 for k, v in kernels.launches().items()
               if k not in ("fused_scan_agg", "grouped_agg"))
