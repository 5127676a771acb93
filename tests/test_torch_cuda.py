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


def _view_at(arr, offset, device):
    """A contiguous device view of ``arr`` that starts ``offset`` rows into
    its allocation (not 16-byte aligned for offsets 1 and 3)."""
    pad = np.zeros(offset, arr.dtype)
    base = torch.from_numpy(np.concatenate([pad, arr, pad[:1]])).to(device)
    return base[offset:offset + len(arr)]


def _staging_predicates():
    C = Col
    one = C("a") < 25
    longest = ((C("a").isin((1, 2, 3)) & C("d").between(0.01, 0.05)
                & (C("x") <= 0.5))
               | (C("a").isin((10, 11)) & C("d").between(0.02, 0.09)
                  & (C("b") >= 0))
               | ((C("d") < C("e")) & (C("x") > 0.2) & (C("a") < 40)))
    return [one, longest, C("d") < C("e"), C("b").isin((-3, 0, 4))]


# below one tile, one tile and its edges, and more tiles than every
# block's ring of stages holds (the grid is at most two blocks an SM)
STAGED_ROWS = (1, 100, 2047, 2048, 2049, 3_000_001)


@pytest.mark.parametrize("offset", (0, 1, 3))
@pytest.mark.parametrize("R", STAGED_ROWS)
def test_predicate_bitmap_staged_tiles_match_plain(cuda, R, offset):
    """Views that start off a 16-byte boundary (each column at its own
    offset, int32, int64, f32 and f64), programs of 1 and of 21 ops, a
    column-column leaf and an IN leaf."""
    host = {k: v.cpu().numpy() for k, v in _columns(R, R + offset, "cpu").items()}
    cols = {k: _view_at(v, (offset + i) % 4 if offset else 0, cuda)
            for i, (k, v) in enumerate(host.items())}
    if offset:
        assert any(c.data_ptr() % 16 for c in cols.values())
    progs = [program_for(e, cols) for e in _staging_predicates()]
    assert progs[0].n_ops == 1 and progs[1].n_ops >= 15
    for prog in progs:
        pcols = [cols[c] for c in prog.columns]
        words = pb.predicate_bitmap(prog, pcols)
        assert torch.equal(words, ref.predicate_bitmap(prog, pcols))


# every regime boundary of grouped_agg.plan, either side (one block's
# shared memory, a range bucket, the smem regime's cap), and 2M groups
REGIME_GROUPS = (ga.SMEM_GROUPS, ga.SMEM_GROUPS + 1, 1 << ga.WIN_SHIFT,
                 (1 << ga.WIN_SHIFT) + 1, ga.SMEM_MAX_GROUPS,
                 ga.SMEM_MAX_GROUPS + 1, 2_000_000)


@pytest.mark.parametrize("G", REGIME_GROUPS)
@pytest.mark.parametrize("R", (1, 1029, 300_000, 3_000_001))
def test_grouped_agg_regimes_match_plain(cuda, R, G):
    """Every regime that holds G (smem with one row chunk and several; range
    buckets owned by one block and split over several), out-of-range ids
    dropped, f64, f32 and no values."""
    rng = np.random.default_rng(R + G)
    ids = rng.integers(0, G, R, np.int32)
    ids[::97] = -1
    ids[5::101] = G + 3
    ids = torch.from_numpy(ids).to(cuda)
    vals = torch.from_numpy(rng.uniform(-1e3, 1e5, R)).to(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for regime in ga.REGIMES:
        try:
            p = ga.plan(R, G, sms, regime)
        except ValueError:
            continue
        for values in (vals, vals.to(torch.float32), None):
            s, c = ga.run_plan(p, ids, values, G)
            ps, pcnt = ref.grouped_agg(ids, values, G)
            assert torch.equal(c, pcnt), regime
            torch.testing.assert_close(s, ps, rtol=SUM_RTOL, atol=0.0)


def test_grouped_agg_range_windows_match_plain(cuda):
    """Past MAX_BUCKETS buckets of one window each, buckets are wider than
    a block's partials and are aggregated window by window."""
    G, R = (1 << 28) + 5, 100_000
    assert ga.plan(R, G, 132).shift > ga.WIN_SHIFT
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, G, R, np.int32)).to(cuda)
    vals = torch.from_numpy(rng.normal(size=R)).to(cuda)
    s, c = ga.grouped_agg(ids, vals, G)
    ps, pcnt = ref.grouped_agg(ids, vals, G)
    assert torch.equal(c, pcnt)
    torch.testing.assert_close(s, ps, rtol=SUM_RTOL, atol=0.0)


def _agg_values(cols, V, offset, device):
    """V value columns, f64 and f32 in turn, each a view that starts
    ``offset`` rows into its allocation."""
    out = []
    for j in range(V):
        v = (cols["d"] * (j + 1) + cols["x"].to(torch.float64)).cpu().numpy()
        out.append(_view_at(v if j % 2 == 0 else v.astype(np.float32),
                            offset, device))
    return out


def _check_agg(prog, pcols, ids, values, G):
    s, c = fsa.fused_scan_agg(prog, pcols, ids, values, G)
    ps, pcnt = ref.fused_scan_agg(prog, pcols, ids, values, G)
    assert s.shape == (len(values), G) and s.dtype == torch.float64
    assert torch.equal(c, pcnt)
    torch.testing.assert_close(s, ps, rtol=SUM_RTOL, atol=0.0)


@pytest.mark.parametrize("G", (1, 600, 3072, 3073, 120_000))
@pytest.mark.parametrize("R", ROWS)
def test_fused_scan_agg_matches_plain(cuda, R, G):
    """V = 0 to MAX_VALUES value columns (f64 and f32), with and without a
    predicate, on views that start at row 0 and at row 1."""
    cols = _columns(R, R + G, cuda)
    rng = np.random.default_rng(G)
    # ids outside [0, G) must be dropped, never written
    ids = torch.from_numpy(rng.integers(-1, G + 1, R, np.int32)).to(cuda)
    prog = program_for(_predicates()[7], cols)
    for offset in (0, 1):
        vcols = {k: _view_at(v.cpu().numpy(), offset, cuda)
                 for k, v in cols.items()}
        pcols = [vcols[c] for c in prog.columns]
        vids = _view_at(ids.cpu().numpy(), offset, cuda)
        for V in range(fsa.MAX_VALUES + 1):
            values = _agg_values(cols, V, offset, cuda)
            for p, pc in ((prog, pcols), (None, ())):
                _check_agg(p, pc, vids, values, G)


# csrc/fused_scan_agg.cu keeps G x (8V + 8) bytes of partials in shared
# memory beside two stages while one block's opt-in 227 KB holds them
SMEM_ROOM = 228 * 1024 - 1024 - 128


@pytest.mark.parametrize("V", range(5))
def test_fused_scan_agg_partials_cap_matches_plain(cuda, V):
    """G on both sides of the shared-memory cap: with no predicate (no
    stage) the cap is exactly SMEM_ROOM // (8V + 8); with one int32
    predicate column, G past it by far and below it."""
    assert fsa.MAX_VALUES == 4
    cap = SMEM_ROOM // (8 * V + 8)
    R = 300_007
    cols = _columns(R, V, cuda)
    prog = program_for(Col("a") < 40, cols)
    for G in (cap, cap + 1, 1000, 2 * cap):
        rng = np.random.default_rng(G)
        ids = torch.from_numpy(rng.integers(0, G, R, np.int32)).to(cuda)
        values = _agg_values(cols, V, 0, cuda)
        _check_agg(None, (), ids, values, G)
        _check_agg(prog, [cols["a"]], ids, values, G)


def test_fused_scan_agg_takes_at_most_max_values(cuda):
    ids = torch.zeros(64, dtype=torch.int32, device=cuda)
    vals = torch.zeros(64, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        fsa.fused_scan_agg(None, (), ids, [vals] * (fsa.MAX_VALUES + 1), 4)
    with pytest.raises(ValueError):
        fsa.fused_scan_agg(None, (), ids, vals, 4)  # a tensor, not a list


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


SEGMENT_COUNTS = (1, 2, 7, 100, 400)


@pytest.mark.parametrize("n_seg", SEGMENT_COUNTS)
def test_bitmap_apply_segments_match_plain(cuda, n_seg):
    """Segments of 0 to 20,000 rows (some far from a multiple of 32), views
    at odd row offsets (not 16-byte aligned), int32, int64, f32 and f64
    columns mixed, several segments a partition sharing its words, an
    all-zero and an all-one bitmap, and set bits past R."""
    rng = np.random.default_rng(n_seg)
    dtypes = (np.int32, np.int64, np.float32, np.float64)
    words, cols, part_of = [], [], []
    p = 0
    while len(cols) < n_seg:
        R = int(rng.choice([0, 1, 33, 4095, 4096, 4097, 20_000,
                            int(rng.integers(1, 20_000))]))
        keep = rng.random(R) < rng.choice([0.0, 0.03, 0.5, 1.0])
        w = ref.pack_bitmap(torch.from_numpy(keep)).to(cuda)
        if R % 32:
            w[-1] |= -(1 << 31)  # a set bit past R is ignored
        for _ in range(min(int(rng.integers(1, 4)), n_seg - len(cols))):
            dt = dtypes[int(rng.integers(4))]
            v = (rng.normal(size=R) * 1e3).astype(dt)
            if R:
                v[0] = -0.0 if dt in (np.float32, np.float64) else -7
            words.append(w)
            cols.append(_view_at(v, int(rng.integers(0, 4)), cuda))
            part_of.append(p)
        p += int(rng.integers(1, 3))  # some partitions have no segment
    kernels.reset_launches()
    outs, counts = ba.bitmap_apply_segments(words, cols, part_of)
    assert kernels.launches()["bitmap_apply"] == (1 if any(
        c.shape[0] for c in cols) else 0)
    pouts, pcounts = ref.bitmap_apply_segments(words, cols, part_of)
    assert counts.dtype == torch.int64 and torch.equal(counts, pcounts)
    for o, po, c in zip(outs, pouts, cols):
        assert o.dtype == c.dtype and o.shape == c.shape
        assert torch.equal(_bits(o), _bits(po))


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


def test_one_launch_per_agg_batch_and_fig3_apply(cuda, catalogs):
    """Q1's pushed aggregate (four sums and a count) is one fused_scan_agg
    launch, Q6's one; a Fig-3 apply over every partition and three cached
    columns is one bitmap_apply launch."""
    gpu, _ = catalogs
    parts = [p.data for p in gpu.partitions_of("lineitem")]
    for qid in ("Q1", "Q6"):
        plan = compile_push_plan(queries.build_query(qid).plans["lineitem"])
        kernels.reset_launches()
        plan.execute_batch_parts(parts)
        assert kernels.launches()["fused_scan_agg"] == 1, qid
    pred = Col("l_quantity") <= 25
    words, _ = bitmap.storage_side_bitmap_batched(parts, pred,
                                                  ["l_quantity"])
    cached = ["l_discount", "l_extendedprice", "l_partkey"]
    kernels.reset_launches()
    bitmap.apply_bitmap_to_cache([p.select(cached) for p in parts], words)
    assert kernels.launches()["bitmap_apply"] == 1


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
