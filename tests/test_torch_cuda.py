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


@pytest.mark.parametrize("G", (1_500_000, 6_000_000))
def test_fused_scan_agg_without_a_predicate_at_millions_of_groups(cuda, G):
    """Q18's pushed aggregate: no predicate (``prog=None``), one f64 value
    and about a row a group, so the partials live in global memory."""
    R = 6_000_011
    rng = np.random.default_rng(G)
    ids = torch.from_numpy(rng.integers(0, G, R, np.int32)).to(cuda)
    values = [torch.from_numpy(rng.integers(1, 51, R).astype(np.float64))
              .to(cuda)]
    _check_agg(None, (), ids, values, G)
    _check_agg(None, (), ids, [], G)


def test_having_program_over_agg_outputs_matches_plain(cuda):
    """A HAVING predicate over a partial aggregate's output dtypes (int32
    keys, f64 sums, int64 counts) through ``predicate_bitmap``."""
    R = 1_000_003
    rng = np.random.default_rng(7)
    cols = {"k": torch.from_numpy(rng.integers(0, 10**6, R, np.int32)),
            "sum_qty": torch.from_numpy(rng.integers(1, 400, R)
                                        .astype(np.float64)),
            "n": torch.from_numpy(rng.integers(1, 8, R).astype(np.int64))}
    exprs = (Col("sum_qty") > 150.0, (Col("sum_qty") > 150.0) & (Col("n") >= 3),
             (Col("n") < 2) | (Col("k").isin((5, 9, 77)) & (Col("sum_qty") <= 10)),
             Col("sum_qty") > Col("n"))
    gcols = {c: v.to(cuda) for c, v in cols.items()}
    for expr in exprs:
        prog = program_for(expr, gcols)
        words = pb.predicate_bitmap(prog, [gcols[c] for c in prog.columns])
        plain = ref.predicate_bitmap(prog, [cols[c] for c in prog.columns])
        assert torch.equal(words.cpu(), plain), expr


def test_pushed_having_top_k_and_min_max_on_the_card_match_the_cpu(cuda):
    """The executor's three compiler stages on the card, bitwise against
    the CPU (sums at rtol=1e-9): HAVING on lineitem clustered by
    ``l_orderkey`` (Q18's frontier), a segmented top-k with ties
    (``l_partkey`` takes 400 values) and with none, and min/max beside a
    sum and a count."""
    from repro_torch.compiler import compile_ir, compile_query_detailed, ir
    cats = [tpch.build_catalog(sf=2.0, seed=1, num_nodes=2,
                               rows_per_partition=3000, device=d,
                               cluster={"lineitem": "l_orderkey"})
            for d in (cuda, "cpu")]
    q18 = compile_ir(compile_query_detailed("Q18").root, "Q18",
                     clustered=cats[0].clustered)
    plans = [q18.plans["lineitem"]]
    assert plans[0].having is not None
    scan = ir.Filter(ir.Scan("lineitem", ("l_orderkey", "l_partkey",
                                          "l_extendedprice")),
                     Col("l_shipdate") < 1500)
    for col in ("l_partkey", "l_extendedprice"):
        plans.append(compile_ir(ir.TopK(scan, col, 25)).plans["lineitem"])
    plans.append(compile_ir(ir.Aggregate(scan, ("l_returnflag",), (
        ("lo", "min", "l_extendedprice"), ("hi", "max", "l_partkey"),
        ("s", "sum", "l_extendedprice"), ("n", "count", "")))).plans[
            "lineitem"])
    assert plans[1].top_k and plans[3].agg
    for plan in plans:
        kernels.reset_launches()
        got, _ = compile_push_plan(plan).execute_batch_parts(
            [p.data for p in cats[0].partitions_of("lineitem")])
        assert sum(kernels.launches().values()) > 0
        want, _ = compile_push_plan(plan).execute_batch_parts(
            [p.data for p in cats[1].partitions_of("lineitem")])
        assert sum(len(w) for w in want) > 0
        for g, w in zip(got, want):
            assert list(g.cols) == list(w.cols)
            for c, v in w.cols.items():
                x = g.cols[c].cpu()
                assert x.dtype == v.dtype
                if c == "s" or (c == "sum_qty" and v.is_floating_point()):
                    torch.testing.assert_close(x, v, rtol=SUM_RTOL, atol=0)
                else:
                    assert torch.equal(_bits(x), _bits(v)), (plan, c)


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


def _deep_predicate():
    """A right-nested AND of 12 leaves: stack depth 12 (past 8, W > 1)."""
    C = Col
    leaves = [C("a") < 45, C("b") >= -4, C("x") <= 0.95, C("d") < 0.1,
              C("a") >= 2, C("b").isin((-4, -3, -1, 0, 2, 3, 4)),
              C("x") > 0.01, C("d") <= C("e"), C("a").isin(tuple(range(40))),
              C("b") <= 3, C("x") < 0.99, C("d") >= 0.0]
    expr = leaves[-1]
    for leaf in reversed(leaves[:-1]):
        expr = leaf & expr
    return expr


def _depth(prog) -> int:
    d = most = 0
    for code in prog.ops[:, 0].tolist():
        d += -1 if code & 15 in (3, 4) else 1  # K_AND, K_OR pop one
        most = max(most, d)
    return most


# one consumer warp's sub-tile (256 rows) and one tile (2048) either side,
# one tile a block (one partition), and more tiles than the grid has blocks
SHUFFLE_ROWS = (1, 31, 255, 256, 257, 2047, 2048, 2049, 6244, 600_000,
                2_000_003)


@pytest.mark.parametrize("key_dtype", (np.int32, np.int64))
@pytest.mark.parametrize("offset", (0, 1, 2, 3))
@pytest.mark.parametrize("R", SHUFFLE_ROWS)
def test_fused_scan_shuffle_staged_tiles_match_plain(cuda, R, offset,
                                                     key_dtype):
    """Keys and columns as views that start 0-3 rows into their
    allocations (each at its own offset, so each bulk copy's head and tail
    are unaligned), int32 and int64 keys (only the low 32 bits hash), no
    program, programs of depth 1 and past 8, at P = 1, 8 (register
    counters), 9 and 8192 (shared counters beside the ring)."""
    host = {k: v.cpu().numpy()
            for k, v in _columns(R, R + offset, "cpu").items()}
    cols = {k: _view_at(v, (offset + i) % 4 if offset else 0, cuda)
            for i, (k, v) in enumerate(host.items())}
    key_host = _keys(R, key_dtype, "cpu").numpy()
    if key_dtype == np.int64:  # high bits that must not change the target
        shift = np.arange(R, dtype=np.int64) % 31 + 32
        key_host = key_host ^ (np.int64(1) << shift)
    # 1-3 rows off for int32 keys, 1 or 3 for int64 (2 rows are 16 bytes)
    key_off = offset if key_dtype == np.int32 or offset != 2 else 1
    keys = _view_at(key_host, key_off, cuda)
    if offset:
        assert keys.data_ptr() % 16 and any(c.data_ptr() % 16
                                            for c in cols.values())
    progs = [None] + [program_for(e, cols) for e in
                      (Col("a") < 25, _deep_predicate(),
                       _staging_predicates()[1])]
    assert _depth(progs[2]) > 8
    for P in (1, 8, 9, 8192):
        for prog in progs:
            pcols = [cols[c] for c in prog.columns] if prog else []
            out = fss.fused_scan_shuffle(prog, pcols, keys, P)
            plain = ref.fused_scan_shuffle(prog, pcols, keys, P)
            for a, b in zip(out, plain):
                assert a.dtype == b.dtype and torch.equal(a, b), (P, prog)


def _pooled_lists(host, rng):
    """A pooled In (100 values) on each column type: an int32 column with
    values past int32's range too (int64 list, narrowed), an int64 one, an
    f32 one compared in f32 and one in f64, an f64 one; each list holds the
    column's least and greatest values (the pool's first and last) and,
    for floats, -0.0 against columns that hold 0.0 and -0.0."""
    a, b, x, d = host["a"], host["b"], host["x"], host["d"]
    ints = rng.choice(1000, 96, replace=False) + 100
    ivals = (int(a.min()), int(a.max()), -2 ** 40, 2 ** 40) + tuple(
        int(v) for v in ints)
    bvals = (int(b.min()), int(b.max())) + tuple(int(v) for v in ints[:98])
    xs = np.concatenate([[x.min(), x.max(), -0.0], x[:50],
                         rng.uniform(0.0, 1.0, 50)]).astype(np.float32)
    ds = np.concatenate([[d.min(), d.max(), -0.0], np.arange(97) / 50.0])
    return [Col("a").isin(ivals), Col("b").isin(bvals),
            Col("x").isin(tuple(np.float32(v) for v in xs)),
            Col("x").isin(tuple(float(v) for v in xs)),
            Col("d").isin(tuple(float(v) for v in ds)),
            (Col("a").isin(ivals) & (Col("d") > 0.02))
            | Col("x").isin(tuple(float(v) for v in xs))]


@pytest.mark.parametrize("offset", (0, 1, 3))
@pytest.mark.parametrize("R", (33, 2049, 1_000_003))
def test_fused_scan_shuffle_pooled_in_matches_plain(cuda, R, offset):
    """Pooled In lists searched in shared memory on every column type, and
    lists too large for it searched in device memory."""
    host = {k: v.cpu().numpy()
            for k, v in _columns(R, R + offset, "cpu").items()}
    rng = np.random.default_rng(R)
    host["x"][: min(R, 4)] = np.float32(0.0)
    host["x"][4:8] = np.float32(-0.0)
    host["d"][: min(R, 4)] = -0.0
    host["d"][4:8] = 0.0
    cols = {k: _view_at(v, (offset + i) % 4 if offset else 0, cuda)
            for i, (k, v) in enumerate(host.items())}
    keys = torch.from_numpy(rng.integers(0, 10 ** 6, R, np.int32)).to(cuda)
    big = rng.choice(10 ** 7, 70_000, replace=False)
    cases = [(e, 1) for e in _pooled_lists(host, rng)] + [
        (Col("a").isin(tuple(int(v) for v in big)), 0),  # 280 KB narrowed
        (Col("b").isin(tuple(int(v) - 5 * 10 ** 6 for v in big)), 0)]
    for expr, staged in cases:
        prog = program_for(expr, cols)
        assert len(prog.pool) > 0, expr
        pcols = [cols[c] for c in prog.columns]
        for P in (4, 8192):
            out = fss.fused_scan_shuffle(prog, pcols, keys, P)
            assert fss.fused_scan_shuffle.last_launch["pool_staged"] == staged
            plain = ref.fused_scan_shuffle(prog, pcols, keys, P)
            assert all(torch.equal(a, b) for a, b in zip(out, plain)), expr


def test_fused_scan_shuffle_reports_its_launch(cuda):
    keys = torch.arange(100_000, dtype=torch.int32, device=cuda)
    fss.fused_scan_shuffle(None, [], keys, 4)
    got = fss.fused_scan_shuffle.last_launch
    assert set(got) == set(fss.LAUNCH_FIELDS)
    assert 1 <= got["blocks"] <= got["blocks_per_sm"] * \
        torch.cuda.get_device_properties(cuda).multi_processor_count
    assert got["stages"] >= 2 and got["pool_staged"] == 0
    assert got["tile_rows"] * got["blocks"] >= min(100_000, got["tile_rows"])


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
    """The compiled query and the hand-built one, on the card as on the
    CPU."""
    gpu, cpu = catalogs
    for build in (queries.build_query, queries.build_query_legacy):
        for power in (1.0, 0.1):
            res = StorageResources(storage_power=power)
            kernels.reset_launches()
            g = run_query(build(qid), gpu,
                          EngineConfig(res=res, mode="adaptive", device=cuda))
            assert sum(kernels.launches().values()) > 0
            c = run_query(build(qid), cpu,
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


def _pooled_predicates(cols, n_vals, seed):
    """A pooled In of ``n_vals`` constants on each of an int32, an int64
    and an f64 column, alone and inside a larger program."""
    rng = np.random.default_rng(seed)
    vals = tuple(int(v) for v in rng.choice(50, min(n_vals, 50),
                                            replace=False))
    vals += tuple(range(1000, 1000 + n_vals - len(vals)))
    fvals = tuple(float(v) / 100.0 for v in rng.choice(
        1100, n_vals, replace=False))
    return [Col("a").isin(vals), Col("b").isin(vals), Col("d").isin(fvals),
            (Col("a").isin(vals) & (Col("x") > 0.2))
            | (Col("d").isin(fvals) & Col("b").isin((-3, 0, 4)))]


@pytest.mark.parametrize("n_vals", (65, 512))
@pytest.mark.parametrize("offset", (0, 1, 3))
@pytest.mark.parametrize("R", (33, 2049, 1_000_003))
def test_pooled_in_matches_plain(cuda, R, offset, n_vals):
    """The pooled In (a sorted device list, binary-searched) through the
    three kernels that interpret a program, on views that start off a
    16-byte boundary."""
    host = {k: v.cpu().numpy()
            for k, v in _columns(R, R + offset, "cpu").items()}
    cols = {k: _view_at(v, (offset + i) % 4 if offset else 0, cuda)
            for i, (k, v) in enumerate(host.items())}
    rng = np.random.default_rng(R)
    G = 600
    ids = torch.from_numpy(rng.integers(0, G, R, np.int32)).to(cuda)
    keys = torch.from_numpy(rng.integers(0, 10 ** 6, R)).to(cuda)
    for expr in _pooled_predicates(cols, n_vals, R):
        prog = program_for(expr, cols)
        assert len(prog.pool) > 0, expr
        pcols = [cols[c] for c in prog.columns]
        words = pb.predicate_bitmap(prog, pcols)
        assert torch.equal(words, ref.predicate_bitmap(prog, pcols)), expr
        _check_agg(prog, pcols, ids, [cols["d"], cols["x"]], G)
        out = fss.fused_scan_shuffle(prog, pcols, keys, 4)
        plain = ref.fused_scan_shuffle(prog, pcols, keys, 4)
        assert all(torch.equal(a, b) for a, b in zip(out, plain)), expr


@pytest.mark.parametrize("kind", ("filter", "agg", "shuffle"))
def test_split_program_route_on_the_card_matches_the_cpu(cuda, kind):
    """The nine-column AND (two programs, words combined with &) through
    the executor: a filter, an aggregate over the kept rows and a shuffle
    of the kept keys, on partitions that are not 32-row aligned."""
    from repro_torch.core.plan import PushPlan
    from repro_torch.queryproc.table import ColumnTable
    rng = np.random.default_rng(9)
    host = {f"c{i}": rng.integers(-1, 30, 5000).astype(np.int32)
            for i in range(9)}
    pred = Col("c0") >= 0
    for i in range(1, 9):
        pred = pred & (Col(f"c{i}") >= 0)
    kw = dict(table="t", columns=tuple(sorted(host)))
    if kind == "agg":
        kw = dict(table="t", columns=("c0", "n"),
                  agg=(("c0",), (("n", "count", ""),)))
    elif kind == "shuffle":
        kw["shuffle"] = ("c0", 4)
    plan = compile_push_plan(PushPlan(predicate=pred, **kw))
    bounds = (0, 1700, 3333, 5000)
    runs = []
    for dev in (cuda, "cpu"):
        parts = [ColumnTable.from_numpy({c: v[lo:hi] for c, v in
                                         host.items()}, dev)
                 for lo, hi in zip(bounds, bounds[1:])]
        kernels.reset_launches()
        runs.append(plan.execute_batch_parts(parts))
        if dev == cuda:
            n = kernels.launches()
            assert n["predicate_bitmap"] == 2 and n["fused_scan_shuffle"] == 0
            assert n["fused_scan_agg"] == (kind == "agg")
            assert n["hash_partition"] == (kind == "shuffle")
    (gt, ga_), (ct, ca) = runs
    for x, y, a, b in zip(gt, ct, ga_, ca):
        assert _same(x, y)
        for s, t in zip(a.get("shuffle_parts", ()),
                        b.get("shuffle_parts", ())):
            assert _same(s, t)


def test_group_ids_over_wide_keys_on_the_card(cuda):
    from repro_torch.queryproc.operators import group_ids, grouped_agg
    from repro_torch.queryproc.table import ColumnTable
    a = torch.tensor([0, 2 ** 31, 0, 2 ** 31], device=cuda)
    b = torch.tensor([0, 2 ** 31, 0, 0], device=cuda)
    ids, G, decode = group_ids([a, b])
    assert G == 3 and ids.tolist() == [0, 2, 0, 1]
    _, (ka, kb) = decode(torch.arange(G, device=cuda))
    assert ka.tolist() == [0, 2 ** 31, 2 ** 31] and kb.tolist() == [
        0, 0, 2 ** 31]
    out = grouped_agg(ColumnTable({"a": a, "b": b, "v": torch.tensor(
        [1.0, 2.0, 3.0, 4.0], device=cuda)}), ["a", "b"],
        {"s": ("sum", "v")})
    assert out.cols["s"].tolist() == [4.0, 4.0, 2.0]


@pytest.mark.parametrize("qid", ("Q3", "Q5", "Q7", "Q8", "Q17", "Q18", "Q19"))
def test_costed_compile_and_run_on_the_card_matches_the_cpu(cuda, qid):
    """The cost-based compiler's frontier (lowered In lists, the bitmap
    exchange, cuts below an aggregate) on a catalog whose dimension tables
    are small enough for the domain lowerings, as on the CPU."""
    from repro_torch.core.engine import compile_and_run
    gpu, cpu = (tpch.build_catalog(sf=1.0, seed=0, num_nodes=2,
                                   rows_per_partition=4000, device=d)
                for d in (cuda, "cpu"))
    for mode, power in (("eager", 1.0), ("adaptive", 0.1)):
        res = StorageResources(storage_power=power)
        kernels.reset_launches()
        g = compile_and_run(qid, gpu, EngineConfig(res=res, mode=mode,
                                                   device=cuda),
                            cost_based=True)
        assert sum(kernels.launches().values()) > 0
        c = compile_and_run(qid, cpu, EngineConfig(res=res, mode=mode,
                                                   device="cpu"),
                            cost_based=True)
        assert results_equal(g.result, c.result)
        assert g.sim.decisions() == c.sim.decisions()
        assert g.real_net_bytes == c.real_net_bytes
        assert g.net_bytes_recon == c.net_bytes_recon


def _and9_columns(R, device):
    rng = np.random.default_rng(R + 9)
    return {f"c{i}": torch.from_numpy(rng.integers(-1, 30, R).astype(
        np.int32)).to(device) for i in range(9)}


def _and9():
    e = Col("c0") >= 0
    for i in range(1, 9):
        e = e & (Col(f"c{i}") >= 0)
    return e


@pytest.mark.parametrize("R", (1, 33, 100_003))
def test_op_shims_take_a_split_predicate_on_the_card(cuda, R):
    """The nine-column AND through ``ops.fused_scan_agg`` and
    ``ops.fused_scan_shuffle`` on the card, against the same shims on the
    CPU (the plain versions): two ``predicate_bitmap`` launches, then the
    program-free kernels over the kept rows."""
    rng = np.random.default_rng(R)
    ids = rng.integers(0, 37, R).astype(np.int32)
    vals = rng.uniform(0, 10, R).astype(np.float32)
    keys = rng.integers(-2 ** 31, 2 ** 31 - 1, R, dtype=np.int32)
    out = {}
    for dev in (cuda, "cpu"):
        cols = _and9_columns(R, dev)
        kernels.reset_launches()
        agg = kops.fused_scan_agg(cols, _and9(),
                                  torch.from_numpy(ids).to(dev),
                                  torch.from_numpy(vals).to(dev), 37)
        shuf = kops.fused_scan_shuffle(cols, _and9(),
                                       torch.from_numpy(keys).to(dev), 4)
        out[str(dev)] = [t.cpu() for t in (*agg, *shuf)], kernels.launches()
    (g, n), (c, _) = out["cuda"], out["cpu"]
    assert n["predicate_bitmap"] == 4 and n["hash_partition"] == 1
    assert n["fused_scan_agg"] == 1 and n["fused_scan_shuffle"] == 1
    torch.testing.assert_close(g[0], c[0], rtol=1e-5, atol=0.0)  # f32 sums
    for a, b in zip(g[1:], c[1:]):
        assert torch.equal(a, b)


def test_cache_containment_serve_on_the_card_matches_the_cpu(cuda,
                                                             catalogs):
    """A tighter predicate served from a looser cached entry re-filters
    the cached device columns with ``predicate_bitmap`` (no plain
    version): the rows equal the plain route's, and the filter words the
    CPU's."""
    from repro_torch.core.plan import PushPlan
    from repro_torch.core.result_cache import ResultCache
    from repro_torch.queryproc.expressions import And, Cmp
    loose = compile_push_plan(PushPlan(
        "lineitem", ("l_quantity", "l_extendedprice"),
        predicate=Cmp("<", Col("l_quantity"), 40)))
    tight = compile_push_plan(dataclasses.replace(
        loose.plan, predicate=And(loose.plan.predicate,
                                  Cmp("<", Col("l_quantity"), 20))))
    gpu, cpu = catalogs
    served = {}
    for cat in (gpu, cpu):
        cache = ResultCache()
        part = cat.partitions_of("lineitem")[1]
        cache.put(loose, part, *loose.execute(part.data))
        kernels.reset_launches()
        got = cache.serve(tight, part)
        served[cat.device.type] = got, kernels.launches()
    (g, n), (c, _) = served["cuda"], served["cpu"]
    assert g[2] == c[2] == "containment"
    assert n["predicate_bitmap"] == 1 and sum(n.values()) == 1
    assert _same(g[0], c[0]) and 0 < len(c[0])
    assert all(v.device.type == "cuda" for v in g[0].cols.values())


def test_chaos_run_on_the_card_matches_its_clean_run(cuda, catalogs):
    """Every query under the four fault kinds on the card: the clean run's
    result, the CPU's recovery and outcomes, demoted groups replayed on
    the kernels."""
    from repro_torch.core.faults import CircuitBreaker, FaultPlan, RetryPolicy
    gpu, cpu = catalogs
    spec = "crash:0.25,timeout:0.15,transient:0.2,straggler:0.2:0.001"
    demoted = 0
    for qid in ("Q3", "Q6", "Q12", "Q19"):
        runs = {}
        for cat in (gpu, cpu):
            def cfg(plan):
                return EngineConfig(mode="adaptive", device=cat.device,
                                    faults=plan,
                                    retry=RetryPolicy(sleep_scale=0.0),
                                    breaker=CircuitBreaker())
            clean = run_query(queries.build_query(qid), cat, cfg(None))
            kernels.reset_launches()
            chaos = run_query(queries.build_query(qid), cat,
                              cfg(FaultPlan.from_spec(spec, int(qid[1:]))))
            runs[cat.device.type] = clean, chaos, kernels.launches()
        (gclean, gchaos, n), (_, cchaos, _) = runs["cuda"], runs["cpu"]
        assert results_equal(gclean.result, gchaos.result)
        assert gchaos.recovery == cchaos.recovery
        assert [dataclasses.astuple(o) for o in gchaos.outcomes] == \
            [dataclasses.astuple(o) for o in cchaos.outcomes]
        assert sum(n.values()) > 0
        demoted += gchaos.n_demoted
    assert demoted > 0


def test_reference_executor_refuses_card_tensors(cuda, catalogs):
    """The per-partition oracle runs the plain operators: the engine, the
    split and ``execute_push_plan`` refuse it on a card catalog instead
    of running the plain versions on the device."""
    from repro_torch.core import runtime
    from repro_torch.core.engine import plan_requests
    from repro_torch.core.plan import execute_push_plan
    gpu, _ = catalogs
    query = queries.build_query("Q6")
    with pytest.raises(ValueError, match="reference executor"):
        run_query(query, gpu, EngineConfig(device=gpu.device,
                                           executor="reference"))
    reqs = plan_requests(query, gpu)
    with pytest.raises(ValueError, match="CPU oracle"):
        runtime.execute_split(reqs, {}, executor="reference")
    with pytest.raises(ValueError, match="CPU oracle"):
        execute_push_plan(reqs[0].plan, reqs[0].part.data)


# ------------------------------------------------------------ stream driver
SLEEP_CYCLES = 20_000_000     # ~10 ms of device time at the H100's clocks


@pytest.fixture
def fresh_metrics():
    """A fresh metrics registry, so each stream reads its fluid queues."""
    from repro_torch.obs import metrics
    prev = metrics.set_metrics(metrics.Metrics())
    yield metrics.get_metrics()
    metrics.set_metrics(prev)


def _stream(qids, gap=0.002):
    from repro_torch.core.runtime import StreamQuery
    return [StreamQuery(queries.build_query(q), arrival=i * gap)
            for i, q in enumerate(qids)]


def _multi_element_tensors(obj, path="attrs"):
    if isinstance(obj, torch.Tensor):
        return [path] if obj.numel() > 1 else []
    if isinstance(obj, dict):
        return [p for k, v in obj.items()
                for p in _multi_element_tensors(v, f"{path}.{k}")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj)
                for p in _multi_element_tensors(v, f"{path}[{i}]")]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [p for f in dataclasses.fields(obj)
                for p in _multi_element_tensors(getattr(obj, f.name),
                                                f"{path}.{f.name}")]
    return []


def test_stream_on_the_card_matches_the_cpu(cuda, catalogs, fresh_metrics):
    """All 15 queries and Q6 again through ``run_stream`` on the card
    catalog: the CPU port's results, decisions and bytes, with kernels
    launched."""
    from repro_torch.core.runtime import run_stream
    from repro_torch.obs import metrics
    gpu, cpu = catalogs
    qids = [*queries.QUERY_IDS, "Q6"]
    for mode, power in (("no_pushdown", 1.0), ("adaptive", 0.1)):
        res = StorageResources(storage_power=power)
        metrics.set_metrics(metrics.Metrics())
        kernels.reset_launches()
        g = run_stream(_stream(qids), gpu,
                       EngineConfig(res=res, mode=mode, device=cuda))
        launched = sum(kernels.launches().values())
        metrics.set_metrics(metrics.Metrics())
        c = run_stream(_stream(qids), cpu,
                       EngineConfig(res=res, mode=mode, device="cpu"))
        assert launched > 0
        assert set(g.results) == set(c.results) == {*queries.QUERY_IDS,
                                                    "Q6#1"}
        for key in g.results:
            assert g.results[key].device.type == "cuda"
            assert results_equal(g.results[key], c.results[key]), key
        assert g.sim.decisions() == c.sim.decisions()
        assert (g.n_pushdown, g.n_pushback, g.real_net_bytes) == \
            (c.n_pushdown, c.n_pushback, c.real_net_bytes)


def test_hedged_chaos_stream_on_the_card(cuda, catalogs, fresh_metrics):
    """Faults with real sleeps and a 1 ms hedge delay: hedges fire, every
    race is counted once, and the results and split hold."""
    from repro_torch.core.faults import FaultPlan, HedgePolicy, RetryPolicy
    from repro_torch.core.runtime import run_stream
    from repro_torch.obs import metrics
    gpu, _ = catalogs
    qids = ["Q1", "Q3", "Q6", "Q12", "Q14"]
    clean = run_stream(_stream(qids), gpu,
                       EngineConfig(mode="adaptive", device=cuda),
                       time_scale=0)
    m = metrics.Metrics()
    metrics.set_metrics(m)
    run = run_stream(_stream(qids), gpu, EngineConfig(
        mode="adaptive", device=cuda,
        faults=FaultPlan.from_spec("crash:0.2,transient:0.2,"
                                   "straggler:0.5:0.005", seed=8),
        retry=RetryPolicy(sleep_scale=1.0),
        hedge=HedgePolicy(fixed_delay_s=0.001)), time_scale=0)
    c = m.snapshot()["counters"]
    assert c.get("hedge.launched", 0) > 0
    assert c.get("hedge.won", 0) + c.get("hedge.lost", 0) == \
        c["hedge.launched"]
    assert run.hedged == c.get("hedge.won", 0)
    assert run.n_pushdown + run.n_demoted == run.sim.admitted()
    for key in qids:
        assert results_equal(clean.results[key], run.results[key]), key


def test_hedge_samples_are_not_shorter_than_the_groups_device_time(
        cuda, catalogs, fresh_metrics, monkeypatch):
    """Each group also queues ~10 ms of device sleep, so its device time
    dwarfs its host time: a calibration sample read before the device was
    done would come out shorter than the group's CUDA-event time."""
    from repro_torch.core import runtime
    from repro_torch.core.faults import HedgePolicy
    gpu, _ = catalogs
    real = runtime._exec_group
    events = []

    def slow(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        out = real(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    class Spy(HedgePolicy):
        """Hedges nothing; keeps the stream's sample list."""
        samples = None

        def delay_s(self, samples):
            self.samples = samples
            return None

    monkeypatch.setattr(runtime, "_exec_group", slow)
    spy = Spy()
    runtime.run_stream(_stream(["Q1", "Q6", "Q14"]), gpu,
                       EngineConfig(mode="eager", device=cuda, hedge=spy),
                       time_scale=0)
    torch.cuda.synchronize()
    device_s = sorted(s.elapsed_time(e) / 1e3 for s, e in events)
    samples = sorted(spy.samples)
    assert len(samples) == len(device_s) > 0
    assert min(device_s) > 0.001
    assert all(h >= d for h, d in zip(samples, device_s)), (samples,
                                                           device_s)


def test_traced_card_run_holds_no_multi_element_tensor_in_its_spans(
        cuda, catalogs, fresh_metrics, tmp_path):
    """Spans of a traced stream and a costed query on the card hold host
    values only, and the trace exports."""
    from repro_torch import compiler
    from repro_torch.core.runtime import run_stream
    from repro_torch.obs import export, trace
    gpu, _ = catalogs
    with trace.tracing() as tr:
        run_stream(_stream([*queries.QUERY_IDS, "Q6"]), gpu, EngineConfig(
            res=StorageResources(storage_power=0.1), mode="adaptive",
            device=cuda))
        cq = compiler.compile_query_costed("q19", gpu)
        run_query(cq.query, gpu, EngineConfig(mode="adaptive", device=cuda))
    assert tr.find("storage_execute") and tr.find("compute_replay")
    bad = [(s.name, p) for s in tr.snapshot()
           for p in _multi_element_tensors(s.attrs)]
    assert not bad, bad
    export.to_chrome_trace(tr, tmp_path / "t.json")
    _, spans = export.from_jsonl(export.to_jsonl(tr, tmp_path / "t.jsonl"))
    assert len(spans) == len(tr.snapshot())


# ----------------------------------------------------------- process tier
def _worker_launches(pool):
    out = dict.fromkeys(kernels.WRAPPERS, 0)
    for snap in pool.publish_load().values():
        for n, c in (snap or {}).get("launches", {}).items():
            out[n] += c
    return out


def test_process_tier_on_the_card_matches_in_process(cuda, catalogs,
                                                     fresh_metrics):
    """A 2-node pool of workers on the card: every query eager and Q1, Q6,
    Q18 adaptive at power 0.1 equal the in-process runs (rows, sums
    within SUM_RTOL; split and real bytes equal); the workers launch
    ``predicate_bitmap`` and ``fused_scan_agg`` themselves, and the
    parent's residuals ``grouped_agg``; after ``kill(0)`` node 0's groups
    demote and the result holds."""
    import os
    import time
    from repro_torch.core.faults import RetryPolicy
    from repro_torch.distributed.workers import WorkerPool
    gpu, _ = catalogs
    pool = WorkerPool(gpu, pd_slots=2)
    try:
        assert all(w["device"] == str(gpu.device) and w["pid"] != os.getpid()
                   for w in pool.workers.values())
        before = _worker_launches(pool)
        kernels.reset_launches()
        runs = [(q, "eager", 1.0) for q in queries.QUERY_IDS] + \
            [(q, "adaptive", 0.1) for q in ("Q1", "Q6", "Q18")]
        for qid, mode, power in runs:
            base = EngineConfig(res=StorageResources(storage_power=power),
                                mode=mode, device=cuda,
                                measured_feedback=False)
            ref = run_query(queries.build_query(qid), gpu, base)
            got = run_query(queries.build_query(qid), gpu,
                            dataclasses.replace(
                                base, worker_pool=pool,
                                retry=RetryPolicy(sleep_scale=0.0)))
            assert results_equal(ref.result, got.result, tol=SUM_RTOL), qid
            assert (got.n_admitted, got.n_pushed_back, got.real_net_bytes) \
                == (ref.n_admitted, ref.n_pushed_back, ref.real_net_bytes)
        parent = kernels.launches()
        inside = {n: c - before[n]
                  for n, c in _worker_launches(pool).items()}
        assert inside["predicate_bitmap"] > 0 and inside["fused_scan_agg"] > 0
        assert parent["grouped_agg"] > 0
        pool.kill(0)
        deadline = time.monotonic() + 10.0
        while pool.alive(0) and time.monotonic() < deadline:
            time.sleep(0.01)
        cfg = EngineConfig(mode="eager", device=cuda, measured_feedback=False)
        ref = run_query(queries.build_query("Q6"), gpu, cfg)
        got = run_query(queries.build_query("Q6"), gpu, dataclasses.replace(
            cfg, worker_pool=pool, retry=RetryPolicy(sleep_scale=0.0)))
        assert results_equal(ref.result, got.result, tol=SUM_RTOL)
        assert got.n_demoted == sum(1 for r in got.requests
                                    if r.part.node_id == 0) > 0
        assert pool.fault_counts()["crash"] > 0
    finally:
        pool.close()


def test_a_worker_that_cannot_use_cuda_fails_the_pool(cuda, catalogs):
    """Children spawned without a visible card cannot start: the pool
    raises their error rather than running them on the plain versions."""
    import os
    from repro_torch.distributed.workers import WorkerPool
    gpu, _ = catalogs
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        with pytest.raises(RuntimeError, match="could not start on cuda"):
            WorkerPool(gpu, pd_slots=1)
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


# ------------------------------------------------ the residual's tensor backend
@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_tensor_residual_on_the_card_matches_the_interpreter(cuda, catalogs,
                                                             qid):
    """Compiled once, observed, then cold and warm: the tensor backend's
    result on the card is the interpreter's there and the tensor
    backend's on the CPU, with no fallback and no warm miss."""
    gpu, cpu = catalogs
    q = queries.build_query(qid)
    cfg = EngineConfig(mode="eager", device=cuda)
    want = run_query(q, gpu, cfg).result
    tcfg = dataclasses.replace(cfg, residual="tensor")
    runs = [run_query(q, gpu, tcfg) for _ in range(3)]
    assert runs[0].residual_jit["observed"]
    for run in runs[1:]:
        assert run.residual_backend == "tensor"
        assert not run.residual_jit["fell_back"]
        assert list(run.result.cols) == list(want.cols)
        assert results_equal(want, run.result), qid
    assert runs[2].residual_jit["misses"] == 0
    qc = queries.build_query(qid)
    ccfg = EngineConfig(mode="eager", device="cpu", residual="tensor")
    c = [run_query(qc, cpu, ccfg) for _ in range(2)][-1]
    assert results_equal(c.result, runs[2].result), qid


def test_grouped_agg_launches_inside_a_warm_tensor_stage(cuda, catalogs):
    from repro_torch.compiler import ir, tensorize
    from repro_torch.core.arbitrator import PUSHDOWN
    from repro_torch.core.engine import plan_requests
    from repro_torch.core.runtime import execute_split
    gpu, _ = catalogs
    q = queries.build_query("Q1")
    reqs = plan_requests(q, gpu)
    merged = execute_split(reqs, {r.req_id: PUSHDOWN for r in reqs}).merged
    for _ in range(2):                     # observe, cold
        tensorize.execute(q.residual, merged)
    kernels.reset_launches()
    run = tensorize.execute(q.residual, merged)
    torch.cuda.synchronize()
    assert (run.jit_hits, run.jit_misses, run.fell_back) == (1, 0, False)
    # one launch a sum of the keyed merge: Q1's four and its partial counts
    (agg,) = [n for n in ir.walk(q.residual) if isinstance(n, ir.Aggregate)]
    assert kernels.launches()["grouped_agg"] == \
        sum(fn == "sum" for _, fn, _ in agg.aggs) == 5
    assert results_equal(run.table, q.compute(merged))


@pytest.mark.parametrize("R", (300_000, 2_000_000))
def test_lex_aggregate_at_one_group_a_row_matches_plain(cuda, R):
    """Keys over a domain past ``_AGG_DOM_CAP`` take the lexsort path, whose
    sums and counts run ``grouped_agg`` with G = the padded row count (the
    ``l2`` regime at 2^19 rows, ``range`` at 2^21): keys and counts
    bitwise, sums at rtol=1e-9 against the same stage on the CPU, whose
    ``grouped_agg`` is ``kernels.ref``'s."""
    from repro_torch.compiler import ir, tensorize
    from repro_torch.queryproc.table import ColumnTable
    rng = np.random.default_rng(R)
    cols = {"k": rng.integers(0, 1 << 40, R // 3)[rng.integers(0, R // 3, R)],
            "v": rng.uniform(0.0, 100.0, R)}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        res = ir.Aggregate(ir.Merged("t"), ("k",),
                           (("s", "sum", "v"), ("c", "count", ""),
                            ("m", "max", "v")))
        merged = {"t": ColumnTable.from_numpy(cols, dev)}
        for _ in range(2):                 # observe, then the program
            run = tensorize.execute(res, merged)
        assert not run.fell_back and run.jit_misses == 1
        assert tensorize.lowerings(res) == ([("lex",)], [])
        out[dev.type] = {c: v.cpu() for c, v in run.table.cols.items()}
    n = 1 << (R - 1).bit_length()
    assert ga.plan(n, n, torch.cuda.get_device_properties(
        cuda).multi_processor_count).regime == ("l2" if R < 1 << 19
                                                 else "range")
    g, c = out["cuda"], out["cpu"]
    for k in ("k", "c", "m"):
        assert torch.equal(g[k], c[k]), k
    assert torch.allclose(g["s"], c["s"], rtol=SUM_RTOL, atol=0)


# ------------------------------------------------- pipeline and models
MODEL_TOL = dict(rtol=2e-2, atol=2e-2)  # bf16 logits: the model tests'


@pytest.mark.parametrize("dp_ranks", [1, 3, 8, 9])
def test_pipeline_on_the_card_matches_the_cpu(cuda, dp_ranks):
    """The corpus filter and shuffle through ``fused_scan_shuffle`` on the
    card (register counters at up to 8 ranks, shared ones past 8): the
    batches, bit for bit, and ``stats()`` of the same pipeline on the CPU;
    one launch per partition drawn."""
    from repro_torch.data.pipeline import (CorpusQuery, PushdownDataPipeline,
                                           synth_corpus)
    corpus = synth_corpus(num_partitions=6, docs_per_part=1000, doc_len=64,
                          vocab=1000, hosts=2, seed=dp_ranks)
    q = CorpusQuery(min_quality=float(corpus[0].quality[3]),
                    domains=(1, 2, 4, 6), seq_len=64,
                    global_batch=4 * dp_ranks, accum=2, dp_ranks=dp_ranks)
    card = PushdownDataPipeline(corpus, q, device=cuda)
    cpu = PushdownDataPipeline(corpus, q, device="cpu")
    kernels.reset_launches()
    for _ in range(12):
        got = next(card)["tokens"]
        assert got.is_cuda
        assert torch.equal(got.cpu(), next(cpu)["tokens"])
    assert 1 <= fss.fused_scan_shuffle.launches <= 12
    assert card.stats() == cpu.stats()


def _reduced_pair(arch, device):
    """A reduced config's parameters drawn on ``device`` and a CPU copy
    made through the family's own module."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.params import tree_map_specs
    cfg = get_config(arch, reduced=True)
    model = api.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(0), device)
    cpu = type(model)(cfg, tree_map_specs(lambda t: t.cpu(), model.tree()))
    return cfg, model, cpu


ARCHS = ["olmo-1b", "qwen3-14b", "qwen1.5-4b", "deepseek-67b",
         "qwen2-moe-a2.7b", "llama4-scout-17b-a16e", "llava-next-mistral-7b",
         "mamba2-2.7b", "recurrentgemma-2b", "whisper-small"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_models_on_the_card_match_the_cpu(cuda, arch):
    """Forward logits and aux, the loss, and a decode step of the same
    parameters on the card and on the CPU."""
    from repro_torch.models import api
    cfg, model, cpu = _reduced_pair(arch, cuda)
    g = torch.Generator().manual_seed(1)
    # llama4: a 128-token ring prefix; recurrentgemma: a 64-token prefix,
    # a multiple of its 32-wide window (an aligned ring); mamba2: a
    # 63-token prefix, padded to two chunks
    S = 129 if cfg.attn_unit else 65 if cfg.family == "hybrid" else 64
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, S), generator=g,
                                     dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(
            (2, cfg.num_audio_frames, cfg.d_model),
            generator=g).to(torch.bfloat16)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((2, cfg.num_patches, cfg.patch_dim),
                                       generator=g).to(torch.bfloat16)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    lg, aux, _, _ = api.forward(model, cfg, on_card)
    lc, auxc, _, _ = api.forward(cpu, cfg, batch)
    assert lg.is_cuda
    assert torch.allclose(lg.cpu(), lc, **MODEL_TOL)
    assert torch.allclose(aux.cpu(), auxc, **MODEL_TOL)
    assert torch.allclose(api.loss_fn(model, cfg, on_card).cpu(),
                          api.loss_fn(cpu, cfg, batch), **MODEL_TOL)
    pre = dict(on_card, tokens=on_card["tokens"][:, :S - 1])
    pos = S - 1 + (cfg.num_patches if cfg.family == "vlm" else 0)
    _, cache = api.build_decode_cache(model, cfg, pre, pos + 8)
    dec, _ = api.decode_step(model, cfg, cache, pos,
                             on_card["tokens"][:, S - 1:])
    assert torch.allclose(dec[:, 0].cpu(), lc[:, -1], **MODEL_TOL)


@pytest.mark.parametrize("causal_skip", [False, True])
def test_blockwise_attention_on_the_card(cuda, causal_skip):
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    cfg = get_config("llama4-scout-17b-a16e", reduced=True)
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((1, 2048, n, 16), generator=g).to(torch.bfloat16)
               for n in (4, 2, 2))
    got = attention.blockwise_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                        cfg, causal_skip=causal_skip)
    assert torch.allclose(got.cpu().float(), attention.attention(
        q, k, v, cfg).float(), **MODEL_TOL)


def test_rglru_scan_at_4096_on_the_card(cuda):
    """The log-depth scan at recurrentgemma's prefill length on the card,
    held to the sequential recurrence in fp64."""
    from repro_torch.models.rglru import linear_scan
    g = torch.Generator().manual_seed(4)
    T = 4096
    a = torch.rand((2, T, 256), generator=g) * 0.2 + 0.8  # long memory
    b = torch.randn((2, T, 256), generator=g)
    got = linear_scan(a.to(cuda), b.to(cuda))
    assert got.is_cuda and got.dtype == torch.float32
    h = torch.zeros((2, 256), dtype=torch.float64)
    want = torch.empty((2, T, 256), dtype=torch.float64)
    for t in range(T):
        h = a[:, t].double() * h + b[:, t].double()
        want[:, t] = h
    assert torch.allclose(got.cpu().double(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_recurrent_serving_engine_on_the_card(cuda, arch):
    """Both prefill branches of the two recurrent families on the card,
    each wave's last logits against the CPU engine's."""
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    cfg, model, cpu = _reduced_pair(arch, cuda)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(20, 60, 6)]
    scfg = ServeConfig(max_batch=4, max_len=128, prefill_chunk=16)
    eng = ServingEngine(cfg, model, scfg)
    reqs = [Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    eng.serve(reqs)
    assert eng.chunked_prefills == 1
    assert all(len(r.out_tokens) == 8 for r in reqs)
    ref = ServingEngine(cfg, cpu, scfg)
    for wave in (prompts[:4], prompts[4:]):
        P = max(len(p) for p in wave)
        toks = torch.zeros((len(wave), P), dtype=torch.int32)
        for b, p in enumerate(wave):
            toks[b, P - len(p):] = torch.from_numpy(p)
        got, _ = eng._prefill(toks.to(cuda), len(wave))
        want, _ = ref._prefill(toks, len(wave))
        assert torch.allclose(got.cpu(), want, **MODEL_TOL)


def test_serving_engine_on_the_card(cuda):
    """Both prefill branches on the card: each wave's last logits against
    the CPU engine's, and every request its budget."""
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    cfg, model, cpu = _reduced_pair("olmo-1b", cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(20, 60, 6)]
    scfg = ServeConfig(max_batch=4, max_len=128, prefill_chunk=16)
    eng = ServingEngine(cfg, model, scfg)
    reqs = [Request(rid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    eng.serve(reqs)
    assert eng.chunked_prefills == 1
    assert all(len(r.out_tokens) == 8 for r in reqs)
    ref = ServingEngine(cfg, cpu, scfg)
    for wave in (prompts[:4], prompts[4:]):
        P = max(len(p) for p in wave)
        toks = torch.zeros((len(wave), P), dtype=torch.int32)
        for b, p in enumerate(wave):
            toks[b, P - len(p):] = torch.from_numpy(p)
        got, _ = eng._prefill(toks.to(cuda), len(wave))
        want, _ = ref._prefill(toks, len(wave))
        assert torch.allclose(got.cpu(), want, **MODEL_TOL)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_train_step_on_the_card_matches_the_cpu(cuda, remat):
    """One ``make_host_train_step`` (accum 2, with each ``remat``) on
    reduced olmo-1b on the card and on the CPU (no remat) from the same
    parameters and batch: the loss,
    ``grad_norm`` and ``lr`` within the models' tolerance, every updated
    parameter within bf16 tolerance (rtol = atol = 2e-2), ``step`` equal.
    Then the trained module serves under ``inference_mode``."""
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.loop import make_host_train_step
    cfg, model, cpu = _reduced_pair("olmo-1b", cuda)
    g = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4, 64),
                                     generator=g, dtype=torch.int32)}
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step = make_host_train_step(cfg, ocfg, remat=remat)
    model, opt, st = step(model, opt_lib.init(model),
                          {"tokens": batch["tokens"].to(cuda)})
    cpu, copt, cst = make_host_train_step(cfg, ocfg)(cpu, opt_lib.init(cpu),
                                                     batch)
    for k in ("loss", "grad_norm", "lr"):
        assert st[k].is_cuda
        assert torch.allclose(st[k].cpu(), cst[k], **MODEL_TOL), k
    got, want = _flatten((model, opt)), _flatten((cpu, copt))
    assert list(got) == list(want)
    for k in want:
        assert got[k].is_cuda and got[k].dtype == want[k].dtype, k
        if want[k].is_floating_point():
            assert torch.allclose(got[k].cpu().float(), want[k].float(),
                                  **MODEL_TOL), k
        else:
            assert torch.equal(got[k].cpu(), want[k]), k
    assert not any(p.requires_grad for p in model.parameters())
    eng = ServingEngine(cfg, model, ServeConfig(max_len=64))
    with torch.inference_mode():
        out = eng.generate([np.arange(1, 17, dtype=np.int32)], max_new=4)
        logits, _ = api.prefill(model, cfg, {"tokens": batch["tokens"][0].to(
            cuda)})
    assert len(out[0]) == 4 and logits.grad_fn is None
