"""The port's §4.2 operators (selection bitmap, distributed shuffle) against
the JAX package's, on the CPU.

The catalog is ``tests/test_torch_engine.py``'s: sf=0.5 over 2 nodes with
2,000-row lineitem partitions and 937-row orders partitions, so no
partition after the first starts on a 32-row boundary and every packed
word of a partition is cut out of the batch's words by a shift. Words,
partition ids, row orders and dtypes must match the reference bitwise;
byte accounting, decision vectors and ``ShuffleRun`` fields exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.core import bitmap as rbitmap
from repro.core import runtime as rruntime
from repro.core import shuffle as rshuffle
from repro.core.cost import StorageResources as RResources
from repro.core.executor import compile_push_plan as r_compile
from repro.core.plan import PushPlan as RPushPlan
from repro.queryproc import expressions as rex
from repro.queryproc import operators as rops
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnTable as RTable
from repro_torch.core import bitmap, runtime, shuffle
from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN
from repro_torch.core.cost import StorageResources
from repro_torch.core.engine import EngineConfig, plan_requests, run_query
from repro_torch.core.executor import (compile_push_plan, partition_words,
                                       unpack_parts)
from repro_torch.core.plan import PushPlan
from repro_torch.queryproc import expressions as tex
from repro_torch.queryproc import operators as tops
from repro_torch.queryproc import queries
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays

SF, SEED, NODES, RPP = 0.5, 0, 2, 2000
BITMAP_QUERIES = ("Q3", "Q6", "Q12", "Q19")
SHUFFLE_QUERIES = ("Q3", "Q12", "Q19")


@pytest.fixture(scope="module")
def ref_catalog():
    return rtpch.build_catalog(SF, SEED, NODES, RPP)


@pytest.fixture(scope="module")
def catalog():
    return catalog_from_arrays(
        {n: t.cols for n, t in rtpch.generate_tables(SF, SEED).items()},
        NODES, RPP, device="cpu")


def _words(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32))


def _assert_words(got: torch.Tensor, want: np.ndarray, ctx=""):
    assert got.dtype == torch.int32, ctx
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want,
                                  err_msg=str(ctx))


def _assert_identical(got: ColumnTable, want: RTable, ctx=""):
    """Same columns in the same order, dtypes and values, bitwise."""
    assert list(got.cols) == list(want.cols), (ctx, list(got.cols),
                                               list(want.cols))
    for c, v in want.cols.items():
        g = got.cols[c].numpy()
        assert g.dtype == v.dtype, (ctx, c, g.dtype, v.dtype)
        assert np.array_equal(g, v, equal_nan=True), (ctx, c)


def _parts(cat, table):
    return [p.data for p in cat.partitions_of(table)]


def _fig3_request(qid, E):
    """``benchmarks/bitmap_storage.py``'s ``bitmap_plan`` columns and its
    ``_cache_outputs_only`` cache: (predicate, uncached, cached)."""
    plan = (queries.build_query(qid) if E is tex
            else rqueries.build_query_legacy(qid)).plans["lineitem"]
    derived = {n for n, _, _ in plan.derive}
    cols = [c for c in plan.accessed_columns() if c not in derived]
    base_out = {c for c in plan.columns if c not in derived}
    for _, incols, _ in plan.derive:
        base_out |= set(incols)
    cached = base_out - E.columns_of(plan.predicate)
    return (plan.predicate, [c for c in cols if c not in cached],
            [c for c in cols if c in cached])


# ------------------------------------------------- word cutting and joining
@pytest.mark.parametrize("seed", range(6))
def test_partition_words_and_unpack_parts_match_per_partition_packing(seed):
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(0, 100, 7)]
    lens[rng.integers(7)] = 0
    if seed % 2:
        lens = [32 * (n // 32) for n in lens[:-1]] + lens[-1:]  # aligned
    mask = rng.random(sum(lens)) < 0.5
    splits = np.split(mask, np.cumsum(lens)[:-1])
    got = partition_words(tops.pack_bitmap(torch.from_numpy(mask)), lens)
    assert len(got) == len(lens)
    for g, m in zip(got, splits):
        _assert_words(g, rops.pack_bitmap(m), (seed, lens))
    want = [_words(rops.pack_bitmap(m)) for m in splits]
    np.testing.assert_array_equal(unpack_parts(want, lens).numpy(), mask)


# --------------------------------------------------------- selection bitmap
@pytest.mark.parametrize("qid", BITMAP_QUERIES)
def test_storage_side_bitmap_batched_matches_reference(qid, catalog,
                                                       ref_catalog):
    pred, uncached, _ = _fig3_request(qid, tex)
    rpred, runcached, _ = _fig3_request(qid, rex)
    assert uncached == runcached
    words, tabs = bitmap.storage_side_bitmap_batched(
        _parts(catalog, "lineitem"), pred, uncached)
    rwords, rtabs = rbitmap.storage_side_bitmap_batched(
        _parts(ref_catalog, "lineitem"), rpred, runcached)
    assert len(words) == len(rwords) > 1
    for p, (w, rw, t, rt) in enumerate(zip(words, rwords, tabs, rtabs)):
        _assert_words(w, rw, (qid, p))
        _assert_identical(t, rt, (qid, p))
    # the per-partition plain form is the same
    w0, t0 = bitmap.storage_side_bitmap(_parts(catalog, "lineitem")[1], pred,
                                        uncached)
    _assert_words(w0, rwords[1], qid)
    _assert_identical(t0, rtabs[1], qid)


@pytest.mark.parametrize("qid", BITMAP_QUERIES)
def test_fig3_compute_half_applies_words_to_the_cache(qid, catalog,
                                                      ref_catalog):
    """``bitmap_apply`` over the cached columns, compacted, equals the
    reference's filter of each partition, and counts its rows."""
    pred, uncached, cached = _fig3_request(qid, tex)
    parts = _parts(catalog, "lineitem")
    words, _ = bitmap.storage_side_bitmap_batched(parts, pred, uncached)
    masked, counts = bitmap.apply_bitmap_to_cache(
        [p.select(cached) for p in parts], words)
    rpred = _fig3_request(qid, rex)[0]
    for p, (m, part, rpart) in enumerate(zip(masked, parts,
                                             _parts(ref_catalog, "lineitem"))):
        want = rops.filter_table(rpart, rpred).select(cached)
        assert int(counts[p]) == len(want)
        keep = tops.unpack_bitmap(words[p], len(part))
        _assert_identical(m.filter(keep), want, (qid, p))
        for c in cached:
            assert m.cols[c].shape == part.cols[c].shape
            assert not m.cols[c][~keep].any()


def test_fig3_compute_half_on_mixed_column_types(catalog, ref_catalog):
    """One ``apply_bitmap_to_cache`` over int32, int64, f32 and f64 cached
    columns of every partition (the wrapper's segments mix 4- and 8-byte
    values) equals the reference's filter, and counts each partition
    once."""
    pred, uncached, _ = _fig3_request("Q19", tex)
    rpred = _fig3_request("Q19", rex)[0]
    parts = _parts(catalog, "lineitem")
    words, _ = bitmap.storage_side_bitmap_batched(parts, pred, uncached)
    casts = {"l_orderkey": torch.int32, "l_partkey": torch.int64,
             "l_discount": torch.float32, "l_extendedprice": torch.float64}
    cached = [ColumnTable({c: p.cols[c].to(dt) for c, dt in casts.items()})
              for p in parts]
    masked, counts = bitmap.apply_bitmap_to_cache(cached, words)
    assert counts.dtype == torch.int64 and counts.shape == (len(parts),)
    for p, (m, rpart) in enumerate(zip(masked,
                                       _parts(ref_catalog, "lineitem"))):
        want = rops.filter_table(rpart, rpred)
        assert int(counts[p]) == len(want)
        keep = tops.unpack_bitmap(words[p], len(parts[p]))
        assert list(m.cols) == list(casts)
        for c, dt in casts.items():
            assert m.cols[c].dtype == dt
            np.testing.assert_array_equal(
                m.cols[c][keep].numpy(),
                want.cols[c].astype(m.cols[c].numpy().dtype))
            assert not m.cols[c][~keep].any()


def test_q1_pushed_aggregate_matches_reference(catalog, ref_catalog):
    """Q1's partial aggregate (four sums and a count: one fused_scan_agg
    call per batch) through ``run_query`` at full pushdown and at a
    pushdown/pushback split: result, decisions and real bytes as the
    reference's."""
    for mode, power in (("eager", 1.0), ("adaptive", 0.1)):
        want = reng.run_query(rqueries.build_query_legacy("Q1"), ref_catalog,
                              reng.EngineConfig(
                                  res=RResources(storage_power=power),
                                  mode=mode, measured_feedback=False))
        got = run_query(queries.build_query("Q1"), catalog, EngineConfig(
            res=StorageResources(storage_power=power), mode=mode,
            device="cpu"))
        assert reng.results_equal(RTable(got.result.to_numpy()), want.result)
        assert got.sim.decisions() == want.sim.decisions()
        assert got.real_net_bytes == want.real_net_bytes


@pytest.mark.parametrize("table,qid", [("lineitem", "Q19"), ("lineitem", "Q12"),
                                       ("orders", "Q3")])
def test_compute_side_apply_batched_matches_reference(table, qid, catalog,
                                                      ref_catalog):
    plan = rqueries.build_query_legacy(qid).plans[table]
    pred_cols = rex.columns_of(plan.predicate)
    derived = {n for n, _, _ in plan.derive}
    out_cols = tuple(c for c in plan.accessed_columns()
                     if c not in derived and c not in pred_cols)
    rparts = _parts(ref_catalog, table)
    rwords = [rops.selection_bitmap(p, plan.predicate) for p in rparts]
    tpred = queries.build_query(qid).plans[table].predicate
    words = [tops.selection_bitmap(p, tpred) for p in _parts(catalog, table)]
    for w, rw in zip(words, rwords):
        _assert_words(w, rw, qid)
    got = bitmap.compute_side_apply_batched(_parts(catalog, table), words,
                                            out_cols, table)
    want = rbitmap.compute_side_apply_batched(rparts, rwords, out_cols, table)
    for p, (g, w) in enumerate(zip(got, want)):
        _assert_identical(g, w, (qid, p))


def test_combine_bitmaps_and_merged_verdicts(catalog, ref_catalog):
    C, R = tex.Col, rex.Col
    tparts, rparts = _parts(catalog, "lineitem"), _parts(ref_catalog,
                                                         "lineitem")
    a = (C("l_quantity") <= 30) & (C("l_discount") > 0.02)
    ra = (R("l_quantity") <= 30) & (R("l_discount") > 0.02)
    comp, stor = bitmap.split_predicate(
        a & C("l_shipmode").isin((0, 1, 2)), {"l_quantity", "l_discount"})
    rcomp, rstor = rbitmap.split_predicate(
        ra & R("l_shipmode").isin((0, 1, 2)), {"l_quantity", "l_discount"})
    tw = [tops.selection_bitmap(p, comp) for p in tparts]
    rw = [rops.selection_bitmap(p, rcomp) for p in rparts]
    for p, (tp, rp) in enumerate(zip(tparts, rparts)):
        both = bitmap.combine_bitmaps(tw[p], tops.selection_bitmap(tp, stor))
        _assert_words(both, rbitmap.combine_bitmaps(
            rw[p], rops.selection_bitmap(rp, rstor)), p)
    # a shorter word vector is zero-padded
    _assert_words(bitmap.combine_bitmaps(tw[0], tw[0][:3]),
                  rbitmap.combine_bitmaps(rw[0], rw[0][:3]))
    rows = [len(p) for p in tparts]
    np.testing.assert_array_equal(bitmap.merged_verdicts(tw, rows).numpy(),
                                  rbitmap.merged_verdicts(rw, rows))


CACHES = ("outputs", "predicates")


def _cache(kind, qid, module, E):
    plan = (queries.build_query(qid) if module is bitmap
            else rqueries.build_query_legacy(qid)).plans["lineitem"]
    cache = module.CacheState()
    if kind == "predicates":
        cache.cache_columns("lineitem", E.columns_of(plan.predicate))
    else:
        cache.cache_columns("lineitem", _fig3_request(qid, E)[2])
    return cache


@pytest.mark.parametrize("kind", CACHES)
@pytest.mark.parametrize("qid", BITMAP_QUERIES)
def test_rewrite_all_matches_reference(qid, kind, catalog, ref_catalog):
    reqs = plan_requests(queries.build_query(qid), catalog)
    rreqs = reng.plan_requests(rqueries.build_query_legacy(qid), ref_catalog)
    got, met = bitmap.rewrite_all(reqs, _cache(kind, qid, bitmap, tex))
    want, rmet = rbitmap.rewrite_all(rreqs, _cache(kind, qid, rbitmap, rex))
    assert met == rmet
    assert [dataclasses.astuple(r.cost) for r in got] == \
        [dataclasses.astuple(r.cost) for r in want]
    if qid != "Q6":  # Q6 ships one aggregate row either way
        assert met["net_bitmap"] != met["net_baseline"]


@pytest.mark.parametrize("kind", CACHES)
@pytest.mark.parametrize("qid", SHUFFLE_QUERIES)
def test_run_query_with_rewritten_requests_matches_reference(
        qid, kind, catalog, ref_catalog):
    rq = rqueries.build_query_legacy(qid)
    rreqs, _ = rbitmap.rewrite_all(reng.plan_requests(rq, ref_catalog),
                                   _cache(kind, qid, rbitmap, rex))
    want = reng.run_query(rq, ref_catalog, reng.EngineConfig(
        res=RResources(storage_power=1.0), mode="eager",
        measured_feedback=False), requests=rreqs)
    tq = queries.build_query(qid)
    reqs, _ = bitmap.rewrite_all(plan_requests(tq, catalog),
                                 _cache(kind, qid, bitmap, tex))
    got = run_query(tq, catalog, EngineConfig(mode="eager", device="cpu"),
                    requests=reqs)
    assert reng.results_equal(RTable(got.result.to_numpy()), want.result)
    assert got.sim.decisions() == want.sim.decisions()
    assert got.net_bytes == want.net_bytes
    assert got.real_net_bytes == want.real_net_bytes


def test_execute_split_bytes_with_bitmaps(catalog, ref_catalog):
    """A split whose requests carry words (Fig 4) and one whose results
    ship their bitmap (Fig 3), over a mixed decision vector."""
    out_cols = ("l_orderkey", "l_extendedprice")
    C, R = tex.Col, rex.Col
    for tplan_kw, rplan_kw in (
            (dict(apply_bitmap=True), dict(apply_bitmap=True)),
            (dict(predicate=C("l_quantity") <= 25, bitmap_only=True),
             dict(predicate=R("l_quantity") <= 25, bitmap_only=True))):
        tplan = PushPlan("lineitem", out_cols, **tplan_kw)
        rplan = RPushPlan("lineitem", out_cols, **rplan_kw)
        treqs = plan_requests(queries.Query("BM", {"lineitem": tplan}, None),
                              catalog)
        rreqs = reng.plan_requests(
            rqueries.Query("BM", {"lineitem": rplan}, None), ref_catalog)
        rng = np.random.default_rng(0)
        decisions = {r.req_id: PUSHBACK if rng.random() < 0.4 else PUSHDOWN
                     for r in treqs}
        rbms = tbms = None
        if tplan.apply_bitmap:
            pred = R("l_shipmode").isin((0, 3))
            rbms = {r.req_id: rops.selection_bitmap(r.part.data, pred)
                    for r in rreqs}
            tbms = {i: _words(w) for i, w in rbms.items()}
        got = runtime.execute_split(treqs, decisions, tbms)
        want = rruntime.execute_split(rreqs, decisions, bitmaps=rbms)
        assert (got.pushdown_bytes, got.pushback_bytes) == \
            (want.pushdown_bytes, want.pushback_bytes)
        assert [(o.path, o.rows_out, o.shipped_bytes) for o in got.outcomes] \
            == [(o.path, o.rows_out, o.shipped_bytes) for o in want.outcomes]
        _assert_identical(got.merged["lineitem"], want.merged["lineitem"])


# --------------------------------------------------------------- shuffle
@pytest.mark.parametrize("table,key", [("lineitem", "l_orderkey"),
                                       ("orders", "o_custkey")])
def test_shuffle_at_storage_batched_matches_reference(table, key, catalog,
                                                      ref_catalog):
    got = shuffle.shuffle_at_storage_batched(catalog, table, key, 4)
    want = rshuffle.shuffle_at_storage_batched(ref_catalog, table, key, 4)
    plain = shuffle.shuffle_at_storage(catalog, table, key, 4)
    at_compute = shuffle.shuffle_at_compute(catalog, table, key, 4)
    assert sum(len(t) for t in got) == sum(len(p.data) for p in
                                           catalog.partitions_of(table))
    for t, (g, w, p, c) in enumerate(zip(got, want, plain, at_compute)):
        _assert_identical(g, w, (table, t))
        _assert_identical(p, w, (table, t))
        assert reng.results_equal(RTable(c.to_numpy()), w)
        assert bool((tops.hash_partition_ids(g.cols[key], 4) == t).all())


def _shuffle_plan(q, table, n):
    """``benchmarks/shuffle.py``'s ``_shuffle_plan``."""
    plan, key = q.plans[table], q.shuffle_keys[table]
    if plan.agg is not None:
        return None if key not in plan.agg[0] else \
            dataclasses.replace(plan, shuffle=(key, n))
    cols = plan.columns if key in plan.columns else tuple(plan.columns) + (key,)
    return dataclasses.replace(plan, columns=cols, shuffle=(key, n))


@pytest.mark.parametrize("qid", SHUFFLE_QUERIES)
def test_query_shuffle_plans_match_reference(qid, catalog, ref_catalog):
    """Filtered plans take ``fused_scan_shuffle``'s path, unfiltered ones
    ``hash_partition``'s: results, slices and position vectors bitwise."""
    tq, rq = queries.build_query(qid), rqueries.build_query_legacy(qid)
    assert tq.shuffle_keys == rq.shuffle_keys
    for table in tq.shuffle_keys:
        plan, rplan = _shuffle_plan(tq, table, 4), _shuffle_plan(rq, table, 4)
        tabs, aux = compile_push_plan(plan).execute_batch_parts(
            _parts(catalog, table))
        rtabs, raux = r_compile(rplan).execute_batch_parts(
            _parts(ref_catalog, table))
        for p, (t, a, rt, ra) in enumerate(zip(tabs, aux, rtabs, raux)):
            ctx = (qid, table, p)
            _assert_identical(t, rt, ctx)
            pv = a["position_vector"]
            assert pv.dtype == torch.int32
            np.testing.assert_array_equal(pv.numpy(), ra["position_vector"])
            for s, rs in zip(a["shuffle_parts"], ra["shuffle_parts"]):
                _assert_identical(s, rs, ctx)
            want = tops.shuffle_partition(t, tq.shuffle_keys[table], 4)
            for s, w in zip(a["shuffle_parts"], want):
                for c in w.cols:
                    assert torch.equal(s.cols[c], w.cols[c])


def _keyed_table(seed, n_rows, dtype):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    k = rng.integers(info.min, info.max, n_rows, dtype=dtype)
    k[: min(n_rows, 6)] = np.asarray([-1, -2, 0, 1, -(2 ** 31), 2 ** 31 - 1],
                                     dtype)[: min(n_rows, 6)]
    return {"k": k, "v": rng.normal(size=n_rows)}


@pytest.mark.parametrize("dtype", (np.int32, np.int64))
@pytest.mark.parametrize("n_targets", (1, 4, 7))
@pytest.mark.parametrize("seed", range(3))
def test_apply_position_vector_matches_reference(seed, n_targets, dtype):
    cols = _keyed_table(seed, 500 + 37 * seed, dtype)
    t, rt = ColumnTable.from_numpy(cols, "cpu"), RTable(cols)
    pv = tops.position_vector(t, "k", n_targets)
    rpv = rops.position_vector(rt, "k", n_targets)
    assert pv.dtype == torch.int32
    np.testing.assert_array_equal(pv.numpy(), rpv)
    got = shuffle.apply_position_vector(t, pv, n_targets)
    want = rshuffle.apply_position_vector(rt, rpv, n_targets)
    plain = tops.shuffle_partition(t, "k", n_targets)
    assert sum(len(g) for g in got) == len(t)
    for g, w, p in zip(got, want, plain):
        _assert_identical(g, w, seed)
        _assert_identical(p, w, seed)


@pytest.mark.parametrize("pushdown", (False, True))
@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_run_shuffle_matches_reference(qid, pushdown, catalog, ref_catalog):
    got = shuffle.run_shuffle(queries.build_query(qid), catalog,
                              EngineConfig(mode="eager", device="cpu"),
                              shuffle.ShuffleConfig(), pushdown)
    want = rshuffle.run_shuffle(
        rqueries.build_query_legacy(qid), ref_catalog,
        reng.EngineConfig(mode="eager", measured_feedback=False),
        rshuffle.ShuffleConfig(), pushdown)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
