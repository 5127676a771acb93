"""The port's compiler against the JAX package's, on the CPU.

For all fifteen TPC-H queries ``repro_torch.compiler`` must give
``repro.compiler``'s frontier (each table's plan, its candidate cuts,
shuffle keys and batchable stages), residual shape and amenability report,
and ``compile_and_run`` must give ``repro.core.engine.compile_and_run``'s
result (``results_equal``), decision vector, simulated and real bytes in
every mode at storage_power 1.0 and 0.1 and under the ``fact_selectivity``
knob. The plans only the compiler emits run in the port's executor and
equal the reference executor's per partition: a HAVING frontier on a
catalog clustered by ``l_orderkey`` (Q18), an absorbed ``TopK`` and pushed
min/max aggregates; keys, counts and rows bitwise, f64 sums at rtol=1e-12.
Same catalog as ``test_torch_engine.py``: sf=0.5, seed 0, 2 nodes, 2000
rows a lineitem partition.
"""
import numpy as np
import pytest
import torch

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.compiler import analyzer as ranalyzer
from repro.compiler import compile as rcompile
from repro.compiler import ir as rir
from repro.compiler import splitter as rsplitter
from repro.core.cost import StorageResources as RResources
from repro.core.executor import compile_push_plan as r_compile_push_plan
from repro.core.plan import execute_push_plan
from repro.queryproc import tpch as rtpch
from repro.queryproc.expressions import Col as RCol
from repro.queryproc.table import ColumnTable as RTable
from repro_torch import compiler
from repro_torch.compiler import analyzer, ir, splitter
from repro_torch.core import engine
from repro_torch.core.cost import StorageResources
from repro_torch.core.executor import compile_push_plan
from repro_torch.core.plan import batchable_stages, plan_signature
from repro_torch.queryproc.expressions import Col
from repro_torch.storage.catalog import catalog_from_arrays

SF, SEED, NODES, RPP = 0.5, 0, 2, 2000
POWERS = (1.0, 0.1)
CLUSTER = {"lineitem": "l_orderkey"}
LINEITEM_QUERIES = [q for q in compiler.QUERY_IDS if q != "Q22"]


@pytest.fixture(scope="module")
def arrays():
    return {n: t.cols for n, t in rtpch.generate_tables(SF, SEED).items()}


@pytest.fixture(scope="module")
def ref_catalog():
    return rtpch.build_catalog(SF, SEED, NODES, RPP)


@pytest.fixture(scope="module")
def catalog(arrays):
    return catalog_from_arrays(arrays, NODES, RPP, device="cpu")


@pytest.fixture(scope="module")
def clustered(arrays):
    return (catalog_from_arrays(arrays, NODES, RPP, device="cpu",
                                cluster=CLUSTER),
            rtpch.build_catalog(SF, SEED, NODES, RPP, cluster=CLUSTER))


def _plan_fields(plan):
    """Everything a PushPlan decides, comparable across the packages
    (predicates by repr: both packages' Expr dataclasses print alike)."""
    return (plan.table, plan.columns, repr(plan.predicate),
            tuple((n, tuple(i)) for n, i, _ in plan.derive), plan.agg,
            plan.top_k, plan.shuffle, plan.bitmap_only, plan.apply_bitmap,
            repr(plan.having), plan.accessed_columns())


@pytest.mark.parametrize("qid", compiler.QUERY_IDS)
def test_compiled_frontier_and_residual_match_the_reference(qid):
    got = compiler.compile_query_detailed(qid)
    want = rcompile.compile_query_detailed(qid)
    assert got.qid == want.qid
    assert set(got.plans) == set(want.plans)
    for table, plan in got.plans.items():
        rplan = want.plans[table]
        assert _plan_fields(plan) == _plan_fields(rplan), table
        key = got.query.shuffle_keys.get(table)
        assert plan_signature(plan, key) == \
            want.frontier_signature(with_shuffle=True)[table]
        assert batchable_stages(plan, key) == want.batchable[table]
    assert got.query.shuffle_keys == want.query.shuffle_keys
    assert got.batchable == want.batchable
    assert got.frontier_signature() == want.frontier_signature()
    assert got.frontier_size() == want.frontier_size()
    assert ir.describe(got.residual) == rir.describe(want.residual)
    assert ir.op_counts(got.residual) == rir.op_counts(want.residual)
    assert got.query.residual is got.residual
    assert analyzer.report(got.root) == ranalyzer.report(want.root)
    assert [(type(n).__name__, a.pushable, a.partial)
            for n, a in got.amenability] == \
        [(type(n).__name__, a.pushable, a.partial)
         for n, a in want.amenability]


@pytest.mark.parametrize("clustered_by", ({}, CLUSTER))
@pytest.mark.parametrize("qid", compiler.QUERY_IDS)
def test_every_candidate_cut_matches_the_reference(qid, clustered_by):
    """The splitter's enumeration of cut points per table, and the
    residual of every forced shallow cut, on an unclustered and a
    clustered catalog's cluster keys."""
    root, rroot = (compiler.compile_query_detailed(qid).root,
                   rcompile.compile_query_detailed(qid).root)
    sp = splitter.split(root, clustered=clustered_by)
    rsp = rsplitter.split(rroot, clustered=clustered_by)
    assert sp.max_cut == rsp.max_cut and sp.cuts == rsp.cuts
    for table, cands in sp.candidates.items():
        assert [_plan_fields(p) for p in cands] == \
            [_plan_fields(p) for p in rsp.candidates[table]], table
        for k in range(len(cands)):
            got = compiler.compile_ir(root, qid, cuts={table: k},
                                      clustered=clustered_by)
            want = rcompile.compile_ir(rroot, qid, cuts={table: k},
                                       clustered=clustered_by)
            assert ir.describe(got.residual) == rir.describe(want.residual)
            assert _plan_fields(got.plans[table]) == \
                _plan_fields(want.plans[table])


@pytest.mark.parametrize("qid", compiler.QUERY_IDS)
def test_bitmap_tables_lower_as_the_reference(qid, catalog, ref_catalog):
    """``bitmap_tables`` lowers each listed table's filter-only plan to
    ``bitmap_only`` (the §4.2 exchange) as the reference's splitter does,
    and the lowered query runs to the reference's result, decisions and
    bytes (which count the shipped words) in every mode."""
    root, rroot = (compiler.compile_query_detailed(qid).root,
                   rcompile.compile_query_detailed(qid).root)
    tables = frozenset(ir.base_tables(root))
    got = compiler.compile_ir(root, qid, bitmap_tables=tables)
    want = rcompile.compile_ir(rroot, qid, bitmap_tables=tables)
    assert [_plan_fields(got.plans[t]) for t in sorted(got.plans)] == \
        [_plan_fields(want.plans[t]) for t in sorted(want.plans)]
    for plan in got.plans.values():
        assert plan.bitmap_only == (plan.predicate is not None
                                    and plan.agg is None
                                    and plan.top_k is None)
    assert ir.describe(got.residual) == rir.describe(want.residual)
    for mode in engine.MODES:
        run = engine.run_query(got.query, catalog,
                               engine.EngineConfig(mode=mode, device="cpu"))
        rrun = reng.run_query(want.query, ref_catalog, reng.EngineConfig(
            mode=mode, measured_feedback=False))
        _check_run(run, rrun)


def _check_run(got, want, only=None):
    """Result, decisions and bytes as the reference's; with ``only`` the
    result is compared on that column's values alone (rows tied on it may
    be chosen differently)."""
    if only is None:
        assert reng.results_equal(RTable(got.result.to_numpy()),
                                  want.result)
    else:
        assert np.array_equal(np.sort(got.result.cols[only].numpy()),
                              np.sort(want.result.cols[only]))
    assert got.sim.decisions() == want.sim.decisions()
    assert (got.n_admitted, got.n_pushed_back) == \
        (want.n_admitted, want.n_pushed_back)
    assert got.net_bytes == want.net_bytes
    assert got.real_net_bytes == want.real_net_bytes


@pytest.mark.parametrize("power", POWERS)
@pytest.mark.parametrize("mode", engine.MODES)
@pytest.mark.parametrize("qid", compiler.QUERY_IDS)
def test_compile_and_run_matches_the_reference(qid, mode, power, catalog,
                                               ref_catalog):
    got = engine.compile_and_run(
        qid, catalog, engine.EngineConfig(
            res=StorageResources(storage_power=power), mode=mode,
            device="cpu"))
    want = reng.compile_and_run(
        qid, ref_catalog, reng.EngineConfig(
            res=RResources(storage_power=power), mode=mode,
            measured_feedback=False))
    _check_run(got, want)


@pytest.mark.parametrize("sel", (0.02, 0.5, 1.0))
@pytest.mark.parametrize("qid", LINEITEM_QUERIES)
def test_fact_selectivity_matches_the_reference(qid, sel, catalog,
                                                ref_catalog):
    got = engine.compile_and_run(qid, catalog,
                                 engine.EngineConfig(device="cpu"),
                                 fact_selectivity=sel)
    want = reng.compile_and_run(qid, ref_catalog,
                                reng.EngineConfig(measured_feedback=False),
                                fact_selectivity=sel)
    _check_run(got, want)
    plan = compiler.compile_query(qid, sel).plans["lineitem"]
    assert repr(plan.predicate) == repr(
        rcompile.compile_query(qid, sel).plans["lineitem"].predicate)


def test_an_empty_fact_table_runs_every_query(catalog):
    """``fact_selectivity=0`` keeps no lineitem row anywhere; every query
    still runs (the merged tables keep their schema)."""
    for qid in LINEITEM_QUERIES:
        run = engine.compile_and_run(qid, catalog,
                                     engine.EngineConfig(device="cpu"),
                                     fact_selectivity=0.0)
        assert run.result.columns


def test_cost_based_compilation_is_not_silently_maximal(catalog):
    """``cost_based=True`` runs the cost-based chooser's frontier: Q18's
    lineitem is cut at the scan, below its high-NDV partial aggregate,
    where the maximal frontier pushes the aggregate."""
    run = engine.compile_and_run("Q18", catalog,
                                 engine.EngineConfig(device="cpu"),
                                 cost_based=True)
    costed = compiler.compile_query_costed("Q18", catalog)
    assert {r.table: r.plan for r in run.requests} == costed.plans
    assert costed.frontier_signature()["lineitem"] == "scan"
    assert compiler.compile_query_detailed(
        "Q18").frontier_signature()["lineitem"] == "scan+agg"


def test_clustered_partitions_match_the_reference(clustered):
    cat, rcat = clustered
    assert cat.clustered == rcat.clustered == CLUSTER
    for table, rparts in rcat.tables.items():
        parts = cat.partitions_of(table)
        assert len(parts) == len(rparts), table
        for p, r in zip(parts, rparts):
            assert (p.index, p.node_id) == (r.index, r.node_id)
            assert list(p.data.cols) == list(r.data.cols)
            for c, v in r.data.cols.items():
                assert np.array_equal(p.data.cols[c].numpy(), v), (table, c)


def _assert_parts_equal(plan, rplan, cat, rcat, table="lineitem"):
    """The port's batch executor against the reference's per-partition
    oracle and its batch executor (whose dtypes the engine ships: a keyless
    batch with an empty partition is float64 throughout, as numpy's
    concatenation makes it); returns the rows compared."""
    parts = [p.data for p in cat.partitions_of(table)]
    rparts = [p.data for p in rcat.partitions_of(table)]
    got, _ = compile_push_plan(plan).execute_batch_parts(parts)
    want_batch, _ = r_compile_push_plan(rplan).execute_batch_parts(rparts)
    rows = 0
    for g, w, wb in zip(got, [execute_push_plan(rplan, p)[0] for p in rparts],
                        want_batch):
        assert list(g.cols) == list(w.columns)
        for c in w.columns:
            a, b = g.cols[c].numpy(), np.asarray(w.cols[c])
            assert a.dtype == np.asarray(wb.cols[c]).dtype, c
            assert np.array_equal(np.asarray(wb.cols[c]), b)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
            else:
                assert np.array_equal(a, b), c
        rows += len(g)
    return rows


@pytest.mark.parametrize("qid", ("Q18", "Q15", "Q1"))
def test_clustered_compile_and_having_plan_match_the_reference(qid,
                                                               clustered):
    """On lineitem clustered by l_orderkey Q18's HAVING is absorbed
    (``scan+agg+having``); Q1's and Q15's group keys do not hold the
    cluster key, so they keep their frontier. Each frontier runs per
    partition as the reference's does, and the query's result equals the
    reference's and the unclustered run's."""
    cat, rcat = clustered
    got = compiler.compile_ir(compiler.compile_query_detailed(qid).root, qid,
                              clustered=cat.clustered)
    want = rcompile.compile_ir(rcompile.compile_query_detailed(qid).root,
                               qid, clustered=rcat.clustered)
    plan = got.plans["lineitem"]
    assert _plan_fields(plan) == _plan_fields(want.plans["lineitem"])
    assert (plan.having is not None) == (qid == "Q18")
    assert ir.describe(got.residual) == rir.describe(want.residual)
    assert _assert_parts_equal(plan, want.plans["lineitem"], cat, rcat) > 0
    for mode in engine.MODES:
        run = engine.run_query(got.query, cat,
                               engine.EngineConfig(mode=mode, device="cpu"))
        rrun = reng.run_query(want.query, rcat, reng.EngineConfig(
            mode=mode, measured_feedback=False))
        _check_run(run, rrun)
        plain = engine.compile_and_run(qid, cat, engine.EngineConfig(
            mode=mode, device="cpu"))
        assert engine.results_equal(run.result, plain.result)


def _top_k_irs(k, shipdate, col, asc):
    def build(mod, C):
        n = mod.Scan("lineitem", ("l_orderkey", "l_partkey"))
        n = mod.Filter(n, C("l_shipdate") < shipdate)
        n = mod.Map(n, (("gross", ("l_extendedprice", "l_tax"),
                         lambda e, t: e * (1 + t)),))
        return mod.TopK(n, col, k, asc)
    return build(ir, Col), build(rir, RCol)


@pytest.mark.parametrize("k, shipdate, col, asc", (
        (7, 1000, "gross", False), (5, 12, "l_extendedprice", True),
        (50, 10_000, "l_partkey", False), (0, 1000, "gross", False)))
def test_absorbed_top_k_matches_the_reference(k, shipdate, col, asc,
                                              catalog, ref_catalog):
    """A TopK over a filtered, derived lineitem scan is absorbed; each
    partition's k best rows equal the reference executor's. ``l_partkey``
    (int32, 1000 values) has ties, where the reference's ``argpartition``
    may keep other rows of the tied value; ``shipdate`` 12 leaves
    partitions with no row."""
    root, rroot = _top_k_irs(k, shipdate, col, asc)
    got, want = compiler.compile_ir(root, "TK"), rcompile.compile_ir(rroot,
                                                                     "TK")
    plan = got.plans["lineitem"]
    assert plan.top_k == (col, k, asc)
    assert _plan_fields(plan) == _plan_fields(want.plans["lineitem"])
    ties = col == "l_partkey"
    if not ties:  # distinct values: the same rows, in order
        _assert_parts_equal(plan, want.plans["lineitem"], catalog,
                            ref_catalog)
    run = engine.run_query(got.query, catalog,
                           engine.EngineConfig(device="cpu"))
    rrun = reng.run_query(want.query, ref_catalog,
                          reng.EngineConfig(measured_feedback=False))
    _check_run(run, rrun, only=col if ties else None)


def test_segmented_top_k_keeps_row_order_among_ties(catalog):
    """With ties the per-partition rows are those ``operators.top_k``
    keeps per partition: best first, ties in row order."""
    from repro_torch.queryproc import operators as ops
    root, _ = _top_k_irs(40, 10_000, "l_partkey", False)
    plan = compiler.compile_ir(root, "TK").plans["lineitem"]
    parts = [p.data for p in catalog.partitions_of("lineitem")]
    got, _ = compile_push_plan(plan).execute_batch_parts(parts)
    for g, p in zip(got, parts):
        c = p.filter(p.cols["l_shipdate"] < 10_000)
        c = ops.top_k(type(c)({
            "l_orderkey": c.cols["l_orderkey"],
            "l_partkey": c.cols["l_partkey"],
            "gross": c.cols["l_extendedprice"] * (1 + c.cols["l_tax"])}),
            "l_partkey", 40)
        for name in ("l_orderkey", "l_partkey", "gross"):
            assert torch.equal(g.cols[name], c.cols[name])


def _min_max_irs(keys, shipdate):
    aggs = (("lo_price", "min", "l_extendedprice"),
            ("hi_ship", "max", "l_shipdate"),
            ("lo_qty", "min", "l_quantity"), ("qty", "sum", "l_quantity"),
            ("avg_price", "mean", "l_extendedprice"), ("n", "count", ""))

    def build(mod, C):
        n = mod.Filter(mod.Scan("lineitem", ()), C("l_shipdate") < shipdate)
        return mod.Aggregate(n, keys, aggs)
    return build(ir, Col), build(rir, RCol)


@pytest.mark.parametrize("keys, shipdate", (
        (("l_returnflag", "l_linestatus"), 1000), (("l_orderkey",), 600),
        ((), 1000), ((), 12)))
def test_pushed_min_max_match_the_reference(keys, shipdate, catalog,
                                            ref_catalog):
    """min/max (f64 and int32 columns) beside sums, a mean and a count in
    one pushed aggregate: per partition as the reference's, min/max in the
    column's dtype; keyless at shipdate 12 has partitions with no row (the
    float64 placeholder). The mean is not decomposable, so it stays
    residual with its aggregate; a frontier without it is pushed."""
    root, rroot = _min_max_irs(keys, shipdate)
    got, want = compiler.compile_ir(root, "MM"), rcompile.compile_ir(rroot,
                                                                     "MM")
    assert got.plans["lineitem"].agg is None  # the mean blocks absorption
    decomposable = [a for a in root.aggs if a[1] != "mean"]
    root = ir.Aggregate(root.child, keys, tuple(decomposable))
    rroot = rir.Aggregate(rroot.child, keys, tuple(decomposable))
    got, want = compiler.compile_ir(root, "MM"), rcompile.compile_ir(rroot,
                                                                     "MM")
    plan = got.plans["lineitem"]
    assert plan.agg is not None
    assert _plan_fields(plan) == _plan_fields(want.plans["lineitem"])
    _assert_parts_equal(plan, want.plans["lineitem"], catalog, ref_catalog)
    # the executor's own mean beside min/max, by a hand-built plan
    mean_plan = plan.__class__(plan.table, plan.columns, plan.predicate,
                               agg=(keys, _min_max_irs(keys, 0)[0].aggs))
    rmean_plan = want.plans["lineitem"].__class__(
        plan.table, plan.columns, want.plans["lineitem"].predicate,
        agg=(keys, _min_max_irs(keys, 0)[1].aggs))
    _assert_parts_equal(mean_plan, rmean_plan, catalog, ref_catalog)
    for mode in engine.MODES:
        _check_run(engine.run_query(got.query, catalog, engine.EngineConfig(
            mode=mode, device="cpu")),
            reng.run_query(want.query, ref_catalog, reng.EngineConfig(
                mode=mode, measured_feedback=False)))
