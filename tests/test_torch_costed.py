"""The port's cost-based compiler, cardinality corrector, §3.1 oracle split
and concurrent runs against the JAX package's, on the CPU, and the three
repaired faults of the port at their smallest inputs.

Two catalogs from the reference's arrays: the pinned cost-split catalog of
``tests/test_cost_split.py`` (sf=1, 2 nodes, 4,000-row lineitem
partitions), where Q3's orders get a 297-value ``In`` and the corrector
flips Q18, and ``tests/test_torch_compiler.py``'s (sf=0.5, 2 nodes,
2,000-row partitions). Keys, counts, bitmaps, decision vectors and bytes
must match bitwise; cut scores and f64 sums at rtol=1e-12 (the port sums
in another order).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.compiler import compile as rcompile
from repro.compiler import ir as rir
from repro.compiler import multitable as rmultitable
from repro.core import optimum as roptimum
from repro.core.cost import CardinalityCorrector as RCorrector
from repro.core.cost import RequestCost as RCost
from repro.core.cost import StorageResources as RResources
from repro.core.executor import compile_push_plan as r_compile
from repro.core.plan import PushPlan as RPushPlan
from repro.core.simulator import SimRequest as RSimRequest
from repro.queryproc import expressions as rex
from repro.queryproc import operators as rops
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnTable as RTable
from repro_torch import compiler
from repro_torch.compiler import ir, multitable, tpch_ir
from repro_torch.core import engine, optimum
from repro_torch.core.bitmap import merged_verdicts
from repro_torch.core.cost import (CardinalityCorrector, RequestCost,
                                   StorageResources, cut_score)
from repro_torch.core.executor import compile_push_plan
from repro_torch.core.plan import PushPlan
from repro_torch.core.simulator import SimRequest
from repro_torch.kernels.program import (K_IN_POOL, SplitProgram,
                                         compile_predicate)
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc import operators as ops
from repro_torch.queryproc import queries
from repro_torch.queryproc.expressions import Col
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays

CATALOGS = {"pinned": (1.0, 0, 2, 4000), "small": (0.5, 0, 2, 2000)}
POWERS = (1.0, 0.1)
SUM_RTOL = 1e-12


@pytest.fixture(scope="module")
def cats():
    """name -> (port catalog on the CPU, reference catalog)."""
    out = {}
    for name, (sf, seed, nodes, rpp) in CATALOGS.items():
        arrays = {n: t.cols
                  for n, t in rtpch.generate_tables(sf, seed).items()}
        out[name] = (catalog_from_arrays(arrays, nodes, rpp, device="cpu"),
                     rtpch.build_catalog(sf, seed, nodes, rpp))
    return out


def _cfg(mode="eager", power=1.0, corrector=None):
    return engine.EngineConfig(res=StorageResources(storage_power=power),
                               mode=mode, device="cpu", corrector=corrector)


def _rcfg(mode="eager", power=1.0, corrector=None):
    return reng.EngineConfig(res=RResources(storage_power=power), mode=mode,
                             measured_feedback=False, corrector=corrector)


def _plan_fields(plan):
    """Everything a PushPlan decides (predicates by repr)."""
    return (plan.table, plan.columns, repr(plan.predicate),
            tuple((n, tuple(i)) for n, i, _ in plan.derive), plan.agg,
            plan.top_k, plan.shuffle, plan.bitmap_only, plan.apply_bitmap,
            repr(plan.having), plan.accessed_columns())


def _assert_same_rows(got: ColumnTable, want: RTable, ctx=""):
    """The same row multiset: exact columns bitwise, floats at SUM_RTOL."""
    g = got.to_numpy()
    assert sorted(g) == sorted(want.cols), ctx
    assert len(got) == len(want), ctx
    if not len(want):
        return
    cols = sorted(g)
    order = [c for c in cols if g[c].dtype.kind == "f"] + \
        [c for c in cols if g[c].dtype.kind != "f"]
    ia = np.lexsort(tuple(g[c] for c in order))
    ib = np.lexsort(tuple(np.asarray(want.cols[c]) for c in order))
    for c in cols:
        x, y = g[c][ia], np.asarray(want.cols[c])[ib]
        assert x.dtype == y.dtype, (ctx, c, x.dtype, y.dtype)
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=SUM_RTOL, atol=0,
                                       err_msg=f"{ctx} {c}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{ctx} {c}")


def _check_run(got, want):
    assert reng.results_equal(RTable(got.result.to_numpy()), want.result)
    assert got.sim.decisions() == want.sim.decisions()
    assert (got.n_admitted, got.n_pushed_back) == \
        (want.n_admitted, want.n_pushed_back)
    assert got.net_bytes == want.net_bytes
    assert got.real_net_bytes == want.real_net_bytes
    assert got.net_bytes_recon == want.net_bytes_recon
    assert got.t_pushable == want.t_pushable


# ------------------------------------------------------- the three faults
def test_group_ids_past_the_int64_code_space():
    """Two int64 keys of span 2**31 + 1: their product reaches 2**62, so
    the running code is compressed before the second key."""
    a = torch.tensor([0, 2 ** 31])
    v = torch.tensor([1.0, 2.0])
    got = ops.grouped_agg(ColumnTable({"a": a, "b": a.clone(), "v": v}),
                          ["a", "b"], {"s": ("sum", "v"), "n": ("count", "")})
    want = rops.grouped_agg(RTable({"a": a.numpy(), "b": a.numpy(),
                                    "v": v.numpy()}),
                            ["a", "b"], {"s": ("sum", "v"),
                                         "n": ("count", "")})
    assert len(got) == 2
    _assert_same_rows(got, want)


def test_group_ids_keep_lexicographic_order_through_compression():
    rng = np.random.default_rng(7)
    keys = [rng.choice([-2 ** 62, -5, 0, 3, 2 ** 40, 2 ** 62], 300),
            rng.choice([0, 2 ** 33, 2 ** 50], 300), rng.integers(0, 4, 300)]
    lead = rng.integers(0, 3, 300)
    ids, G, decode = ops.group_ids([torch.from_numpy(k) for k in keys],
                                   lead=torch.from_numpy(lead), lead_size=3)
    rec = np.stack([lead, *keys], axis=1)
    uniq, inv = np.unique(rec, axis=0, return_inverse=True)
    # ids are dense ranks of (lead, keys...) here: every code is used
    assert G == len(uniq)
    np.testing.assert_array_equal(ids.numpy(), inv.reshape(-1))
    lead_of, key_vals = decode(torch.arange(G))
    np.testing.assert_array_equal(
        np.stack([lead_of.numpy()] + [k.numpy() for k in key_vals], axis=1),
        uniq)


def test_pushed_aggregate_over_wide_keys_matches_the_reference():
    """A partial aggregate by two wide int64 keys over three partitions,
    through ``execute_batch_parts`` (the partition leads the group code)."""
    rng = np.random.default_rng(3)
    parts = []
    for n in (37, 50, 41):
        parts.append({"a": rng.choice([0, 2 ** 31, 2 ** 45], n),
                      "b": rng.choice([-2 ** 40, 7, 2 ** 31], n),
                      "v": rng.random(n)})
    kw = dict(table="t", columns=("a", "b", "s", "n"),
              predicate=None, agg=(("a", "b"), (("s", "sum", "v"),
                                                ("n", "count", ""))))
    got, _ = compile_push_plan(PushPlan(**kw)).execute_batch_parts(
        [ColumnTable.from_numpy(p, "cpu") for p in parts])
    want, _ = r_compile(RPushPlan(**kw)).execute_batch_parts(
        [RTable(p) for p in parts])
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same_rows(g, w, i)


def _pred_cases():
    rng = np.random.default_rng(11)
    vals512 = tuple(int(v) for v in rng.choice(4000, 512, replace=False))
    cols = {"i32": rng.integers(0, 4000, 3000).astype(np.int32),
            "i64": rng.integers(0, 4000, 3000),
            "f64": rng.integers(0, 4000, 3000).astype(np.float64)}
    nine = {f"c{i}": np.arange(3000, dtype=np.int32) % 10 for i in range(9)}
    and9 = Col("c0") >= 0
    for i in range(1, 9):
        and9 = and9 & (Col(f"c{i}") >= 0)
    return [
        ("isin65", {"a": np.arange(3000, dtype=np.int32) % 100},
         lambda E: E.Col("a").isin(range(65))),
        *[(f"in512_{c}", cols, lambda E, c=c: E.Col(c).isin(
            tuple(float(v) for v in vals512) if c == "f64" else vals512))
          for c in cols],
        ("in512_or_cmp", cols, lambda E: E.Col("i32").isin(vals512)
         | (E.Col("f64") < 100.0)),
        ("and9", nine, lambda E: _and9(E)),
    ]


def _and9(E):
    e = E.Col("c0") >= 0
    for i in range(1, 9):
        e = e & (E.Col(f"c{i}") >= 0)
    return e


PRED_CASES = _pred_cases()


@pytest.mark.parametrize("kind", ("filter", "bitmap", "agg", "shuffle"))
@pytest.mark.parametrize("case", range(len(PRED_CASES)),
                         ids=[c[0] for c in PRED_CASES])
def test_large_predicates_run_through_the_executor(case, kind):
    """Long ``In`` lists (pooled) and a nine-column AND (split into two
    programs) give the reference executor's rows, words, sums and shuffle
    slices, over partitions of 1,000, 999 and 1,001 rows (none after the
    first starts on a 32-row boundary)."""
    name, cols, make = PRED_CASES[case]
    bounds = (0, 1000, 1999, 3000)
    parts = [{c: v[lo:hi] for c, v in cols.items()}
             for lo, hi in zip(bounds, bounds[1:])]
    first = next(c for c in sorted(cols) if cols[c].dtype.kind == "i")
    kw = dict(table="t", columns=tuple(sorted(cols)))
    if kind == "bitmap":
        kw["bitmap_only"] = True
    elif kind == "agg":
        kw = dict(table="t", columns=(first, "n"),
                  agg=((first,), (("n", "count", ""),)))
    elif kind == "shuffle":
        kw["shuffle"] = (first, 4)
    got, gaux = compile_push_plan(PushPlan(predicate=make(ex), **kw)) \
        .execute_batch_parts([ColumnTable.from_numpy(p, "cpu")
                              for p in parts])
    want, waux = r_compile(RPushPlan(predicate=make(rex), **kw)) \
        .execute_batch_parts([RTable(p) for p in parts])
    for i, (g, w, ga, wa) in enumerate(zip(got, want, gaux, waux)):
        _assert_same_rows(g, w, (name, kind, i))
        if kind == "bitmap":
            np.testing.assert_array_equal(ga["bitmap"].numpy().view(np.uint32),
                                          wa["bitmap"])
        if kind == "shuffle":
            for gs, ws in zip(ga["shuffle_parts"], wa["shuffle_parts"]):
                _assert_same_rows(gs, ws, (name, "slice", i))
    if kind == "filter" and name == "isin65":
        assert sum(len(g) for g in got) == 65 * 30
    if kind == "filter" and name == "and9":
        assert sum(len(g) for g in got) == 3000


def test_large_predicates_compile_to_a_pool_or_a_split():
    dts = {f"c{i}": torch.int32 for i in range(9)}
    split = compile_predicate(_and9(ex), dts)
    assert isinstance(split, SplitProgram) and split.op == "and"
    assert [split.left.columns, split.right.columns] == [
        tuple(f"c{i}" for i in range(8)), ("c8",)]
    prog = compile_predicate(Col("a").isin(range(65)), {"a": torch.int32})
    assert prog.ops[0, 0] & 15 == K_IN_POOL and prog.ops[0, 3] == 65
    np.testing.assert_array_equal(prog.pool, np.arange(65))
    short = compile_predicate(Col("a").isin(range(16)), {"a": torch.int32})
    assert len(short.pool) == 0 and len(short.fconst) == 16
    # a float list is pooled sorted, deduplicated and without NaN
    f = compile_predicate(Col("x").isin((3.0, float("nan"), -1.0, 3.0)
                                        + tuple(range(20))),
                          {"x": torch.float64})
    assert list(f.pool.view(np.float64)) == [-1.0] + [float(v)
                                                     for v in range(20)]


@pytest.mark.parametrize("qid", ("Q14", "Q3", "Q18"))
def test_reconciliation_has_the_reference_by_table(qid, cats):
    cat, rcat = cats["pinned"]
    got = engine.run_query(queries.build_query(qid), cat, _cfg())
    want = reng.run_query(rqueries.build_query(qid), rcat, _rcfg())
    assert got.net_bytes_recon == want.net_bytes_recon
    assert set(got.net_bytes_recon["by_table"]) == set(
        queries.build_query(qid).plans)


# --------------------------------------------------- cost-based compiler
@pytest.mark.parametrize("qid", compiler.QUERY_IDS)
@pytest.mark.parametrize("cat_name", CATALOGS)
def test_costed_compile_matches_the_reference(cat_name, qid, cats):
    cat, rcat = cats[cat_name]
    got = compiler.compile_query_costed(qid, cat)
    want = rcompile.compile_query_costed(qid, rcat)
    assert len(got.cut_report) == len(want.cut_report)
    for g, w in zip(got.cut_report, want.cut_report):
        assert (g.table, g.chosen, g.maximal, g.signatures, g.bitmap,
                g.lowered) == (w.table, w.chosen, w.maximal, w.signatures,
                               w.bitmap, w.lowered)
        np.testing.assert_allclose(g.scores, w.scores, rtol=SUM_RTOL, atol=0)
    assert set(got.plans) == set(want.plans)
    for table, plan in got.plans.items():
        assert _plan_fields(plan) == _plan_fields(want.plans[table]), table
    assert got.frontier_signature() == want.frontier_signature()
    assert got.split.cuts == want.split.cuts
    assert ir.describe(got.residual) == rir.describe(want.residual)


@pytest.mark.parametrize("power", POWERS)
@pytest.mark.parametrize("mode", engine.MODES)
@pytest.mark.parametrize("qid", compiler.QUERY_IDS)
@pytest.mark.parametrize("cat_name", CATALOGS)
def test_costed_compile_and_run_matches_the_reference(cat_name, qid, mode,
                                                      power, cats):
    cat, rcat = cats[cat_name]
    got = engine.compile_and_run(qid, cat, _cfg(mode, power),
                                 cost_based=True)
    want = reng.compile_and_run(qid, rcat, _rcfg(mode, power),
                                cost_based=True)
    _check_run(got, want)


@pytest.mark.parametrize("mode", engine.MODES)
def test_costed_q18_takes_the_having_cut_on_a_clustered_catalog(mode):
    """``tests/test_having.py``'s costed cases: on lineitem clustered by
    ``l_orderkey`` the chooser picks ``scan+agg+having``, and the run
    equals the reference's in every mode."""
    sf, seed, nodes, rpp = CATALOGS["pinned"]
    cluster = {"lineitem": "l_orderkey"}
    cat = catalog_from_arrays(
        {n: t.cols for n, t in rtpch.generate_tables(sf, seed).items()},
        nodes, rpp, device="cpu", cluster=cluster)
    rcat = rtpch.build_catalog(sf, seed, nodes, rpp, cluster=cluster)
    cq = compiler.compile_query_costed("Q18", cat)
    (choice,) = [c for c in cq.cut_report if c.table == "lineitem"]
    assert choice.signatures[choice.chosen] == "scan+agg+having"
    got = engine.compile_and_run("Q18", cat, _cfg(mode), cost_based=True)
    want = reng.compile_and_run("Q18", rcat, _rcfg(mode), cost_based=True)
    _check_run(got, want)


def test_costed_q3_lowers_a_297_value_list_onto_orders(cats):
    """The lowering that overflowed the program's 64 constants: the
    customer survivors' keys as an ``In`` on ``o_custkey``, now pooled."""
    cat, _ = cats["pinned"]
    cq = compiler.compile_query_costed("Q3", cat)
    choice = next(c for c in cq.cut_report if c.table == "orders")
    assert choice.lowered.startswith("In(col=Col(name='o_custkey')")
    pred = cq.plans["orders"].predicate
    dts = {c: cat.partitions_of("orders")[0].data.cols[c].dtype
           for c in ex.columns_of(pred)}
    prog = compile_predicate(pred, dts)
    pooled = [op for op in prog.ops if op[0] & 15 == K_IN_POOL]
    assert [int(op[3]) for op in pooled] == [297]


def test_costed_fact_selectivity_matches_the_reference(cats):
    cat, rcat = cats["small"]
    for qid in ("Q3", "Q19"):
        got = engine.compile_and_run(qid, cat, _cfg("adaptive"),
                                     fact_selectivity=0.3, cost_based=True)
        want = reng.compile_and_run(qid, rcat, _rcfg("adaptive"),
                                    fact_selectivity=0.3, cost_based=True)
        _check_run(got, want)


def test_cut_score_charges_cpu_only_for_operator_work():
    res = StorageResources()
    c = RequestCost(s_in=10_000, s_out=5_000, compute_in=10_000)
    bare = cut_score(c, res, has_operator_work=False)
    work = cut_score(c, res, has_operator_work=True)
    assert bare == pytest.approx(5_000 / res.stream_bw)
    assert work == pytest.approx(bare + c.t_compute(res))
    weak = cut_score(c, res.with_power(0.01), has_operator_work=True)
    assert weak > work
    assert cut_score(c, res.with_power(0.01), has_operator_work=False) \
        == pytest.approx(bare)
    assert c.with_s_out(3).s_out == 64 and c.with_s_out(999).s_out == 999


# ------------------------------------------------- multi-table lowering
def test_implied_predicate_derivation():
    owned = {"a", "b"}
    for E, mt in ((ex, multitable), (rex, rmultitable)):
        p = (E.Col("a") > 1) & (E.Col("x") > 2)
        assert repr(mt.implied_predicate(p, owned)) == repr(E.Col("a") > 1)
        assert mt.implied_predicate(
            (E.Col("a") > 1) | (E.Col("x") > 2), owned) is None
        got = mt.implied_predicate(
            ((E.Col("a") > 1) & (E.Col("x") > 2)) | (E.Col("b") > 3), owned)
        assert repr(got) == repr((E.Col("a") > 1) | (E.Col("b") > 3))
        assert mt.implied_predicate(E.Col("a").eq(E.Col("b")),
                                    owned) is not None
        assert mt.implied_predicate(E.Col("a").eq(E.Col("x")), owned) is None
        dom = {"x": frozenset({5, 2, 9})}
        assert repr(mt.implied_predicate(E.Col("a").eq(E.Col("x")), owned,
                                         dom)) == repr(
            E.In(E.Col("a"), (2, 5, 9)))


def _lowerings(lows):
    return [(lw.table, repr(lw.predicate), lw.bitmap, lw.est_selectivity,
             lw.source) for lw in lows]


def test_lowering_soundness_walk_blocks_unsafe_paths(cats):
    cat, rcat = cats["pinned"]
    got = []
    for E, IR, mt, c in ((ex, ir, multitable, cat),
                         (rex, rir, rmultitable, rcat)):
        li = IR.Aggregate(IR.Scan("lineitem", ()), ("l_orderkey",),
                          (("s", "sum", "l_quantity"),))
        od = IR.Scan("orders", ("o_orderkey", "o_custkey"))
        j = IR.Join(li, od, "l_orderkey", "o_orderkey")
        f = IR.Filter(j, (E.Col("s") > 5) & (E.Col("o_custkey") < 3)
                      & (E.Col("l_orderkey") < 100))
        _root, lows = mt.lower(f, c, StorageResources()
                               if mt is multitable else RResources())
        got.append(_lowerings(lows))
    assert got[0] == got[1]
    assert all(t != "lineitem" for t, *_ in got[0])
    assert any(t == "orders" for t, *_ in got[0])


@pytest.mark.parametrize("qid", compiler.QUERY_IDS)
def test_lowerings_match_the_reference(qid, cats):
    """Every query's lowerings (Q17's shared subtree lowers only the
    domain In on lineitem) and the rewritten plan."""
    cat, rcat = cats["pinned"]
    root, lows = multitable.lower(tpch_ir.build_ir(qid), cat,
                                  StorageResources())
    rroot, rlows = rmultitable.lower(rcompile.tpch_ir.build_ir(qid), rcat,
                                     RResources())
    assert _lowerings(lows) == _lowerings(rlows)
    assert ir.describe(root) == rir.describe(rroot)
    if qid == "Q17":
        assert [lw.table for lw in lows] == ["lineitem"]
        assert lows[0].source == "domain[l_partkey]"
        assert isinstance(lows[0].predicate, ex.In)


def test_bitmap_lowered_frontier_ships_exchange_verdicts(cats):
    cat, rcat = cats["pinned"]
    cq = compiler.compile_query_costed("Q19", cat)
    plan = cq.plans["lineitem"]
    assert plan.bitmap_only
    parts = [p.data for p in cat.partitions_of("lineitem")[:5]]
    _tabs, aux = compile_push_plan(plan).execute_batch_parts(parts)
    got = merged_verdicts([a["bitmap"] for a in aux],
                          [len(p) for p in parts])
    want = torch.cat([ex.compile_expr(plan.predicate)(p.cols)
                      for p in parts])
    assert torch.equal(got, want)
    rplan = rcompile.compile_query_costed("Q19", rcat).plans["lineitem"]
    _rt, raux = r_compile(rplan).execute_batch_parts(
        [p.data for p in rcat.partitions_of("lineitem")[:5]])
    for a, r in zip(aux, raux):
        np.testing.assert_array_equal(a["bitmap"].numpy().view(np.uint32),
                                      r["bitmap"])


@pytest.mark.parametrize("sel, n_cols", ((0.8, 1), (0.003, 3), (0.0, 1),
                                          (1.0, 8), (0.01, 2)))
@pytest.mark.parametrize("power", POWERS)
def test_exchange_scoring_boundary(sel, n_cols, power):
    got = multitable.exchange_pays(sel, n_cols,
                                   StorageResources(storage_power=power))
    assert got == rmultitable.exchange_pays(
        sel, n_cols, RResources(storage_power=power))
    if (sel, n_cols) == (0.8, 1):
        assert got
    if (sel, n_cols) == (0.003, 3):
        assert not got


# ----------------------------------------------------------- corrector
def _ratio_err(run):
    return abs(math.log(run.net_bytes_recon["s_out_estimate_ratio"]))


def test_corrector_error_shrinks_monotonically_as_the_reference(cats):
    cat, rcat = cats["pinned"]
    corr, rcorr = CardinalityCorrector(), RCorrector()
    for qid in ("Q1", "Q14", "Q18"):
        errs = []
        for _ in range(4):
            run = engine.run_query(queries.build_query(qid), cat,
                                   _cfg(corrector=corr))
            rrun = reng.run_query(rqueries.build_query(qid), rcat,
                                  _rcfg(corrector=rcorr))
            assert run.net_bytes_recon == rrun.net_bytes_recon
            errs.append(_ratio_err(run))
        assert errs[0] > 0, (qid, errs)
        for a, b in zip(errs, errs[1:]):
            assert b <= a + 1e-12, (qid, errs)
        assert errs[-1] <= 0.05 * errs[0] + 1e-12, (qid, errs)
    assert corr.n_observations == rcorr.n_observations >= 12
    assert corr.state() == rcorr.state()
    assert corr.state("Q18") == rcorr.state("Q18")
    assert corr.snapshot() == rcorr.snapshot()


def test_corrector_ewma_decays_geometrically():
    corr, rcorr = CardinalityCorrector(alpha=0.5), RCorrector(alpha=0.5)
    errs = []
    for c in (corr, rcorr):
        c.observe("Q", "t", "scan", est_s_out=100.0, real_s_out=100.0)
    for _ in range(6):
        errs.append(abs(math.log(2.0 / corr.ratio("Q", "t", "scan"))))
        for c in (corr, rcorr):
            c.observe("Q", "t", "scan", 100.0, 200.0)
        assert corr.ratio("Q", "t", "scan") == rcorr.ratio("Q", "t", "scan")
        assert corr.ratio("Q", "t", "other") == rcorr.ratio("Q", "t", "other")
        assert corr.ratio("Q", "t", "other", exact=True) == 1.0
    assert all(b < a for a, b in zip(errs, errs[1:])), errs
    assert errs[-1] < 0.1 * errs[0]
    assert corr.state() == rcorr.state()
    assert corr.snapshot() == rcorr.snapshot()


def test_corrector_clamps_degenerate_observations():
    corr, rcorr = CardinalityCorrector(clamp=32.0), RCorrector(clamp=32.0)
    for c in (corr, rcorr):
        c.observe("Q", "t", None, est_s_out=1.0, real_s_out=1e12)
        c.observe("Q", "u", "scan", est_s_out=1e12, real_s_out=1.0)
    assert corr.ratio("Q", "t") == 32.0
    assert corr.ratio("Q", "u", "scan") == 1 / 32.0
    assert all(1 / 32.0 <= v <= 32.0 for v in corr.snapshot().values())
    assert corr.snapshot() == rcorr.snapshot()
    assert corr.state() == rcorr.state()
    corr2 = CardinalityCorrector()
    corr2.observe("Q", "t", None, est_s_out=0.0, real_s_out=100.0)  # no-op
    assert corr2.ratio("Q", "t") == 1.0 and corr2.n_observations == 0
    with pytest.raises(ValueError):
        CardinalityCorrector(alpha=0.0)


def test_corrector_never_flips_results(cats):
    cat, rcat = cats["pinned"]
    corr, rcorr = CardinalityCorrector(), RCorrector()
    for _ in range(2):
        for qid in ("Q3", "Q14", "Q18"):
            engine.run_query(queries.build_query(qid), cat,
                             _cfg(corrector=corr))
            reng.run_query(rqueries.build_query(qid), rcat,
                           _rcfg(corrector=rcorr))
    assert corr.state() == rcorr.state()
    for qid in ("Q3", "Q14", "Q18"):
        for mode in engine.MODES:
            plain = engine.run_query(queries.build_query(qid), cat,
                                     _cfg(mode))
            run = engine.run_query(queries.build_query(qid), cat,
                                   _cfg(mode, corrector=corr))
            rrun = reng.run_query(rqueries.build_query(qid), rcat,
                                  _rcfg(mode, corrector=rcorr))
            _check_run(run, rrun)
            _assert_same_rows(run.result, RTable(plain.result.to_numpy()),
                              (qid, mode))
            assert [r.s_out_raw for r in run.requests] == \
                [r.s_out_raw for r in rrun.requests]
            if run.n_admitted:
                assert run.net_bytes_recon["sim_pushdown_bytes"] \
                    != plain.net_bytes_recon["sim_pushdown_bytes"] or \
                    corr.ratio(qid, "lineitem") == 1.0, (qid, mode)


def test_corrected_chooser_flips_q18_back_to_partial_agg(cats):
    cat, rcat = cats["pinned"]
    corr, rcorr = CardinalityCorrector(), RCorrector()
    for _ in range(2):
        for qid in ("Q18", "Q4"):
            engine.run_query(queries.build_query(qid), cat,
                             _cfg(corrector=corr))
            reng.run_query(rqueries.build_query(qid), rcat,
                           _rcfg(corrector=rcorr))
    assert corr.snapshot() == rcorr.snapshot()
    assert compiler.compile_query_costed(
        "Q18", cat).frontier_signature()["lineitem"] == "scan"
    corrected = compiler.compile_query_costed("Q18", cat, corrector=corr)
    assert corrected.frontier_signature()["lineitem"] == "scan+agg"
    rcorrected = rcompile.compile_query_costed("Q18", rcat, corrector=rcorr)
    for g, w in zip(corrected.cut_report, rcorrected.cut_report):
        assert (g.chosen, g.signatures) == (w.chosen, w.signatures)
        np.testing.assert_allclose(g.scores, w.scores, rtol=SUM_RTOL)
    assert compiler.compile_query_costed(
        "Q4", cat, corrector=corr).frontier_signature()["lineitem"] \
        == "scan+derive"
    got = engine.run_query(corrected.query, cat, _cfg())
    maximal = engine.run_query(queries.build_query("Q18"), cat, _cfg())
    _assert_same_rows(got.result, RTable(maximal.result.to_numpy()))
    # the engine's own costed path, with the corrector in its config
    run = engine.compile_and_run("Q18", cat, _cfg(corrector=corr),
                                 cost_based=True)
    rrun = reng.compile_and_run("Q18", rcat, _rcfg(corrector=rcorr),
                                cost_based=True)
    _check_run(run, rrun)
    assert corr.state() == rcorr.state()


# -------------------------------------------------------------- optimum
def test_eq6_closed_form():
    assert optimum.n_opt_uniform(100, 1.0) == pytest.approx(50.0)
    assert optimum.n_opt_uniform(100, 3.0) == pytest.approx(75.0)
    assert optimum.n_opt_uniform(100, 0.0) == 0.0
    assert optimum.k_of(3.0, 0.0) == roptimum.k_of(3.0, 0.0) == 0.0


@pytest.mark.parametrize("k", [0.01, 0.3, 1.0, 3.7, 50.0])
@pytest.mark.parametrize("N", [1, 17, 500])
def test_eq7_speedup_bounds(k, N):
    t_opt = optimum.t_opt_uniform(1.0, k)
    assert t_opt <= min(1.0, k) + 1e-9
    assert t_opt == pytest.approx(k / (k + 1.0))
    assert t_opt == roptimum.t_opt_uniform(1.0, k)
    assert optimum.n_opt_uniform(N, k + 1.0) >= \
        optimum.n_opt_uniform(N, k) - 1e-9
    assert optimum.n_opt_uniform(N, k) == roptimum.n_opt_uniform(N, k)


@pytest.mark.parametrize("power", POWERS)
@pytest.mark.parametrize("seed", range(6))
def test_discrete_optimum_beats_endpoints_as_the_reference(seed, power):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 41))
    specs = [(int(rng.integers(10_000, 10 ** 6)),
              int(rng.integers(100, 10 ** 6)),
              int(rng.integers(10_000, 2 * 10 ** 6))) for _ in range(n)]
    res, rres = StorageResources(storage_power=power), \
        RResources(storage_power=power)
    costs = [RequestCost(*s) for s in specs]
    rcosts = [RCost(*s) for s in specs]
    best = optimum.discrete_optimum(costs, res)
    all_pd = optimum._time_of_split(costs, [True] * n, res)[0]
    all_pb = optimum._time_of_split(costs, [False] * n, res)[0]
    assert best.time <= min(all_pd, all_pb) + 1e-9
    assert 0 <= best.n_pushdown <= n
    assert dataclasses.astuple(best) == dataclasses.astuple(
        roptimum.discrete_optimum(rcosts, rres))
    assert dataclasses.astuple(optimum.uniform_prediction(costs, res)) == \
        dataclasses.astuple(roptimum.uniform_prediction(rcosts, rres))
    nodes = rng.integers(0, 2, n)
    sim = [SimRequest(i, int(nodes[i]), "Q", c) for i, c in enumerate(costs)]
    rsim = [RSimRequest(i, int(nodes[i]), "Q", c)
            for i, c in enumerate(rcosts)]
    assert dataclasses.astuple(optimum.simulated_optimum(sim, res)) == \
        dataclasses.astuple(roptimum.simulated_optimum(rsim, rres))


def test_uniform_prediction_of_no_requests():
    assert optimum.uniform_prediction([], StorageResources()) == \
        optimum.Split(0, 0.0, 0.0, 0.0)


@pytest.mark.parametrize("power", POWERS)
@pytest.mark.parametrize("qid", compiler.QUERY_IDS)
def test_theoretical_split_matches_the_reference(qid, power, cats):
    cat, rcat = cats["small"]
    got = engine.theoretical_split(queries.build_query(qid), cat,
                                   StorageResources(storage_power=power))
    want = reng.theoretical_split(rqueries.build_query(qid), rcat,
                                  RResources(storage_power=power))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


# ------------------------------------------------------------ concurrent
def test_concurrent_matches_solo_and_the_reference(cats):
    cat, rcat = cats["pinned"]
    qs = [queries.build_query("Q12"), queries.build_query("Q14")]
    runs = engine.run_concurrent(qs, cat, _cfg("adaptive_pa"))
    rruns = reng.run_concurrent([rqueries.build_query("Q12"),
                                 rqueries.build_query("Q14")], rcat,
                                _rcfg("adaptive_pa"))
    for q in qs:
        solo = engine.run_query(q, cat, _cfg("no_pushdown"))
        _assert_same_rows(runs[q.qid].result,
                          RTable(solo.result.to_numpy()), q.qid)
        _check_run(runs[q.qid], rruns[q.qid])


@pytest.mark.parametrize("mode", ("adaptive_pa", "adaptive"))
def test_concurrent_all_queries_at_low_power_match_the_reference(mode, cats):
    cat, rcat = cats["small"]
    runs = engine.run_concurrent(
        [queries.build_query(q) for q in compiler.QUERY_IDS], cat,
        _cfg(mode, 0.1))
    rruns = reng.run_concurrent(
        [rqueries.build_query(q) for q in compiler.QUERY_IDS], rcat,
        _rcfg(mode, 0.1))
    assert list(runs) == list(rruns)
    sim = next(iter(runs.values())).sim
    rsim = next(iter(rruns.values())).sim
    assert sim.finish_by_query == rsim.finish_by_query
    assert sim.decisions() == rsim.decisions()
    for qid, run in runs.items():
        _check_run(run, rruns[qid])
        assert run.t_pushable == sim.finish_by_query[qid]
        assert run.net_bytes == sim.net_bytes_by_query[qid]
