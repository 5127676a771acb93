"""The port's residual tensor backend against the JAX package's, on the CPU.

``repro_torch.compiler.tensorize`` is held to ``repro.compiler.tensorize``
itself, not only to the interpreter. The reference calls
``jax.experimental.enable_x64``, which JAX 0.9 moved to
``jax.enable_x64``; a function-scoped fixture (``x64``) puts the new name
under the old one for each test and takes it away after, so no other file
in the same worker sees it.

Both sides run the compiled queries on the reference test's catalog
(``tpch.build_catalog(sf=0.5, num_nodes=2, rows_per_partition=4_000)``,
the port's from the same arrays) and start from fresh metric registries.
For all 15 residuals, observe, cold and warm: the port's table equals the
reference's tensor table (the same columns with the same dtypes, and
``results_equal``; the reference's programs return their columns in
pytree order, sorted by name, the port in the interpreter's order), the
``TensorRun`` counters, the ``residual.*`` counters and every aggregate's
and join's observed lowering are the reference's. Through ``run_query``
in every mode and ``run_stream``, under random decision vectors and
fault-demoted replays, the backend, ``residual_jit`` and results equal the
reference's. The specialization machinery (respecs, shape buckets, LUT
duplicates, float keys, empty build sides), top-k and sort ties in order,
``compile_expr`` against ``compile_expr_jnp`` bitwise, and the error
policy (a ``KernelError`` propagates, other errors replay the oracle) are
pinned here too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.experimental

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.compiler import compile as rcompile
from repro.compiler import ir as rir
from repro.compiler import tensorize as rtz
from repro.core import faults as rfaults
from repro.core import runtime as rruntime
from repro.obs import metrics as rmetrics
from repro.obs import trace as rtrace
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro.queryproc.expressions import Col as RCol
from repro.queryproc.expressions_jax import compile_expr_jnp
from repro.queryproc.table import ColumnTable as RTable
from repro_torch import compiler
from repro_torch.compiler import interpreter, ir
from repro_torch.compiler import tensorize as tz
from repro_torch.core import engine, runtime
from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN
from repro_torch.core.faults import FaultPlan, RetryPolicy
from repro_torch.core.plan import execute_push_plan
from repro_torch.kernels import _launch
from repro_torch.obs import metrics, trace
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc import queries
from repro_torch.queryproc.expressions import Col
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays

SF, SEED, NODES, RPP = 0.5, 0, 2, 4_000
TENSOR_RUN_FIELDS = ("observed", "jit_hits", "jit_misses", "fell_back",
                     "n_stages")


@pytest.fixture(autouse=True)
def x64(monkeypatch):
    """The reference's ``enable_x64`` import under JAX 0.9, for this test
    only."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@pytest.fixture(autouse=True)
def registries(monkeypatch):
    """(port registry, reference registry), fresh for every test; no fault
    plan from the environment."""
    monkeypatch.delenv("REPRO_FAULT_SPEC", raising=False)
    prev = metrics.set_metrics(metrics.Metrics())
    rprev = rmetrics.set_metrics(rmetrics.Metrics())
    yield metrics.get_metrics(), rmetrics.get_metrics()
    metrics.set_metrics(prev)
    rmetrics.set_metrics(rprev)


@pytest.fixture(scope="module")
def cats():
    arrays = {n: t.cols for n, t in rtpch.generate_tables(SF, SEED).items()}
    return (catalog_from_arrays(arrays, NODES, RPP, device="cpu"),
            rtpch.build_catalog(SF, SEED, NODES, RPP))


def _cfg(mode="eager", **kw):
    return engine.EngineConfig(mode=mode, device="cpu", **kw)


def merged_for(cq, cat):
    """All-pushdown merged tables (the same for any decision vector)."""
    return {t: ColumnTable.concat([execute_push_plan(plan, p.data)[0]
                                   for p in cat.partitions_of(t)])
            for t, plan in cq.plans.items()}


def rmerged_for(cq, rcat):
    return {t: RTable.concat([reng.execute_push_plan(plan, p.data)[0]
                              for p in rcat.partitions_of(t)])
            for t, plan in cq.plans.items()}


def assert_same_table(got: ColumnTable, want: RTable, ctx=""):
    """The same columns with the same dtypes and ``results_equal``."""
    g = got.to_numpy()
    assert sorted(g) == sorted(want.cols), (ctx, list(g), list(want.cols))
    for c in g:
        assert g[c].dtype == np.asarray(want.cols[c]).dtype, (ctx, c)
    assert reng.results_equal(RTable(g), want), ctx


def run_fields(run):
    return tuple(getattr(run, f) for f in TENSOR_RUN_FIELDS)


def residual_counters(m):
    return {k: v for k, v in m.snapshot()["counters"].items()
            if k.startswith("residual.")}


def lowerings(art):
    """A reference artifact's observed lowering of each keyed aggregate and
    each join, by node position (what the port's ``tz.lowerings``
    returns)."""
    return ([art.obs["agg"][id(n)] for n in art.agg_nodes],
            [art.obs["join"][id(n)] for n in art.jn_nodes])


# ------------------------------------------------ all-15 against tensorize
@pytest.mark.parametrize("qid", compiler.QUERY_IDS)
def test_tensor_residual_matches_the_reference(cats, registries, qid):
    """observe -> cold (miss) -> warm (hit): each run's table, counters
    and lowering choices are the reference's, and the port's tensor table
    is the port interpreter's in its column order."""
    cat, rcat = cats
    cq = compiler.compile_query_detailed(qid)
    rq = rcompile.compile_query_detailed(qid)
    merged, rmerged = merged_for(cq, cat), rmerged_for(rq, rcat)
    oracle = interpreter.run(cq.residual, merged)
    for step in ("observe", "cold", "warm"):
        got = tz.execute(cq.residual, merged)
        want = rtz.execute(rq.residual, rmerged)
        assert_same_table(got.table, want.table, (qid, step))
        assert run_fields(got) == run_fields(want), (qid, step)
        assert not got.fell_back
        assert list(got.table.cols) == list(oracle.cols), (qid, step)
        assert engine.results_equal(oracle, got.table), (qid, step)
    assert got.jit_misses == 0 and got.jit_hits >= 1
    m, rm = registries
    assert residual_counters(m) == residual_counters(rm), qid
    assert tz.lowerings(cq.residual) == \
        lowerings(rtz._artifact(rq.residual)), qid


def test_pyop_queries_partition_into_two_stages(cats):
    cat, _ = cats
    for qid in ("Q15", "Q22"):
        cq = compiler.compile_query_detailed(qid)
        merged = merged_for(cq, cat)
        tz.execute(cq.residual, merged)                  # observe
        run = tz.execute(cq.residual, merged)
        assert run.n_stages == 2 and not run.fell_back, qid


# ------------------------------------------- modes and decision vectors
@pytest.mark.parametrize("mode", engine.MODES)
def test_engine_modes_match_the_reference(cats, registries, mode):
    """``run_query`` with ``residual="tensor"`` (compiled once, observe
    then warm): the reference's results, backend and ``residual_jit``, and
    the interpreter's results."""
    cat, rcat = cats
    for qid in ("Q5", "Q22"):
        q, rq = queries.build_query(qid), rqueries.build_query(qid)
        ri = engine.run_query(q, cat, _cfg(mode))
        for _ in range(2):
            got = engine.run_query(q, cat, _cfg(mode, residual="tensor"))
            want = reng.run_query(rq, rcat, reng.EngineConfig(
                mode=mode, residual="tensor"))
            assert_same_table(got.result, want.result, (qid, mode))
            assert got.residual_backend == want.residual_backend == "tensor"
            assert got.residual_jit == want.residual_jit, (qid, mode)
        assert engine.results_equal(ri.result, got.result)
        assert ri.residual_backend == "interpreter"
        assert ri.residual_jit is None
    m, rm = registries
    assert residual_counters(m) == residual_counters(rm)


def test_random_decision_vectors_match_the_reference(cats):
    cat, rcat = cats
    rng = np.random.default_rng(7)
    cq = compiler.compile_query_detailed("Q12")
    rq = rcompile.compile_query_detailed("Q12")
    reqs = engine.plan_requests(cq.query, cat)
    rreqs = reng.plan_requests(rq.query, rcat)
    assert [r.req_id for r in reqs] == [r.req_id for r in rreqs]
    for _ in range(3):
        decisions = {r.req_id: (PUSHDOWN if rng.random() < 0.5 else PUSHBACK)
                     for r in reqs}
        split = runtime.execute_split(reqs, decisions)
        rsplit = rruntime.execute_split(rreqs, decisions)
        got = tz.execute(cq.residual, split.merged)
        want = rtz.execute(rq.residual, rsplit.merged)
        assert_same_table(got.table, want.table)
        assert run_fields(got) == run_fields(want)
        assert engine.results_equal(
            interpreter.run(cq.residual, split.merged), got.table)


def test_fault_demoted_replay_matches_the_clean_run(cats, registries):
    """A certain pushdown crash demotes every admitted group to pushback:
    the tensor residual still gives the clean result, as the
    reference's does."""
    cat, rcat = cats
    q, rq = queries.build_query("Q6"), rqueries.build_query("Q6")
    clean = engine.run_query(q, cat, _cfg())
    cfg = _cfg(residual="tensor",
               faults=FaultPlan.from_spec("pushdown.crash:1.0", seed=3),
               retry=RetryPolicy(sleep_scale=0.0))
    rcfg = reng.EngineConfig(
        mode="eager", residual="tensor",
        faults=rfaults.FaultPlan.from_spec("pushdown.crash:1.0", seed=3),
        retry=rfaults.RetryPolicy(sleep_scale=0.0))
    for _ in range(2):                                   # observe, then run
        got = engine.run_query(q, cat, cfg)
        want = reng.run_query(rq, rcat, rcfg)
    assert got.recovery["n_demoted"] > 0
    assert got.recovery == want.recovery
    assert got.residual_backend == "tensor"
    assert got.residual_jit == want.residual_jit
    assert engine.results_equal(clean.result, got.result)
    assert_same_table(got.result, want.result)


# ------------------------------------------------- engine accounting/auto
def test_queryrun_jit_accounting_matches_the_reference(cats):
    cat, rcat = cats
    q, rq = queries.build_query("Q14"), rqueries.build_query("Q14")
    runs = [engine.run_query(q, cat, _cfg(residual="tensor"))
            for _ in range(3)]
    rruns = [reng.run_query(rq, rcat, reng.EngineConfig(
        mode="eager", residual="tensor")) for _ in range(3)]
    assert [r.residual_jit for r in runs] == [r.residual_jit for r in rruns]
    assert runs[0].residual_jit["observed"] is True
    assert runs[1].residual_jit["misses"] == runs[1].residual_jit["n_stages"]
    assert runs[2].residual_jit["hits"] == runs[2].residual_jit["n_stages"]
    assert runs[2].residual_jit["misses"] == 0
    assert not runs[2].residual_jit["fell_back"]


def test_residual_spans_match_the_reference(cats):
    """The traced ``residual_compute`` span carries the backend and the
    run's accounting; ``residual_compile``/``residual_observe`` spans and
    one ``residual_jit_cache`` event a stage, as in the reference."""
    cat, rcat = cats
    q, rq = queries.build_query("Q15"), rqueries.build_query("Q15")
    keys = ("backend", "jit_hits", "jit_misses", "fell_back")
    got, want = [], []
    for _ in range(2):
        with trace.tracing() as tr:
            engine.run_query(q, cat, _cfg(residual="tensor"))
        with rtrace.tracing() as rtr:
            reng.run_query(rq, rcat, reng.EngineConfig(mode="eager",
                                                       residual="tensor"))
        for t, out in ((tr, got), (rtr, want)):
            (sp,) = t.find("residual_compute")
            out.append(({k: sp.attrs.get(k) for k in keys},
                        [len(t.find(n)) for n in (
                            "residual_compile", "residual_observe",
                            "residual_jit_cache")]))
    assert got == want
    assert got[1][0]["backend"] == "tensor" and got[1][1] == [0, 0, 2]


def test_auto_mode_threshold(cats, monkeypatch):
    """auto = tensor at or above the crossover, interpreter below; the env
    override feeds the same knob the calibration would."""
    cat, _ = cats
    q = queries.build_query("Q6")
    monkeypatch.setattr(tz, "_AUTO_THRESHOLD", {})
    monkeypatch.setenv("REPRO_RESIDUAL_THRESHOLD", "1")
    r_hi = engine.run_query(q, cat, _cfg(residual="auto"))
    assert r_hi.residual_backend == "tensor"
    monkeypatch.setattr(tz, "_AUTO_THRESHOLD", {})
    monkeypatch.setenv("REPRO_RESIDUAL_THRESHOLD", str(1 << 40))
    r_lo = engine.run_query(q, cat, _cfg(residual="auto"))
    assert r_lo.residual_backend == "interpreter"
    assert r_lo.residual_jit is None
    assert engine.results_equal(r_hi.result, r_lo.result)


def test_calibration_returns_a_usable_threshold(monkeypatch):
    """The measured crossover is a positive row count (or inf when the
    tensor backend never wins), and REPRO_NO_CALIBRATE pins the
    reference's default."""
    th = tz.calibrate_residual_threshold(sizes=(512, 2_048), repeats=1,
                                         device="cpu")
    assert th > 0
    monkeypatch.setattr(tz, "_AUTO_THRESHOLD", {})
    monkeypatch.delenv("REPRO_RESIDUAL_THRESHOLD", raising=False)
    monkeypatch.setenv("REPRO_NO_CALIBRATE", "1")
    assert tz.auto_threshold("cpu") == tz.DEFAULT_RESIDUAL_THRESHOLD == \
        rtz.DEFAULT_RESIDUAL_THRESHOLD
    assert (tz._MIN_BUCKET, tz._LUT_CAP, tz._AGG_DOM_CAP, tz._RESPEC_CAP) == \
        (rtz._MIN_BUCKET, rtz._LUT_CAP, rtz._AGG_DOM_CAP, rtz._RESPEC_CAP)


def test_calibration_follows_the_device_policy(monkeypatch):
    """Calibration runs on the card unless asked for the CPU (no device
    means CUDA, which raises without a GPU), and the crossover is kept per
    device type: one device's calibration does not decide another's."""
    monkeypatch.setattr(tz, "_AUTO_THRESHOLD", {"cuda": 5.0})
    monkeypatch.delenv("REPRO_RESIDUAL_THRESHOLD", raising=False)
    monkeypatch.setenv("REPRO_NO_CALIBRATE", "1")
    assert tz.auto_threshold("cpu") == tz.DEFAULT_RESIDUAL_THRESHOLD
    assert tz._AUTO_THRESHOLD == {"cuda": 5.0,
                                  "cpu": tz.DEFAULT_RESIDUAL_THRESHOLD}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            tz.calibrate_residual_threshold(sizes=(512,), repeats=1)
        monkeypatch.setattr(tz, "_AUTO_THRESHOLD", {})
        with pytest.raises(RuntimeError, match="GPU"):
            tz.auto_threshold()


def test_unknown_backend_rejected(cats):
    cat, _ = cats
    with pytest.raises(ValueError, match="residual backend"):
        engine.run_query(queries.build_query("Q6"), cat,
                         _cfg(residual="bogus"))
    assert runtime.RESIDUALS == rruntime.RESIDUALS


def test_queries_without_residual_ir_fall_through_to_their_closure(cats):
    """A query with no residual IR (as the hand-built ones) runs its
    ``compute`` closure under the tensor backend too."""
    cat, _ = cats
    q = dataclasses.replace(queries.build_query("Q6"), residual=None)
    r = engine.run_query(q, cat, _cfg(residual="tensor"))
    ref = engine.run_query(q, cat, _cfg())
    assert r.residual_backend == "interpreter" and r.residual_jit is None
    assert engine.results_equal(r.result, ref.result)


# ------------------------------------------------ specialization machinery
def _agg_residuals():
    return (ir.Aggregate(ir.Merged("t"), ("k",), (("s", "sum", "v"),)),
            rir.Aggregate(rir.Merged("t"), ("k",), (("s", "sum", "v"),)))


def _tabs(keys, vals=None):
    keys = np.asarray(keys, dtype=np.int64)
    vals = (np.ones(len(keys)) if vals is None
            else np.asarray(vals, dtype=np.float64))
    return ({"t": ColumnTable.from_numpy({"k": keys, "v": vals}, "cpu")},
            {"t": RTable({"k": keys, "v": vals})})


def _both(res, rres, merged, rmerged):
    got, want = tz.execute(res, merged), rtz.execute(rres, rmerged)
    assert_same_table(got.table, want.table)
    assert run_fields(got) == run_fields(want)
    return got


def test_respecialize_on_domain_growth(registries):
    """Keys outside the observed domain trip the guard: that run falls
    back (still correct), the artifact respecializes (gen bump), and the
    next run takes the widened bounds, as in the reference."""
    res, rres = _agg_residuals()
    small, rsmall = _tabs(np.arange(64) % 4)
    big, rbig = _tabs(np.arange(64) % 4 + 100)       # disjoint key range
    _both(res, rres, small, rsmall)                  # observe on small
    art, rart = tz._artifact(res), rtz._artifact(rres)
    assert art.gen == 0
    assert not _both(res, rres, small, rsmall).fell_back
    assert _both(res, rres, big, rbig).fell_back     # oob -> guard trips
    assert (art.gen, art.respecs) == (rart.gen, rart.respecs) == (1, 1)
    ok = _both(res, rres, big, rbig)                 # widened spec runs
    assert not ok.fell_back and not art.disabled
    assert engine.results_equal(interpreter.run(res, big), ok.table)
    assert tz.lowerings(res) == lowerings(rart) == (
        [("code", (0,), (104,))], [])
    m, rm = registries
    assert residual_counters(m) == residual_counters(rm)
    assert residual_counters(m)["residual.respecs"] == 1


def test_shape_buckets_share_programs():
    """Row counts in one pow-2 bucket reuse the stage program; crossing a
    bucket boundary misses once more, results identical."""
    res, rres = _agg_residuals()
    tabs = [_tabs(np.arange(n) % 8) for n in (900, 1000, 1500)]
    _both(res, rres, *tabs[0])                       # observe
    assert _both(res, rres, *tabs[0]).jit_misses == 1  # 1024 bucket
    r2 = _both(res, rres, *tabs[1])                  # same bucket: hit
    assert (r2.jit_hits, r2.jit_misses) == (1, 0)
    assert _both(res, rres, *tabs[2]).jit_misses == 1  # 2048 bucket
    for m, rm in tabs:
        got = _both(res, rres, m, rm)
        assert got.jit_hits == 1
        assert engine.results_equal(interpreter.run(res, m), got.table)


def _join_case(lk, rk, semi=False, anti=False):
    l = {"k": np.asarray(lk), "x": np.arange(len(lk), dtype=np.float64)}
    r = {"rk": np.asarray(rk)}
    if not semi:
        r["y"] = 10.0 * np.arange(len(rk), dtype=np.float64)
    if semi:
        res = ir.SemiJoin(ir.Merged("l"), ir.Merged("r"), "k", "rk", anti)
        rres = rir.SemiJoin(rir.Merged("l"), rir.Merged("r"), "k", "rk",
                            anti)
    else:
        res = ir.Join(ir.Merged("l"), ir.Merged("r"), "k", "rk")
        rres = rir.Join(rir.Merged("l"), rir.Merged("r"), "k", "rk")
    merged = {"l": ColumnTable.from_numpy(l, "cpu"),
              "r": ColumnTable.from_numpy(r, "cpu")}
    return res, rres, merged, {"l": RTable(l), "r": RTable(r)}


def test_join_duplicate_right_keys_fall_back(registries):
    res, rres, merged, rmerged = _join_case([1, 2, 3], [2, 2, 3])
    _both(res, rres, merged, rmerged)                # observe
    run = _both(res, rres, merged, rmerged)
    assert run.fell_back
    assert engine.results_equal(interpreter.run(res, merged), run.table)
    m, rm = registries
    assert residual_counters(m) == residual_counters(rm)


def test_join_float_keys_use_the_sorted_probe():
    res, rres, merged, rmerged = _join_case([1.5, 2.5, 3.5, 9.0],
                                            [2.5, 3.5, 7.0])
    _both(res, rres, merged, rmerged)                # observe
    run = _both(res, rres, merged, rmerged)
    assert not run.fell_back
    assert tz.lowerings(res) == ([], [("sorted",)])
    assert engine.results_equal(interpreter.run(res, merged), run.table)


@pytest.mark.parametrize("anti", (False, True))
def test_empty_build_side(anti):
    res, rres, merged, rmerged = _join_case(
        np.asarray([1, 2, 3], np.int64), np.asarray([], np.int64),
        semi=True, anti=anti)
    _both(res, rres, merged, rmerged)                # observe
    run = _both(res, rres, merged, rmerged)
    assert len(run.table) == (3 if anti else 0) and not run.fell_back
    assert engine.results_equal(interpreter.run(res, merged), run.table)


def test_topk_and_descending_sort_ties_in_order():
    """Ties at the k-th row and in a descending sort come out in the
    reference's order, row for row (the reference's ``lax.top_k`` takes
    the lower row first; its sort reverses the valid prefix), and equal
    the port interpreter's in order."""
    rng = np.random.default_rng(5)
    cols = {"v": rng.integers(0, 4, 200).astype(np.float64),
            "w": rng.integers(0, 3, 200).astype(np.int64),
            "i": np.arange(200, dtype=np.int64)}
    merged = {"t": ColumnTable.from_numpy(cols, "cpu")}
    rmerged = {"t": RTable(cols)}
    flt = Col("i") < 150
    cases = [
        (ir.TopK(ir.Filter(ir.Merged("t"), flt), "v", 20),
         rir.TopK(rir.Filter(rir.Merged("t"), RCol("i") < 150), "v", 20)),
        (ir.TopK(ir.Merged("t"), "v", 30, ascending=True),
         rir.TopK(rir.Merged("t"), "v", 30, ascending=True)),
        (ir.Sort(ir.Filter(ir.Merged("t"), flt), ("v", "w"),
                 ascending=False),
         rir.Sort(rir.Filter(rir.Merged("t"), RCol("i") < 150), ("v", "w"),
                  ascending=False)),
        (ir.Sort(ir.Merged("t"), ("w",)), rir.Sort(rir.Merged("t"), ("w",))),
    ]
    for res, rres in cases:
        for _ in range(2):                           # observe, then run
            got = tz.execute(res, merged)
            want = rtz.execute(rres, rmerged).table
        assert not got.fell_back and not got.observed
        g = got.table.to_numpy()
        assert sorted(g) == sorted(want.cols)
        for c in g:
            assert np.array_equal(g[c], np.asarray(want.cols[c])), (res, c)
        oracle = interpreter.run(res, merged).to_numpy()
        for c in g:
            assert np.array_equal(g[c], oracle[c]), (res, c)


# --------------------------------------------- expression twin equivalence
def test_compile_expr_matches_compile_expr_jnp():
    rng = np.random.default_rng(11)
    cols = {"a": rng.integers(0, 50, 400).astype(np.int64),
            "b": rng.normal(size=400),
            "c": rng.integers(0, 5, 400).astype(np.int64)}
    tcols = {k: torch.from_numpy(v) for k, v in cols.items()}
    pairs = [
        (Col("a") < 25, RCol("a") < 25),
        ((Col("a") >= 10) & (Col("b") <= 0.3),
         (RCol("a") >= 10) & (RCol("b") <= 0.3)),
        ((Col("b") > Col("b")) | Col("c").eq(2),
         (RCol("b") > RCol("b")) | RCol("c").eq(2)),
        (Col("c").isin((1, 3, 4)) & (Col("a") > 5),
         RCol("c").isin((1, 3, 4)) & (RCol("a") > 5)),
        ((Col("a") <= Col("a")) & Col("c").isin((0,)),
         (RCol("a") <= RCol("a")) & RCol("c").isin((0,))),
    ]
    with jax.enable_x64(True):
        for e, re_ in pairs:
            want = np.asarray(jax.jit(compile_expr_jnp(re_))(cols))
            got = ex.compile_expr(e)(tcols).numpy()
            assert got.dtype == want.dtype == np.bool_
            assert np.array_equal(got, want), e


# ------------------------------------------------------------- the stream
def test_stream_with_the_tensor_backend_matches_the_reference(cats,
                                                              registries):
    """A stream that repeats its queries: every result equals the
    reference stream's and the interpreter stream's, and the
    ``residual.*`` counters (one observe and one miss a residual) are the
    reference's."""
    cat, rcat = cats
    qids = ("Q3", "Q12", "Q22")
    qs = {q: queries.build_query(q) for q in qids}
    rqs = {q: rqueries.build_query(q) for q in qids}
    order = qids + qids
    stream = [runtime.StreamQuery(qs[q], arrival=0.002 * i)
              for i, q in enumerate(order)]
    rstream = [rruntime.StreamQuery(rqs[q], arrival=0.002 * i)
               for i, q in enumerate(order)]
    base = runtime.run_stream(stream, cat, _cfg("adaptive"))
    _, rm = registries
    metrics.set_metrics(metrics.Metrics())  # drop the base stream's counts
    run = runtime.run_stream(stream, cat, _cfg("adaptive", residual="tensor"))
    want = rruntime.run_stream(rstream, rcat, reng.EngineConfig(
        mode="adaptive", residual="tensor"))
    assert set(run.results) == set(want.results) == set(base.results)
    for key, t in run.results.items():
        assert_same_table(t, want.results[key], key)
        assert engine.results_equal(base.results[key], t), key
    got_c = residual_counters(metrics.get_metrics())
    assert got_c == residual_counters(rm)
    assert got_c["residual.observes"] == 3
    assert got_c["residual.jit_cache.misses"] == 3


# ------------------------------------------------------------- error path
def test_a_kernel_error_propagates_out_of_execute(monkeypatch, registries):
    """A ``grouped_agg`` failure inside a stage program is the device's,
    not the lowering's: it propagates instead of coming back as a
    fallback run, and the residual stays on the tensor path."""
    res, _ = _agg_residuals()
    merged, _ = _tabs(np.arange(64) % 4)
    tz.execute(res, merged)                          # observe

    def broken(*args, **kwargs):
        raise _launch.KernelError("grouped_agg launch failed: CUDA error 700")
    monkeypatch.setattr(tz.gak, "grouped_agg", broken)
    with pytest.raises(_launch.KernelError):
        tz.execute(res, merged)
    assert not tz._artifact(res).disabled
    m, _ = registries
    assert m.snapshot()["counters"].get("residual.errors", 0) == 0
    assert m.snapshot()["counters"].get("residual.fallbacks", 0) == 0
    monkeypatch.undo()
    assert not tz.execute(res, merged).fell_back


@pytest.mark.parametrize("exc", (torch.cuda.OutOfMemoryError("oom"),
                                 RuntimeError("CUDA error: an illegal memory "
                                              "access was encountered")))
def test_device_errors_propagate(monkeypatch, exc):
    res, _ = _agg_residuals()
    merged, _ = _tabs(np.arange(64) % 4)
    tz.execute(res, merged)                          # observe

    def broken(*args, **kwargs):
        raise exc
    monkeypatch.setattr(tz.gak, "grouped_agg", broken)
    with pytest.raises(type(exc)):
        tz.execute(res, merged)


def test_other_errors_replay_the_interpreter(monkeypatch, registries):
    """Any other failure keeps the reference's policy: the interpreter
    answers, the residual stays on it, ``residual.errors`` counts it."""
    res, _ = _agg_residuals()
    merged, _ = _tabs(np.arange(64) % 4)
    tz.execute(res, merged)                          # observe

    def broken(*args, **kwargs):
        raise ValueError("a lowering that cannot take this input")
    monkeypatch.setattr(tz, "_agg_code", broken)
    run = tz.execute(res, merged)
    assert run.fell_back and tz._artifact(res).disabled
    assert engine.results_equal(interpreter.run(res, merged), run.table)
    m, _ = registries
    c = m.snapshot()["counters"]
    assert (c["residual.errors"], c["residual.fallbacks"]) == (1, 1)


def test_kernel_error_is_a_runtime_error():
    """Callers that catch the launch failures as ``RuntimeError`` still
    do."""
    assert issubclass(_launch.KernelError, RuntimeError)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        _launch.raise_on(2, "grouped_agg")
    _launch.raise_on(0, "grouped_agg")


# ----------------------------------------------------------------- threads
def test_concurrent_first_runs_observe_once(registries):
    """``run_stream`` runs residuals on a pool: 16 threads (more than the
    cores) starting one fresh residual together observe it once under the
    artifact's lock, every other run counts one hit or miss, and every
    result is the interpreter's."""
    import sys
    import threading
    res, _ = _agg_residuals()
    merged, _ = _tabs(np.arange(5000) % 37)
    want = interpreter.run(res, merged)
    runs, errors = [], []
    start = threading.Barrier(16)

    def work():
        try:
            start.wait(timeout=30)
            for _ in range(4):
                runs.append(tz.execute(res, merged))
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(runs) == 64
    assert sum(r.observed for r in runs) == 1
    assert sum(r.jit_hits + r.jit_misses for r in runs) == 63
    assert not any(r.fell_back for r in runs)
    assert all(engine.results_equal(want, r.table) for r in runs)
    c = registries[0].snapshot()["counters"]
    assert (c["residual.observes"], c["residual.tensor.runs"],
            c["residual.compiles"]) == (1, 64, 1)
