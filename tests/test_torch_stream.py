"""The port's stream driver, hedging and measured load against the JAX
package's, on the CPU.

Both sides run the compiled queries on the catalogs of
``tests/test_runtime.py`` (sf=1, 2 nodes, 4,000-row partitions) and
``tests/test_faults.py`` (sf=0.3, 2 nodes, 3,000-row partitions): the
reference's from ``repro.queryproc.tpch.build_catalog``, the port's from
the same arrays through ``catalog_from_arrays``. Every test gives both
sides fresh metric registries and runs the default ``measured_feedback``
on both, so a stream decides from its fluid queues (no queue depth was
published yet) unless a test publishes the gauges itself. A stream's
results must equal the reference's under ``results_equal`` and the
port's own other runs bitwise; its decisions, ``n_pushdown``/
``n_pushback``, real bytes and ``stream.*`` counters must be the
reference's. Hedging races the wall clock, so the hedging tests assert
only what holds whatever the race's outcome: ``won + lost ==
launched``, ``hedged == won``, the same results and no double counting.
"""
import dataclasses
import math
import threading

import numpy as np
import pytest

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.core import faults as rfaults
from repro.core import runtime as rruntime
from repro.core.arbitrator import Arbitrator as RArbitrator
from repro.core.cost import CardinalityCorrector as RCorrector
from repro.core.cost import RequestCost as RRequestCost
from repro.core.cost import StorageResources as RResources
from repro.core.simulator import SimRequest as RSimRequest
from repro.core.simulator import simulate as r_simulate
from repro.obs import metrics as rmetrics
from repro.obs import trace as rtrace
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnTable as RTable
from repro_torch.core import engine, runtime
from repro_torch.core.arbitrator import (PUSHBACK, PUSHDOWN, Arbitrator,
                                         MeasuredLoad)
from repro_torch.core.cost import (CardinalityCorrector, RequestCost,
                                   StorageResources)
from repro_torch.core.faults import (CircuitBreaker, FaultExhausted,
                                     FaultPlan, HedgeAborted, HedgePolicy,
                                     RetryPolicy)
from repro_torch.core.simulator import SimRequest, simulate
from repro_torch.obs import metrics, trace
from repro_torch.queryproc import queries
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays

FAST = RetryPolicy(sleep_scale=0.0)
RFAST = rfaults.RetryPolicy(sleep_scale=0.0)
CHAOS = "crash:0.4,timeout:0.15,transient:0.2,straggler:0.2:0.001"


def _catalogs(sf, nodes, rpp):
    arrays = {n: t.cols for n, t in rtpch.generate_tables(sf, 0).items()}
    return (catalog_from_arrays(arrays, nodes, rpp, device="cpu"),
            rtpch.build_catalog(sf, 0, nodes, rpp))


@pytest.fixture(scope="module")
def cats():
    """The catalogs of ``tests/test_runtime.py``."""
    return _catalogs(1.0, 2, 4000)


@pytest.fixture(scope="module")
def fcats():
    """The catalogs of ``tests/test_faults.py``."""
    return _catalogs(0.3, 2, 3000)


@pytest.fixture(autouse=True)
def registries(monkeypatch):
    """(port registry, reference registry), fresh for every test, and no
    fault plan from the environment."""
    monkeypatch.delenv("REPRO_FAULT_SPEC", raising=False)
    prev = metrics.set_metrics(metrics.Metrics())
    rprev = rmetrics.set_metrics(rmetrics.Metrics())
    yield metrics.get_metrics(), rmetrics.get_metrics()
    metrics.set_metrics(prev)
    rmetrics.set_metrics(rprev)


def fresh_registries():
    metrics.set_metrics(metrics.Metrics())
    rmetrics.set_metrics(rmetrics.Metrics())
    return metrics.get_metrics(), rmetrics.get_metrics()


def _cfg(mode="adaptive", power=1.0, **kw):
    return engine.EngineConfig(res=StorageResources(storage_power=power),
                               mode=mode, device="cpu", **kw)


def _rcfg(mode="adaptive", power=1.0, **kw):
    return reng.EngineConfig(res=RResources(storage_power=power), mode=mode,
                             **kw)


def streams(qids, gap=0.0):
    return ([runtime.StreamQuery(queries.build_query(q), arrival=i * gap)
             for i, q in enumerate(qids)],
            [rruntime.StreamQuery(rqueries.build_query(q), arrival=i * gap)
             for i, q in enumerate(qids)])


def assert_identical(a: ColumnTable, b: ColumnTable, ctx=""):
    """Same columns in the same order, dtypes and values bitwise."""
    assert a.columns == b.columns, (ctx, a.columns, b.columns)
    for c in a.columns:
        x, y = a.cols[c], b.cols[c]
        assert x.dtype == y.dtype, (ctx, c, x.dtype, y.dtype)
        assert np.array_equal(x.numpy(), y.numpy(), equal_nan=True), (ctx, c)


def check_same_stream(run, want, registries):
    """A port stream against the reference's: results, decisions, splits,
    bytes and ``stream.*`` counters."""
    assert set(run.results) == set(want.results)
    for key in run.results:
        assert reng.results_equal(RTable(run.results[key].to_numpy()),
                                  want.results[key]), key
    assert run.sim.decisions() == want.sim.decisions()
    assert (run.n_pushdown, run.n_pushback, run.real_net_bytes) == \
        (want.n_pushdown, want.n_pushback, want.real_net_bytes)
    for key, d in run.per_query.items():
        w = want.per_query[key]
        assert {k: d[k] for k in ("n_pushdown", "n_pushback",
                                  "real_net_bytes", "n_demoted",
                                  "retries")} == \
            {k: w[k] for k in ("n_pushdown", "n_pushback",
                               "real_net_bytes", "n_demoted", "retries")}
        assert d["sim_finish"] == w["sim_finish"]
    m, rm = registries
    assert {k: v for k, v in m.snapshot()["counters"].items()
            if k.startswith("stream.")} == \
        {k: v for k, v in rm.snapshot()["counters"].items()
         if k.startswith("stream.")}


# -------------------------------------------------- live decision callback
def test_arbitrator_decision_callback_matches_the_reference(cats):
    cat, _ = cats
    reqs = engine.plan_requests(queries.build_query("Q14"), cat)
    for mode in engine.MODES:
        seen, rseen = [], []
        sim = simulate([SimRequest(r.req_id, r.part.node_id, "Q14", r.cost)
                        for r in reqs], StorageResources(storage_power=0.25),
                       mode, on_decision=lambda rid, p: seen.append((rid, p)))
        r_simulate([RSimRequest(r.req_id, r.part.node_id, "Q14", r.cost)
                    for r in reqs], RResources(storage_power=0.25), mode,
                   on_decision=lambda rid, p: rseen.append((rid, p)))
        assert sorted(rid for rid, _ in seen) == \
            sorted(r.req_id for r in reqs)
        assert dict(seen) == sim.decisions(), mode
        assert seen == rseen, mode


def test_forced_decisions_callback():
    reqs = [SimRequest(i, 0, "Q", RequestCost(
        s_in=10_000, s_out=1_000, compute_in=10_000)) for i in range(6)]
    decisions = {i: (PUSHDOWN if i % 2 else PUSHBACK) for i in range(6)}
    seen = {}
    simulate(reqs, StorageResources(), decisions=decisions,
             on_decision=lambda rid, path: seen.setdefault(rid, path))
    assert seen == decisions


# ------------------------------------------------- concurrent stream driver
@pytest.mark.parametrize("mode", engine.MODES)
def test_stream_modes_identical_and_equal_to_the_reference(cats, mode):
    """Every mode gives the same results as no_pushdown's and as a solo
    ``run_query``, and the reference's split, bytes and counters."""
    cat, rcat = cats
    qids = ("Q1", "Q6", "Q12")
    stream, rstream = streams(qids, 0.005)
    base = runtime.run_stream(stream, cat, _cfg("no_pushdown", 0.25))
    regs = fresh_registries()
    run = runtime.run_stream(stream, cat, _cfg(mode, 0.25))
    want = rruntime.run_stream(rstream, rcat, _rcfg(mode, 0.25))
    assert run.wall_clock > 0 and set(run.per_query) == set(qids)
    assert run.n_pushdown == run.sim.admitted()
    assert run.n_pushback == sum(
        run.sim.pushed_back_by_query.get(q, 0) for q in qids)
    check_same_stream(run, want, regs)
    for qid in qids:
        assert_identical(base.results[qid], run.results[qid], (mode, qid))
    solo = engine.run_query(queries.build_query("Q12"), cat, _cfg())
    assert_identical(solo.result, run.results["Q12"], "stream-vs-solo")


def test_stream_driver_repeated_query(cats, registries):
    cat, rcat = cats
    stream, rstream = streams(("Q6", "Q6"), 0.002)
    run = runtime.run_stream(stream, cat, _cfg())
    want = rruntime.run_stream(rstream, rcat, _rcfg())
    assert set(run.results) == {"Q6", "Q6#1"}
    n_req = len(engine.plan_requests(queries.build_query("Q6"), cat))
    assert run.n_pushdown + run.n_pushback == 2 * n_req
    check_same_stream(run, want, registries)
    solo = engine.run_query(queries.build_query("Q6"), cat, _cfg())
    for key in ("Q6", "Q6#1"):
        assert_identical(solo.result, run.results[key], key)


def test_stream_driver_feeds_corrector_like_the_reference(cats):
    """Two streams through one corrector on each side: the second
    stream's estimate error shrinks, the results hold, and the
    corrector's state equals the reference's."""
    cat, rcat = cats
    corr, rcorr = CardinalityCorrector(), RCorrector()
    stream, rstream = streams(("Q1", "Q14"), 0.002)
    runs = []
    for _ in range(2):
        regs = fresh_registries()
        run = runtime.run_stream(stream, cat, _cfg("eager", corrector=corr))
        want = rruntime.run_stream(rstream, rcat,
                                   _rcfg("eager", corrector=rcorr))
        check_same_stream(run, want, regs)
        assert corr.state() == rcorr.state()
        assert corr.snapshot() == rcorr.snapshot()
        runs.append(run)
    first, second = runs
    assert corr.n_observations > 0
    for qid in ("Q1", "Q14"):
        assert_identical(first.results[qid], second.results[qid], qid)
        e1 = abs(math.log(first.per_query[qid]["s_out_estimate_ratio"]))
        e2 = abs(math.log(second.per_query[qid]["s_out_estimate_ratio"]))
        assert e2 <= e1 + 1e-12, (qid, e1, e2)


# --------------------------------------------------- chaos through the stream
def test_stream_chaos_matches_the_reference(fcats):
    cat, rcat = fcats
    qids = ["Q1", "Q3", "Q6", "Q12", "Q14"]
    stream, rstream = streams(qids)
    clean = runtime.run_stream(stream, cat, _cfg(), time_scale=0)
    regs = fresh_registries()
    plan, rplan = FaultPlan.from_spec(CHAOS, 21), \
        rfaults.FaultPlan.from_spec(CHAOS, 21)
    run = runtime.run_stream(stream, cat, _cfg(
        faults=plan, retry=FAST, breaker=CircuitBreaker()), time_scale=0)
    want = rruntime.run_stream(rstream, rcat, _rcfg(
        faults=rplan, retry=RFAST, breaker=rfaults.CircuitBreaker()),
        time_scale=0)
    for qid in qids:
        assert_identical(clean.results[qid], run.results[qid], qid)
    check_same_stream(run, want, regs)
    assert run.n_demoted == sum(d["n_demoted"]
                                for d in run.per_query.values())
    assert run.n_demoted == want.n_demoted and run.retries == want.retries
    assert run.n_demoted > 0 and run.retries > 0
    assert run.n_pushdown + run.n_pushback == \
        clean.n_pushdown + clean.n_pushback
    # the same draws, in whatever order the workers made them
    assert sorted(dataclasses.astuple(e) for e in plan.events()) == \
        sorted(dataclasses.astuple(e) for e in rplan.events())
    m, rm = regs
    assert {k: v for k, v in m.snapshot()["counters"].items()
            if k.startswith(("faults.", "retry."))} == \
        {k: v for k, v in rm.snapshot()["counters"].items()
         if k.startswith(("faults.", "retry."))}


def test_hedge_delay_matches_the_reference():
    cases = [([0.1] * 3, {}), ([float(i) for i in range(1, 11)], {}),
             ([], {"fixed_delay_s": 0.25}),
             ([], {"enabled": False, "fixed_delay_s": 0.25}),
             ([1e-6, 1e-6], {"min_samples": 1, "min_delay_s": 0.5}),
             ([0.003, 0.001, 0.02, 0.004, 0.002, 0.009, 0.005],
              {"percentile": 50.0})]
    for samples, kw in cases:
        h = HedgePolicy(**{"min_samples": 4, "multiplier": 2.0,
                           "min_delay_s": 0.0, **kw})
        rh = rfaults.HedgePolicy(**{"min_samples": 4, "multiplier": 2.0,
                                    "min_delay_s": 0.0, **kw})
        assert h.delay_s(samples) == rh.delay_s(samples), (samples, kw)
    assert HedgePolicy(percentile=95.0, multiplier=2.0, min_samples=4,
                       min_delay_s=0.0).delay_s(
        [float(i) for i in range(1, 11)]) == pytest.approx(20.0)


def test_stream_hedging_fires_and_reconciles(fcats, registries):
    """Every pushdown group straggles 5 ms and the hedge fires at 1 ms:
    races happen, and whichever side wins, the results and bytes are the
    clean run's and the counters add up."""
    cat, _ = fcats
    stream, _ = streams(["Q6"])
    clean = runtime.run_stream(stream, cat, _cfg(), time_scale=0)
    m, _ = fresh_registries()
    run = runtime.run_stream(stream, cat, _cfg(
        faults=FaultPlan.from_spec("pushdown.straggler:1.0:0.005", seed=8),
        retry=RetryPolicy(sleep_scale=1.0),
        hedge=HedgePolicy(fixed_delay_s=0.001)), time_scale=0)
    assert_identical(clean.results["Q6"], run.results["Q6"], "hedged")
    assert run.real_net_bytes == clean.real_net_bytes
    c = m.snapshot()["counters"]
    assert c.get("hedge.launched", 0) > 0
    assert c.get("hedge.won", 0) + c.get("hedge.lost", 0) == \
        c["hedge.launched"]
    assert run.hedged == c.get("hedge.won", 0)


def test_hedge_abort_token_stops_recovery_loop(fcats, registries):
    """A set abort token stops the loop before it draws, counts or
    demotes anything, as the reference's does."""
    cat, rcat = fcats
    q = queries.build_query("Q6")
    sub = [r for r in engine.plan_requests(q, cat)
           if r.part.node_id == 0][:2]
    rsub = [r for r in reng.plan_requests(rqueries.build_query("Q6"), rcat)
            if r.part.node_id == 0][:2]
    plan = FaultPlan.from_spec("transient:1.0", seed=1)
    rplan = rfaults.FaultPlan.from_spec("transient:1.0", seed=1)
    ev = threading.Event()
    ev.set()
    with pytest.raises(HedgeAborted):
        runtime._exec_group_recovered(
            runtime.compile_push_plan(sub[0].plan), sub, PUSHDOWN,
            runtime.EXECUTOR_BATCHED, plan, FAST, abort=ev)
    with pytest.raises(rfaults.HedgeAborted):
        rruntime._exec_group_recovered(
            rruntime.compile_push_plan(rsub[0].plan), rsub, PUSHDOWN,
            rruntime.EXECUTOR_BATCHED, None, rplan, RFAST, abort=ev)
    assert plan.events() == [] == rplan.events()
    m, _ = registries
    assert not any(k.startswith(("faults.", "retry."))
                   for k in m.snapshot()["counters"])


def test_hedge_abort_between_attempts_stops_before_the_demotion(fcats):
    """A token set while the loop backs off stops it at the next attempt
    boundary: one draw, one failure counted, no demotion."""
    cat, _ = fcats
    sub = [r for r in engine.plan_requests(queries.build_query("Q6"), cat)
           if r.part.node_id == 0][:2]
    plan = FaultPlan.from_spec("transient:1.0", seed=1)
    ev = threading.Event()
    real_backoff = FAST.backoff_s

    class SetOnBackoff(RetryPolicy):
        def backoff_s(self, attempt, u):
            ev.set()
            return real_backoff(attempt, u)

    with pytest.raises(HedgeAborted):
        runtime._exec_group_recovered(
            runtime.compile_push_plan(sub[0].plan), sub, PUSHDOWN,
            runtime.EXECUTOR_BATCHED, plan, SetOnBackoff(sleep_scale=0.0),
            abort=ev)
    assert len(plan.events()) == 1
    c = metrics.get_metrics().snapshot()["counters"]
    assert c.get("retry.attempts") == 1 and "retry.demotions" not in c


def test_hedge_loser_late_completion_no_double_count(fcats):
    """Every pushdown group straggles 50 ms (really slept) and the hedge
    fires at 1 ms, so every race has a loser already running when it
    loses. Its late completion adds no calibration sample and no bytes;
    every straggler draw, winners' and losers', is counted once."""
    cat, _ = fcats
    spec = "pushdown.straggler:1.0:0.05"
    slow = RetryPolicy(sleep_scale=1.0)
    stream, _ = streams(["Q6"])
    m, _ = fresh_registries()
    ref = runtime.run_stream(stream, cat, _cfg(
        faults=FaultPlan.from_spec(spec, seed=8), retry=slow), time_scale=0)
    ref_samples = m.snapshot()["counters"]["stream.exec_samples"]
    m, _ = fresh_registries()
    hplan = FaultPlan.from_spec(spec, seed=8)
    run = runtime.run_stream(stream, cat, _cfg(
        faults=hplan, retry=slow, hedge=HedgePolicy(fixed_delay_s=0.001)),
        time_scale=0)
    c = m.snapshot()["counters"]
    assert c.get("hedge.launched", 0) > 0
    assert c["stream.exec_samples"] == ref_samples
    assert run.real_net_bytes == ref.real_net_bytes
    assert_identical(ref.results["Q6"], run.results["Q6"], "hedged")
    assert c.get("faults.straggler", 0) == len(hplan.events())


def test_stream_worker_exception_propagates_and_pools_shut_down(fcats):
    cat, _ = fcats
    before = threading.active_count()
    stream, _ = streams(["Q6", "Q1"])
    cfg = _cfg(faults=FaultPlan.from_spec("pushdown.crash:1.0", seed=9),
               retry=RetryPolicy(sleep_scale=0.0, demote_on_exhaust=False))
    with pytest.raises(RuntimeError) as ei:
        runtime.run_stream(stream, cat, cfg, time_scale=0)
    assert isinstance(ei.value.__cause__, FaultExhausted)
    assert threading.active_count() <= before + 1


def test_stream_worker_exception_closes_query_span(fcats):
    cat, rcat = fcats
    stream, rstream = streams(["Q6"])
    spec = "pushdown.crash:1.0"
    cfg = _cfg(faults=FaultPlan.from_spec(spec, seed=9),
               retry=RetryPolicy(sleep_scale=0.0, demote_on_exhaust=False))
    rcfg = _rcfg(faults=rfaults.FaultPlan.from_spec(spec, seed=9),
                 retry=rfaults.RetryPolicy(sleep_scale=0.0,
                                           demote_on_exhaust=False))
    with trace.tracing() as tr, rtrace.tracing() as rtr:
        with pytest.raises(RuntimeError):
            runtime.run_stream(stream, cat, cfg, time_scale=0)
        with pytest.raises(RuntimeError):
            rruntime.run_stream(rstream, rcat, rcfg, time_scale=0)
    qspans = tr.find("query")
    assert qspans and all(s.dur is not None for s in qspans)
    assert any("error" in s.attrs for s in qspans)
    assert [sorted(s.attrs) for s in qspans] == \
        [sorted(s.attrs) for s in rtr.find("query")]
    (st,) = tr.find("run_stream")
    assert st.dur is not None


# ------------------------------------------------------------ measured load
HAND_GAUGES = (0.0, 3.0, 1000.0)


@pytest.mark.parametrize("depth", HAND_GAUGES)
@pytest.mark.parametrize("qid", ("Q1", "Q12", "Q19"))
def test_measured_load_from_gauges_set_by_hand(cats, qid, depth):
    """Queue depths published by hand, as a stream's waves publish them:
    the backlog guard reads them and decides as the reference's does."""
    cat, rcat = cats
    m, rm = fresh_registries()
    for reg in (m, rm):
        for n in range(2):
            reg.gauge(f"stream.node{n}.exec_queue").set(depth)
            reg.gauge(f"stream.node{n}.ship_queue").set(depth)
    run = engine.run_query(queries.build_query(qid), cat, _cfg(power=0.1))
    want = reng.run_query(rqueries.build_query(qid), rcat, _rcfg(power=0.1))
    assert run.sim.decisions() == want.sim.decisions()
    assert run.real_net_bytes == want.real_net_bytes
    assert reng.results_equal(RTable(run.result.to_numpy()), want.result)
    assert m.epoch()["epoch"] == rm.epoch()["epoch"]


def test_measured_gauges_move_the_decisions(cats):
    """With no queue measured, no request spills to its slower path; with
    a deep one, every request that waits spills: the gauges are read."""
    cat, _ = cats
    q = queries.build_query("Q1")
    paths = {}
    for depth in (0.0, 1000.0):
        m, _ = fresh_registries()
        for n in range(2):
            m.gauge(f"stream.node{n}.exec_queue").set(depth)
            m.gauge(f"stream.node{n}.ship_queue").set(depth)
        run = engine.run_query(q, cat, _cfg(power=0.1))
        paths[depth] = run.sim.decisions()
    assert paths[0.0] != paths[1000.0]
    assert sum(p == PUSHBACK for p in paths[1000.0].values()) != \
        sum(p == PUSHBACK for p in paths[0.0].values())


def test_measured_load_reads_gauges_and_falls_back():
    m = metrics.Metrics()
    ml = MeasuredLoad(m)
    ml.refresh()
    assert ml.queue_depth(0, PUSHDOWN) is None
    m.gauge("stream.node0.exec_queue").set(4)
    m.gauge("stream.node1.ship_queue").set(2)
    ml.refresh()
    assert ml.queue_depth(0, PUSHDOWN) == 4 and \
        ml.queue_depth(1, PUSHBACK) == 2
    assert ml.queue_depth(1, PUSHDOWN) is None
    assert m.epoch()["epoch"] == 3


class _FlakyMeasured:
    """A measured source that answers once, then goes dark."""

    def __init__(self):
        self._reads = 0

    def queue_depth(self, node_id, path):
        self._reads += 1
        return 64.0 if self._reads == 1 else None

    def refresh(self):
        pass


def test_spill_ok_survives_measured_going_dark_mid_stream():
    outs = []
    for arb_cls, res, cost in (
            (Arbitrator, StorageResources(cores=1, net_streams=1),
             RequestCost(s_in=10_000_000, s_out=1_000_000,
                         compute_in=1_000_000)),
            (RArbitrator, RResources(cores=1, net_streams=1),
             RRequestCost(s_in=10_000_000, s_out=1_000_000,
                          compute_in=1_000_000))):
        arb = arb_cls(res, measured=_FlakyMeasured(), node_id=0)
        arb.free_pd = 0
        first = [p for _r, p in arb.submit(0, cost)]
        second = arb.submit(1, cost)
        outs.append((first, second, len(arb.queue)))
    assert outs[0] == outs[1] == ([PUSHBACK], [], 1)


def test_gauges_going_dark_in_the_middle_of_a_stream(cats, monkeypatch):
    """A stream whose Arbitrators read a depth for the first request of
    every node and nothing after: the port decides as the reference."""
    cat, rcat = cats
    stream, rstream = streams(("Q1", "Q12", "Q19"), 0.001)
    regs = fresh_registries()

    class Dark(MeasuredLoad):
        def __init__(self):
            super().__init__()
            self._seen = set()

        def queue_depth(self, node_id, path):
            if node_id in self._seen:
                return None
            self._seen.add(node_id)
            return 64.0

    from repro.core import arbitrator as rarb

    class RDark(rarb.MeasuredLoad):
        def __init__(self):
            super().__init__()
            self._seen = set()

        def queue_depth(self, node_id, path):
            if node_id in self._seen:
                return None
            self._seen.add(node_id)
            return 64.0

    monkeypatch.setattr(engine, "_measured_of", lambda cfg: Dark())
    monkeypatch.setattr(reng, "_measured_of", lambda cfg: RDark())
    run = runtime.run_stream(stream, cat, _cfg(power=0.1))
    want = rruntime.run_stream(rstream, rcat, _rcfg(power=0.1))
    check_same_stream(run, want, regs)
