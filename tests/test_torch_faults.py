"""The port's fault injection and recovery against the JAX package's, on
the CPU.

Both sides run the compiled queries on the sf=0.3, 2-node, 3,000-row
catalog of ``tests/test_faults.py`` (the port's built from the same arrays
through ``catalog_from_arrays``), adaptive, with
``RetryPolicy(sleep_scale=0.0)`` so charged seconds drive every retry and
deadline while nothing sleeps. The reference runs with
``measured_feedback=False``. Under the same fault plan the port must draw
the same faults in the same order (``FaultPlan.events()``), recover the
same way (``QueryRun.recovery``, every ``RequestOutcome`` field) and count
the same (``faults.*``, ``retry.*``, ``breaker.*``, ``engine.*``); its
result must equal its own clean run bitwise and the reference's under
``results_equal``. Each test reads counters from fresh registries on both
sides.
"""
import dataclasses

import numpy as np
import pytest

import port_spans

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.core import faults as rfaults
from repro.core import runtime as rruntime
from repro.core.arbitrator import Arbitrator as RArbitrator
from repro.core.cost import RequestCost as RRequestCost
from repro.core.cost import StorageResources as RResources
from repro.core.simulator import SimRequest as RSimRequest
from repro.core.simulator import simulate as r_simulate
from repro.obs import metrics as rmetrics
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnTable as RTable
from repro_torch.core import engine, faults, runtime
from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN, Arbitrator
from repro_torch.core.cost import RequestCost, StorageResources
from repro_torch.core.faults import (CircuitBreaker, FaultExhausted,
                                     FaultPlan, FaultRule, RetryPolicy)
from repro_torch.core.simulator import SimRequest, simulate
from repro_torch.obs import metrics as tmetrics
from repro_torch.queryproc import queries
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays

SF, SEED, NODES, RPP = 0.3, 0, 2, 3000
FAST = RetryPolicy(sleep_scale=0.0)
RFAST = rfaults.RetryPolicy(sleep_scale=0.0)
CHAOS = ("crash:{crash},timeout:{timeout},transient:{transient},"
         "straggler:{straggler}:0.001")
RECOVERY_METRICS = ("faults.", "retry.", "breaker.", "engine.")


@pytest.fixture(scope="module")
def cats():
    arrays = {n: t.cols for n, t in rtpch.generate_tables(SF, SEED).items()}
    return (catalog_from_arrays(arrays, NODES, RPP, device="cpu"),
            rtpch.build_catalog(SF, SEED, NODES, RPP))


@pytest.fixture(autouse=True)
def registries(monkeypatch):
    """(port registry, reference registry), fresh for every test, and no
    fault plan from the environment."""
    monkeypatch.delenv("REPRO_FAULT_SPEC", raising=False)
    prev = tmetrics.set_metrics(tmetrics.Metrics())
    rprev = rmetrics.set_metrics(rmetrics.Metrics())
    yield tmetrics.get_metrics(), rmetrics.get_metrics()
    tmetrics.set_metrics(prev)
    rmetrics.set_metrics(rprev)


def _counters(m):
    return {k: v for k, v in m.snapshot()["counters"].items()
            if k.startswith(RECOVERY_METRICS)}


def _same_counters(registries):
    m, rm = registries
    assert _counters(m) == _counters(rm)


def assert_identical(a: ColumnTable, b: ColumnTable, ctx=""):
    """Same columns in the same order, dtypes and values bitwise."""
    assert a.columns == b.columns, (ctx, a.columns, b.columns)
    for c in a.columns:
        x, y = a.cols[c], b.cols[c]
        assert x.dtype == y.dtype, (ctx, c, x.dtype, y.dtype)
        assert np.array_equal(x.numpy(), y.numpy(), equal_nan=True), (ctx, c)


def run_both(cats, qid, spec=None, seed=0, mode="adaptive", retry=(FAST,
             RFAST), breaker=False):
    """(port run, reference run, port plan, reference plan) of one query
    under the same fault spec (None: no plan)."""
    cat, rcat = cats
    plan = FaultPlan.from_spec(spec, seed) if spec is not None else None
    rplan = rfaults.FaultPlan.from_spec(spec, seed) if spec is not None \
        else None
    got = engine.run_query(queries.build_query(qid), cat, engine.EngineConfig(
        mode=mode, device="cpu", faults=plan, retry=retry[0],
        breaker=CircuitBreaker() if breaker else None))
    want = reng.run_query(rqueries.build_query(qid), rcat, reng.EngineConfig(
        mode=mode, measured_feedback=False, faults=rplan, retry=retry[1],
        breaker=rfaults.CircuitBreaker() if breaker else None))
    return got, want, plan, rplan


def check_same_recovery(got, want, plan, rplan):
    assert reng.results_equal(RTable(got.result.to_numpy()), want.result)
    assert got.recovery == want.recovery
    assert [dataclasses.astuple(o) for o in got.outcomes] == \
        [dataclasses.astuple(o) for o in want.outcomes]
    assert got.sim.decisions() == want.sim.decisions()
    assert got.real_net_bytes == want.real_net_bytes
    if plan is not None:
        assert [dataclasses.astuple(e) for e in plan.events()] == \
            [dataclasses.astuple(e) for e in rplan.events()]
        assert plan.counts() == rplan.counts()


# ------------------------------------------------------- FaultPlan basics
SPECS = ("crash:0.1, node1.pushdown.timeout:0.5, straggler:0.3:0.05,"
         "node0.lineitem.transient:1.0, pushback.crash:0.2",
         "pushdown.crash:1.0", CHAOS.format(crash=0.25, timeout=0.15,
                                           transient=0.2, straggler=0.2))


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parsing_matches_the_reference(spec):
    got = FaultPlan.from_spec(spec, seed=3)
    want = rfaults.FaultPlan.from_spec(spec, seed=3)
    assert [dataclasses.astuple(r) for r in got.rules] == \
        [dataclasses.astuple(r) for r in want.rules]
    assert got.seed == want.seed == 3


@pytest.mark.parametrize("bad", ["crash", "exploded:0.5", "crash:2.0",
                                 "pushdown.krash:0.1"])
def test_spec_parsing_rejects_garbage(bad):
    with pytest.raises(ValueError):
        FaultPlan.from_spec(bad)
    with pytest.raises(ValueError):
        rfaults.FaultPlan.from_spec(bad)


COORDS = [(n, p, t, k, a) for n in (0, 1) for p in (PUSHDOWN, PUSHBACK)
          for t in ("lineitem", "orders") for k in ("0x4", "7x2")
          for a in (1, 2, 3)]


@pytest.mark.parametrize("epoch", (0, 1))
@pytest.mark.parametrize("seed", (0, 11))
def test_draws_and_jitter_match_the_reference(seed, epoch):
    spec = "crash:0.4,straggler:0.3:0.01,node1.orders.timeout:0.5"
    got, want = FaultPlan.from_spec(spec, seed), \
        rfaults.FaultPlan.from_spec(spec, seed)
    for _ in range(epoch):
        got.bump_epoch()
        want.bump_epoch()
    draws = [got.draw(*c) for c in reversed(COORDS)]   # any order
    rdraws = [want.draw(*c) for c in reversed(COORDS)]
    assert [d and dataclasses.astuple(d) for d in draws] == \
        [d and dataclasses.astuple(d) for d in rdraws]
    assert any(d is not None for d in draws)
    assert [dataclasses.astuple(e) for e in got.events()] == \
        [dataclasses.astuple(e) for e in want.events()]
    assert [got.jitter(*c) for c in COORDS] == \
        [want.jitter(*c) for c in COORDS]
    assert faults._unit_draw("a|b") == rfaults._unit_draw("a|b")


def test_different_seed_or_epoch_changes_the_schedule():
    coords = [(0, PUSHDOWN, "lineitem", f"{i}x1", 1) for i in range(64)]
    base = FaultPlan.from_spec("crash:0.5", seed=0)
    hits = [base.draw(*c) is not None for c in coords]
    other = FaultPlan.from_spec("crash:0.5", seed=1)
    assert hits != [other.draw(*c) is not None for c in coords]
    again = FaultPlan.from_spec("crash:0.5", seed=0)
    again.bump_epoch()
    assert hits != [again.draw(*c) is not None for c in coords]


def test_rule_scoping_and_max_times():
    p = FaultPlan([FaultRule("crash", 1.0, node=1, path=PUSHDOWN,
                             table="orders", max_times=2)])
    assert p.draw(0, PUSHDOWN, "orders", "k", 1) is None      # wrong node
    assert p.draw(1, PUSHBACK, "orders", "k", 1) is None      # wrong path
    assert p.draw(1, PUSHDOWN, "lineitem", "k", 1) is None    # wrong table
    assert p.draw(1, PUSHDOWN, "orders", "a", 1).kind == "crash"
    assert p.draw(1, PUSHDOWN, "orders", "b", 1).kind == "crash"
    assert p.draw(1, PUSHDOWN, "orders", "c", 1) is None      # cap reached
    assert p.counts()["crash"] == 2
    with pytest.raises(ValueError):
        FaultPlan([FaultRule("crash", 1.5)])


def test_env_plan_roundtrip(monkeypatch):
    assert faults.env_plan() is None
    monkeypatch.setenv("REPRO_FAULT_SPEC", "crash:0.5")
    monkeypatch.setenv("REPRO_FAULT_SEED", "9")
    p = faults.env_plan()
    assert p is not None and p.seed == 9 and p.rules[0].kind == "crash"
    assert faults.env_plan() is p      # cached: one shared event ledger
    monkeypatch.setenv("REPRO_FAULT_SEED", "10")
    assert faults.env_plan() is not p
    monkeypatch.setenv("REPRO_FAULT_SLEEP_SCALE", "0.25")
    assert faults.sleep_scale() == rfaults.sleep_scale() == 0.25
    assert RetryPolicy().real_scale() == 0.25 and FAST.real_scale() == 0.0


def test_env_spec_drives_execute_split(monkeypatch, cats):
    """With ``REPRO_FAULT_SPEC`` set and no plan passed, the split runs
    the recovery loop under the environment's plan."""
    cat, _ = cats
    monkeypatch.setenv("REPRO_FAULT_SPEC", "pushdown.crash:1.0")
    monkeypatch.setenv("REPRO_FAULT_SEED", "123")
    monkeypatch.setenv("REPRO_FAULT_SLEEP_SCALE", "0")
    reqs = engine.plan_requests(queries.build_query("Q6"), cat)
    split = runtime.execute_split(reqs, {})
    assert split.n_demoted == len(reqs) and split.n_pushdown == 0
    assert faults.env_plan().counts()["crash"] > 0


# ------------------------------------------------- RetryPolicy arithmetic
def test_backoff_and_charges_match_the_reference():
    kw = dict(backoff_base_s=0.01, backoff_mult=2.0, backoff_cap_s=0.03,
              jitter=0.5, attempt_timeout_s=0.04, detect_s=0.003)
    r, rr = RetryPolicy(**kw), rfaults.RetryPolicy(**kw)
    for attempt in (1, 2, 3, 9):
        for u in (0.0, 0.25, 0.5, 1.0):
            assert r.backoff_s(attempt, u) == rr.backoff_s(attempt, u)
    assert r.backoff_s(1, 0.5) == pytest.approx(0.01)
    assert r.backoff_s(3, 0.5) == pytest.approx(0.03)   # capped
    assert r.backoff_s(1, 0.0) == pytest.approx(0.005)  # -jitter edge
    for kind in faults.FAULT_KINDS:
        assert r.charge(kind) == rr.charge(kind)
    assert r.charge(faults.FAULT_TIMEOUT) == 0.04
    assert r.charge(faults.FAULT_CRASH) == 0.003
    assert dataclasses.astuple(RetryPolicy()) == \
        dataclasses.astuple(rfaults.RetryPolicy())


# ------------------------------------------------- CircuitBreaker machine
def _breaker_script(pkg):
    """tests/test_faults.py's trip/probe/close and probe-failure cases;
    returns every state and route on the way."""
    seen = []
    b = pkg.CircuitBreaker(trip_after=3, probe_after=2)
    seen.append(b.route(0, PUSHDOWN))
    for ok in (False, False, True, False, False):
        (b.record_success if ok else b.record_failure)(0, PUSHDOWN)
    seen.append(b.state(0, PUSHDOWN))
    b.record_failure(0, PUSHDOWN)
    seen += [b.state(0, PUSHDOWN), b.route(0, PUSHDOWN),
             b.route(0, PUSHDOWN), b.state(0, PUSHDOWN),
             b.route(0, PUSHDOWN)]
    b.record_success(0, PUSHDOWN)
    seen += [b.state(0, PUSHDOWN), b.route(0, PUSHDOWN),
             b.state(1, PUSHDOWN), b.state(0, PUSHBACK)]
    c = pkg.CircuitBreaker(trip_after=1, probe_after=1)
    c.record_failure(0, PUSHDOWN)
    seen += [c.state(0, PUSHDOWN), c.route(0, PUSHDOWN)]
    c.record_failure(0, PUSHDOWN)
    seen += [c.state(0, PUSHDOWN), b.snapshot(), c.snapshot()]
    return seen


def test_breaker_state_machine_matches_the_reference(registries):
    got, want = _breaker_script(faults), _breaker_script(rfaults)
    assert got == want
    assert got[:7] == ["allow", "closed", "open", "deny", "probe",
                       "half_open", "deny"]
    assert got[7:9] == ["closed", "allow"]
    assert got[11:14] == ["open", "probe", "open"]
    _same_counters(registries)


# --------------------------------- the Arbitrator's and simulator's hooks
def _cost(pkg_cost, s_in=8_000_000, s_out=500_000, compute_in=8_000_000):
    return pkg_cost(s_in=s_in, s_out=s_out, compute_in=compute_in)


def _routing_cases(pkg, Arb, Res, Cost, Req, sim):
    """The Arbitrator and simulator cases of tests/test_faults.py (the
    tripped node, the probe, the forced baselines, the capped release,
    mixed nodes, PA-aware drain, release after recovery)."""
    out = {}
    b = pkg.CircuitBreaker(trip_after=1, probe_after=10 ** 6)
    b.record_failure(0, PUSHDOWN)
    reqs = [Req(i, node_id=i % 2, query_id="q", cost=_cost(Cost))
            for i in range(8)]
    out["tripped"] = sim(reqs, Res(), "adaptive", breaker=b).decisions()
    p = pkg.CircuitBreaker(trip_after=1, probe_after=1)
    p.record_failure(0, PUSHDOWN)
    one = [Req(i, node_id=0, query_id="q", cost=_cost(Cost))
           for i in range(4)]
    out["probe"] = sim(one, Res(), "adaptive", breaker=p).decisions()
    out["forced"] = sim(one, Res(), "eager", breaker=b).decisions()
    res = Res()
    arb = Arb(res)
    for _ in range(5):
        arb.release(PUSHDOWN)
        arb.release(PUSHBACK)
    out["capped"] = [arb.free_pd, arb.free_pb] + [
        arb.submit(i, _cost(Cost)) for i in range(res.pd_slots
                                                   + res.pb_slots + 4)] + [
        arb.admitted, arb.pushed_back]
    m = pkg.CircuitBreaker(trip_after=1, probe_after=10 ** 6)
    m.record_failure(3, PUSHDOWN)
    sick, healthy = Arb(res, node_id=3, breaker=m), \
        Arb(res, node_id=4, breaker=m)
    out["mixed"] = ([sick.submit(i, _cost(Cost)) for i in range(4)],
                    [healthy.submit(100 + i, _cost(Cost)) for i in range(4)])
    pa = Arb(Res(), pa_aware=True, node_id=0, breaker=b)
    out["pa"] = [pa.submit(i, _cost(Cost)) for i in range(4)]
    r = pkg.CircuitBreaker(trip_after=1, probe_after=10 ** 6)
    r.record_failure(0, PUSHDOWN)
    slim = Res(cores=1, net_streams=1)
    arb = Arb(slim, node_id=0, breaker=r)
    big = _cost(Cost, s_in=50_000_000)
    out["recovery"] = [arb.submit(0, big), arb.submit(1, big),
                       len(arb.queue)]
    r.record_success(0, PUSHDOWN)
    out["recovery"].append(arb.release(PUSHBACK))
    return out


def test_breaker_routing_matches_the_reference(registries):
    import repro.core.faults as rf
    got = _routing_cases(faults, Arbitrator, StorageResources, RequestCost,
                         SimRequest, simulate)
    want = _routing_cases(rf, RArbitrator, RResources, RRequestCost,
                          RSimRequest, r_simulate)
    assert got == want
    dec = got["tripped"]
    assert all(dec[i] == PUSHBACK for i in range(0, 8, 2))   # node 0
    assert all(dec[i] == PUSHDOWN for i in range(1, 8, 2))   # healthy
    assert {PUSHBACK, PUSHDOWN} <= set(got["probe"].values())
    assert set(got["forced"].values()) == {PUSHDOWN}
    assert got["recovery"] == [[(0, PUSHBACK)], [], 1, [(1, PUSHDOWN)]]
    _same_counters(registries)


# --------------------------- chaos: the same recovery as the reference
@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_chaos_matches_the_reference(qid, cats, registries):
    spec = CHAOS.format(crash=0.25, timeout=0.15, transient=0.2,
                        straggler=0.2)
    clean, _, _, _ = run_both(cats, qid)
    assert clean.recovery is None
    got, want, plan, rplan = run_both(cats, qid, spec, seed=int(qid[1:]),
                                      breaker=True)
    assert_identical(clean.result, got.result, qid)
    check_same_recovery(got, want, plan, rplan)
    assert (sum(1 for o in got.outcomes if o.path == PUSHDOWN)
            + got.n_demoted) == got.n_admitted
    _same_counters(registries)
    counters = registries[0].snapshot()["counters"]
    for kind, n in plan.counts().items():
        assert counters.get(f"faults.{kind}", 0) == n


def test_counters_reconcile_with_the_ledger(cats, registries):
    got, want, plan, rplan = run_both(cats, "Q3", CHAOS.format(
        crash=0.25, timeout=0.15, transient=0.2, straggler=0.2), seed=7)
    check_same_recovery(got, want, plan, rplan)
    counters = registries[0].snapshot()["counters"]
    ledger = plan.counts()
    assert sum(ledger.values()) > 0
    by_np = {}
    for e in plan.events():
        if e.kind in faults.FAILURE_KINDS:
            k = f"faults.node{e.node}.{e.path}.failures"
            by_np[k] = by_np.get(k, 0) + 1
    for k, v in by_np.items():
        assert counters[k] == v, k
    assert got.recovery["faults_injected"] == sum(ledger.values())
    assert got.recovery["retries"] == counters.get("retry.attempts", 0)
    assert got.recovery["n_demoted"] == got.n_demoted
    assert (got.n_demoted > 0) == (counters.get("retry.demotions", 0) > 0)
    _same_counters(registries)


def test_deterministic_schedule_replays_identically(cats):
    spec = CHAOS.format(crash=0.25, timeout=0.15, transient=0.2,
                        straggler=0.2)
    a, _, pa, _ = run_both(cats, "Q5", spec, seed=42)
    b, _, pb, _ = run_both(cats, "Q5", spec, seed=42)
    assert a.recovery == b.recovery
    assert [dataclasses.astuple(o) for o in a.outcomes] == \
        [dataclasses.astuple(o) for o in b.outcomes]
    assert pa.events() == pb.events()


# ------------------------------------------------------ recovery paths
def test_guaranteed_crash_demotes_every_admitted_group(cats, registries):
    clean, _, _, _ = run_both(cats, "Q6")
    got, want, plan, rplan = run_both(cats, "Q6", "pushdown.crash:1.0", 1)
    check_same_recovery(got, want, plan, rplan)
    assert got.n_admitted > 0
    assert got.recovery["n_demoted"] == got.n_admitted
    assert all(o.path == PUSHBACK and o.replayed for o in got.outcomes)
    assert all(o.attempts == FAST.max_attempts
               for o in got.outcomes if o.demoted)
    assert_identical(clean.result, got.result, "Q6 demoted")
    _same_counters(registries)


def test_deadline_budget_exhausts_before_max_attempts(cats, registries):
    kw = dict(sleep_scale=0.0, max_attempts=100, attempt_timeout_s=0.03,
              deadline_s=0.05)
    got, want, plan, rplan = run_both(
        cats, "Q6", "pushdown.timeout:1.0", 2,
        retry=(RetryPolicy(**kw), rfaults.RetryPolicy(**kw)))
    check_same_recovery(got, want, plan, rplan)
    demoted = [o for o in got.outcomes if o.demoted]
    assert demoted and all(o.attempts <= 3 for o in demoted)
    _same_counters(registries)


def test_straggler_completes_without_retry(cats, registries):
    got, want, plan, rplan = run_both(cats, "Q6", "straggler:1.0:0.0001", 3)
    check_same_recovery(got, want, plan, rplan)
    assert got.recovery["n_demoted"] == got.recovery["retries"] == 0
    assert got.recovery["faults_injected"] > 0
    assert registries[0].snapshot()["counters"]["faults.straggler"] == \
        plan.counts()["straggler"]
    _same_counters(registries)


def test_pushback_faults_recover_through_local_replay(cats, registries):
    clean, _, _, _ = run_both(cats, "Q6", mode="no_pushdown")
    got, want, plan, rplan = run_both(cats, "Q6", "pushback.crash:1.0", 5,
                                      mode="no_pushdown")
    check_same_recovery(got, want, plan, rplan)
    assert_identical(clean.result, got.result, "pushback chaos")
    assert got.recovery["n_demoted"] == 0
    counters = registries[0].snapshot()["counters"]
    assert counters.get("retry.local_replays", 0) > 0
    assert counters.get("retry.demotions", 0) == 0
    _same_counters(registries)


def test_fail_to_error_baseline_raises(cats, registries):
    cat, rcat = cats
    strict = RetryPolicy(sleep_scale=0.0, demote_on_exhaust=False)
    with pytest.raises(FaultExhausted) as ei:
        engine.run_query(queries.build_query("Q6"), cat, engine.EngineConfig(
            mode="adaptive", device="cpu", retry=strict,
            faults=FaultPlan.from_spec("pushdown.crash:1.0", seed=4)))
    with pytest.raises(rfaults.FaultExhausted) as rei:
        reng.run_query(rqueries.build_query("Q6"), rcat, reng.EngineConfig(
            mode="adaptive", measured_feedback=False,
            retry=rfaults.RetryPolicy(sleep_scale=0.0,
                                      demote_on_exhaust=False),
            faults=rfaults.FaultPlan.from_spec("pushdown.crash:1.0",
                                               seed=4)))
    assert ei.value.kind == "crash" and ei.value.path == PUSHDOWN
    assert str(ei.value) == str(rei.value)
    _same_counters(registries)


@pytest.mark.parametrize("qid", ("Q3", "Q12", "Q19"))
def test_fault_free_split_is_exactly_prior_behaviour(qid, cats,
                                                     registries):
    """No plan anywhere: the reference's fault-free outcomes and bytes,
    no recovery accounting and no fault counters, on a mixed split."""
    cat, rcat = cats
    reqs = engine.plan_requests(queries.build_query(qid), cat)
    rreqs = reng.plan_requests(rqueries.build_query(qid), rcat)
    decisions = {r.req_id: (PUSHBACK if r.req_id % 3 == 0 else PUSHDOWN)
                 for r in reqs}
    split = runtime.execute_split(reqs, decisions)
    rsplit = rruntime.execute_split(rreqs, decisions)
    assert split.n_demoted == split.retries == split.faults_injected == 0
    assert [dataclasses.astuple(o) for o in split.outcomes] == \
        [dataclasses.astuple(o) for o in rsplit.outcomes]
    assert (split.pushdown_bytes, split.pushback_bytes) == \
        (rsplit.pushdown_bytes, rsplit.pushback_bytes)
    assert all(o.attempts == 1 and not o.demoted and not o.hedged
               for o in split.outcomes)
    assert not any(k.startswith(("faults.", "retry.", "hedge."))
                   for k in registries[0].snapshot()["counters"])


def _span_record(tr):
    """What a traced run's spans say: (name, sorted attribute names) of
    each span in order, and the fault events' coordinates."""
    names = [s.name for s in port_spans.spans(tr)]
    events = [(s.attrs["kind"], s.attrs["node"], s.attrs["table"],
               s.attrs["path"], s.attrs["attempt"])
              for s in tr.find("fault_injected")]
    return names, events


def test_spans_reconcile_with_the_run_and_the_reference(cats):
    """Traced chaos runs: the port's spans are the reference's, in order;
    the fault events are the ledger's; the groups' ``shipped_bytes`` add up to the
    real bytes. With tracing off, nothing is recorded."""
    from repro.obs import trace as rtrace
    from repro_torch.obs import trace
    spec = CHAOS.format(crash=0.25, timeout=0.15, transient=0.2,
                        straggler=0.2)
    assert trace.get_tracer() is trace.NULL_TRACER
    with trace.tracing() as tr, rtrace.tracing() as rtr:
        got, want, plan, rplan = run_both(cats, "Q5", spec, seed=5)
    check_same_recovery(got, want, plan, rplan)
    names, events = _span_record(tr)
    rnames, revents = _span_record(rtr)
    assert names == rnames
    assert events == revents == [(e.kind, e.node, e.table, e.path,
                                  e.attempt) for e in plan.events()]
    assert sum(s.attrs["shipped_bytes"] for s in tr.snapshot()
               if s.name in ("storage_execute", "compute_replay")) == \
        got.real_net_bytes
    (es,) = tr.find("execute_split")
    assert es.attrs["n_demoted"] == got.n_demoted
    assert es.attrs["faults_injected"] == got.recovery["faults_injected"]
    (q,) = tr.find("query")
    assert q.attrs["real_net_bytes"] == got.real_net_bytes
    assert all(s.dur is not None and s.dur >= 0 for s in tr.snapshot())
    assert trace.get_tracer() is trace.NULL_TRACER
    run_both(cats, "Q5", spec, seed=5)
    assert trace.NULL_TRACER.snapshot() == []
