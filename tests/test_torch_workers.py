"""The port's process tier (``repro_torch.distributed.workers``) against
the JAX package's, on the CPU.

The tests mirror ``tests/test_workers.py``: the frame, value and plan
codecs; all 15 compiled queries under seed-7 random decision vectors;
engine modes on both tiers; ``resolve_tier``; the ``pool_for`` registry;
load signals and ``burn``; a dead channel and an overdue request; a kill
mid-stream with and without demotion; split recovery after a kill; a
re-ship after an append; and span stitching. The catalogs are
``tpch.build_catalog(sf=0.3, num_nodes=2, rows_per_partition=3_000)``
on both sides (the same arrays), and a one-node sf=0.05 one for the
tests that need a small catalog.

The port's workers are spawned processes on the CPU, so they run the
plain versions of the kernels. What is held:

- the process tier's merged tables equal the port's in-process
  ``execute_split`` bitwise, and the reference's bitwise except where the
  port's in-process split already differs from it (``SUM_ORDER``: f64
  sums of a keyless aggregate, added in another order; within 1e-12);
- the outcomes, bytes and ``wire.*`` counters of a split equal the
  reference's ``WorkerPool``'s for the same decisions, and after a
  ``kill(0)`` so do the recovery (``n_demoted``, ``retries``, every
  ``RequestOutcome``), the ``faults.*``/``retry.*`` counters and
  ``pool.events``.

Every test starts from fresh metric registries on both sides, and every
pool a test makes is closed in a ``finally`` (the module's shared pools
by their fixtures).
"""
import dataclasses
import json
import os
import socket
import time
import types

import numpy as np
import pytest
import torch

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.core import runtime as rruntime
from repro.core.faults import RetryPolicy as RRetryPolicy
from repro.distributed import workers as RW
from repro.obs import metrics as rmetrics
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnTable as RTable
from repro_torch import kernels
from repro_torch.compiler import QUERY_IDS
from repro_torch.core import engine, runtime
from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN
from repro_torch.core.executor import EXECUTOR_BATCHED, compile_push_plan
from repro_torch.core.faults import FaultExhausted, RetryPolicy, WorkerFault
from repro_torch.core.plan import execute_push_plan
from repro_torch.distributed import workers as W
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as T
from repro_torch.queryproc import queries as Q
from repro_torch.queryproc import tpch
from repro_torch.queryproc.table import ColumnTable

SF, NODES, RPP = 0.3, 2, 3_000
CAT = tpch.build_catalog(sf=SF, num_nodes=NODES, rows_per_partition=RPP,
                         device="cpu")
RCAT = rtpch.build_catalog(SF, 0, NODES, RPP)
FAST = RetryPolicy(sleep_scale=0.0)
RFAST = RRetryPolicy(sleep_scale=0.0)
# (query, table, column) whose merged f64 sums the port's in-process split
# adds in another order than the reference's (a keyless aggregate: the
# reference's np.sum is pairwise), under the seed-7 decisions
SUM_ORDER = {("Q6", "lineitem", "revenue")}
WIRE = ("wire.pushdown_result_bytes", "wire.pushback_ship_bytes")
RECOVERY = ("faults.", "retry.")
DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
          torch.int64, torch.float16, torch.bfloat16, torch.float32,
          torch.float64)


@pytest.fixture(autouse=True)
def registries():
    """(port registry, reference registry), fresh for every test."""
    prev = tmetrics.set_metrics(tmetrics.Metrics())
    rprev = rmetrics.set_metrics(rmetrics.Metrics())
    yield tmetrics.get_metrics(), rmetrics.get_metrics()
    tmetrics.set_metrics(prev)
    rmetrics.set_metrics(rprev)


@pytest.fixture(scope="module")
def pool():
    """One shared pool over CAT for the tests that kill nothing."""
    p = W.WorkerPool(CAT, pd_slots=2)
    try:
        yield p
    finally:
        p.close()


@pytest.fixture(scope="module")
def rpool():
    """The reference's pool over RCAT, for the byte counters."""
    p = RW.WorkerPool(RCAT, pd_slots=2)
    try:
        yield p
    finally:
        p.close()


def counters(m, prefixes):
    return {k: v for k, v in m.snapshot()["counters"].items()
            if k.startswith(prefixes)}


def assert_identical(a: ColumnTable, b: ColumnTable, ctx=""):
    """Same columns in the same order, dtypes and bits."""
    assert a.columns == b.columns, (ctx, a.columns, b.columns)
    for c in a.columns:
        x, y = a.cols[c], b.cols[c]
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, c)
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8)), (ctx, c)


def differing_columns(a: ColumnTable, b, ctx):
    """The columns of port table ``a`` whose bits differ from reference
    table ``b``'s (same names, dtypes and lengths asserted; a differing
    column must be f64 and within rtol 1e-12)."""
    assert a.columns == b.columns, (ctx, a.columns, b.columns)
    out = set()
    for c in a.columns:
        x, y = a.cols[c].numpy(), np.asarray(b.cols[c])
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, c)
        if not np.array_equal(x, y, equal_nan=True):
            assert x.dtype == np.float64, (ctx, c)
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=0.0)
            out.add(c)
    return out


def outcomes(split):
    return [dataclasses.astuple(o) for o in split.outcomes]


def small_catalog():
    return tpch.build_catalog(sf=0.05, num_nodes=1, rows_per_partition=500,
                              device="cpu")


def wait_dead(p, node):
    deadline = time.monotonic() + 10.0
    while p.alive(node) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not p.alive(node)


def random_decisions():
    """The seed-7 decision vector of every query, drawn in QUERY_IDS
    order as ``tests/test_workers.py`` draws them."""
    rng = np.random.default_rng(7)
    out = {}
    for qid in QUERY_IDS:
        reqs = engine.plan_requests(Q.build_query(qid), CAT)
        out[qid] = {r.req_id: (PUSHDOWN if rng.random() < 0.5 else PUSHBACK)
                    for r in reqs}
    return out


DECISIONS = random_decisions()


# ---------------------------------------------------------------- the codec
def test_frame_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    try:
        hdr = {"kind": "exec", "req": 7, "parts": [["lineitem", 0]]}
        body = bytes(range(256)) * 3
        sent = W._write_frame(a, hdr, body)
        got_hdr, got_body, total = W._read_frame(b)
        assert got_hdr == hdr
        assert bytes(got_body) == body
        assert total == sent          # wire-byte accounting is symmetric
        # a body given as buffers is the same frame as its join
        sent2 = W._write_frame(a, hdr, [body[:100], memoryview(body[100:])])
        got_hdr, got_body, total = W._read_frame(b)
        assert (got_hdr, bytes(got_body), total) == (hdr, body, sent2)
        assert sent2 == sent
    finally:
        a.close()
        b.close()


def _roundtrip(val):
    bufs = []
    spec = W._enc(val, bufs)
    json.dumps(spec)      # the header side is JSON; the bytes ride apart
    body = bytearray(b"".join(bytes(memoryview(x)) for x in bufs))
    return W._dec(spec, W._Cursor(body), torch.device("cpu")), body


@pytest.mark.parametrize("dtype", DTYPES, ids=[str(d)[6:] for d in DTYPES])
def test_value_codec_covers_the_dtype(dtype):
    """A tensor of every dtype, empty, 0-d and 2-d, survives the codec
    with its dtype, shape and bits, and a decoded host tensor is
    writable."""
    g = torch.Generator().manual_seed(0)
    full = (torch.rand(37, generator=g) * 100).to(dtype)
    vals = [full, full[:0], full[5].clone(), full[:36].reshape(6, 6),
            full[::3]]
    out, _ = _roundtrip(vals)
    for want, got in zip(vals, out):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(-1).view(torch.uint8),
                           want.reshape(-1).contiguous().view(torch.uint8))
    if len(out[0]):
        out[0][0] = out[0][1]          # writable: no read-only frombuffer


def test_the_codec_covers_every_dtype_the_tables_hold():
    held = {v.dtype for parts in CAT.tables.values() for p in parts
            for v in p.data.cols.values()}
    assert held <= set(DTYPES)


def test_value_codec_roundtrip_and_writability():
    """Everything a push-plan result or aux dict holds survives the
    tagged codec: nested containers, mixed dtypes, empty tables."""
    g = torch.Generator().manual_seed(0)
    tab = ColumnTable({"a": torch.randint(0, 9, (50,), generator=g,
                                          dtype=torch.int32),
                       "b": torch.randn(50, generator=g,
                                        dtype=torch.float64),
                       "c": torch.randint(0, 2, (50,), generator=g) > 0})
    words = torch.tensor([0x1FFFF, -1], dtype=torch.int32)
    val = {"tables": [tab, ColumnTable({"x": torch.zeros(0,
                                                         dtype=torch.float64)})],
           "aux": ({"bitmap": words, "rows": 17, "sel": 0.25, "tag": "q1",
                    "none": None, "scalar": torch.tensor(2.5)},
                   [torch.arange(6, dtype=torch.int64).reshape(2, 3), True]),
           3: "int-keyed"}
    out, _ = _roundtrip(val)
    t0, t1 = out["tables"]
    assert_identical(tab, t0)
    assert t1.columns == ["x"] and len(t1) == 0
    aux, lst = out["aux"]
    assert isinstance(out["aux"], tuple) and isinstance(lst, list)
    assert torch.equal(aux["bitmap"], words)
    assert aux["rows"] == 17 and aux["sel"] == 0.25 and aux["tag"] == "q1"
    assert aux["none"] is None and out[3] == "int-keyed"
    assert aux["scalar"].shape == () and float(aux["scalar"]) == 2.5
    assert torch.equal(lst[0], torch.arange(6).reshape(2, 3)) and lst[1]
    t0.cols["a"][0] = 99              # writable
    assert int(t0.cols["a"][0]) == 99
    with pytest.raises(TypeError):
        W._enc(object(), [])


@pytest.mark.parametrize("qid", QUERY_IDS)
def test_plan_codec_survives_derive_lambdas(qid):
    """Every compiled plan, ``derive`` lambdas included, round-trips to a
    plan that runs bitwise like the original on a partition; a plan
    encodes to the same bytes every time (the pool's plan key)."""
    for table, plan in Q.build_query(qid).plans.items():
        spec = W.encode_plan(plan)
        back = W.decode_plan(spec)
        data = CAT.tables[table][0].data
        ref, _ = execute_push_plan(plan, data)
        got, _ = execute_push_plan(back, data)
        assert_identical(ref, got, (qid, table))
        assert W.encode_plan(plan) == spec
    if qid == "Q1":
        assert Q.build_query(qid).plans["lineitem"].derive


# ------------------------------------------------------- the tier oracle
@pytest.mark.parametrize("qid", QUERY_IDS)
def test_all_queries_byte_identical_random_decision_vectors(qid, pool,
                                                            rpool,
                                                            registries):
    """All 15 compiled queries under the seed-7 random decision vector:
    the process tier's merged tables equal the in-process split's
    bitwise and the reference's but for ``SUM_ORDER``; the outcomes, the
    bytes and the ``wire.*`` counters equal the reference pool's."""
    m, rm = registries
    dec = DECISIONS[qid]
    reqs = engine.plan_requests(Q.build_query(qid), CAT)
    rreqs = reng.plan_requests(rqueries.build_query(qid), RCAT)
    assert [r.req_id for r in reqs] == [r.req_id for r in rreqs]
    ref = runtime.execute_split(reqs, dec)
    got = runtime.execute_split(reqs, dec, retry=FAST, tier=pool)
    want = rruntime.execute_split(rreqs, dec, retry=RFAST, tier=rpool)
    assert set(ref.merged) == set(got.merged) == set(want.merged)
    moved = set()
    for table in ref.merged:
        assert_identical(ref.merged[table], got.merged[table], (qid, table))
        moved |= {(qid, table, c) for c in differing_columns(
            got.merged[table], want.merged[table], (qid, table))}
    assert moved == {k for k in SUM_ORDER if k[0] == qid}
    assert (got.n_pushdown, got.n_pushback) == (ref.n_pushdown,
                                                ref.n_pushback)
    assert got.n_demoted == got.retries == 0     # healthy workers
    assert outcomes(got) == outcomes(ref) == outcomes(want)
    assert (got.pushdown_bytes, got.pushback_bytes) == \
        (want.pushdown_bytes, want.pushback_bytes)
    assert counters(m, WIRE) == counters(rm, WIRE)
    assert counters(m, RECOVERY) == counters(rm, RECOVERY)


def test_engine_modes_byte_identical_across_tiers(pool):
    """``run_query`` through the whole engine gives the same result on
    both tiers in every mode, and the reference's rows."""
    for qid in ("Q1", "Q6", "Q12"):
        for mode in ("adaptive", "eager", "no_pushdown"):
            base = engine.EngineConfig(mode=mode, device="cpu",
                                       measured_feedback=False)
            proc = engine.EngineConfig(mode=mode, device="cpu",
                                       measured_feedback=False,
                                       worker_pool=pool, retry=FAST)
            ref = engine.run_query(Q.build_query(qid), CAT, base)
            got = engine.run_query(Q.build_query(qid), CAT, proc)
            want = reng.run_query(rqueries.build_query(qid), RCAT,
                                  reng.EngineConfig(mode=mode,
                                                    measured_feedback=False))
            assert_identical(ref.result, got.result, (qid, mode))
            assert got.real_net_bytes == ref.real_net_bytes \
                == want.real_net_bytes
            assert reng.results_equal(
                RTable(got.result.to_numpy()), want.result)


def test_wire_bytes_flow_and_counters(pool, rpool, registries):
    """Pushdown results and pushback projections cross the wire as
    serialized bytes, counted by ``wire.*`` as the reference counts
    them."""
    m, rm = registries
    reqs = engine.plan_requests(Q.build_query("Q6"), CAT)
    rreqs = reng.plan_requests(rqueries.build_query("Q6"), RCAT)
    half = {r.req_id: (PUSHDOWN if i % 2 == 0 else PUSHBACK)
            for i, r in enumerate(reqs)}
    before = pool.wire_bytes()
    runtime.execute_split(reqs, half, retry=FAST, tier=pool)
    rruntime.execute_split(rreqs, half, retry=RFAST, tier=rpool)
    after = pool.wire_bytes()
    assert after["sent"] > before["sent"]
    assert after["recv"] > before["recv"]
    c = counters(m, WIRE)
    assert c.get("wire.pushdown_result_bytes", 0) > 0
    assert c.get("wire.pushback_ship_bytes", 0) > 0
    assert c == counters(rm, WIRE)


def test_storage_tier_config_resolution():
    cfg = engine.EngineConfig(device="cpu")
    assert engine.resolve_tier(cfg, CAT) is None
    assert engine.resolve_tier(
        engine.EngineConfig(device="cpu", storage_tier=None), CAT) is None
    stand_in = types.SimpleNamespace(device=torch.device("cpu"))
    assert engine.resolve_tier(
        engine.EngineConfig(device="cpu", worker_pool=stand_in),
        CAT) is stand_in
    with pytest.raises(ValueError):
        engine.resolve_tier(engine.EngineConfig(device="cpu",
                                                storage_tier="bogus"), CAT)
    elsewhere = types.SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError):    # a pool on another device
        engine.resolve_tier(engine.EngineConfig(device="cpu",
                                                worker_pool=elsewhere), CAT)
    assert engine.STORAGE_TIERS == ("inproc", "process")


def test_pool_for_registry_reuses_and_closes():
    cat = small_catalog()
    try:
        p1 = W.pool_for(cat, pd_slots=1)
        assert W.pool_for(cat) is p1      # one pool per catalog
        cfg = engine.EngineConfig(device="cpu", storage_tier="process",
                                  measured_feedback=False)
        assert engine.resolve_tier(cfg, cat) is p1
        run = engine.run_query(Q.build_query("Q6"), cat, cfg)
        base = engine.run_query(Q.build_query("Q6"), cat, dataclasses.replace(
            cfg, storage_tier="inproc"))
        assert_identical(base.result, run.result)
    finally:
        W.close_all_pools()
    assert p1.closed
    try:
        p2 = W.pool_for(cat, pd_slots=1)  # a closed pool is replaced
        assert p2 is not p1 and not p2.closed
    finally:
        W.close_all_pools()


# ----------------------------------------------------------- load signals
def test_load_signals_published_and_burn_pressure(pool, rpool, registries):
    """Every worker publishes queue depth, in-flight count and CPU into
    the gauges ``MeasuredLoad`` reads, with the reference's snapshot keys
    and its own kernel launches (none on the CPU); ``burn`` raises real
    pressure that shows in those gauges."""
    m, _ = registries
    loads = pool.publish_load()
    rloads = rpool.publish_load()
    assert set(loads) == set(rloads) == {0, 1}
    for node, snap in loads.items():
        assert set(snap) - {"launches"} == set(rloads[node])
        assert snap["launches"] == dict.fromkeys(kernels.WRAPPERS, 0)
    g = m.snapshot()["gauges"]
    for node in (0, 1):
        assert f"stream.node{node}.exec_queue" in g
        assert f"stream.node{node}.ship_queue" in g
        assert f"storage.node{node}.inflight" in g
    done0 = loads[0]["done"]
    pool.burn(0, 0.05, tasks=6)           # 6 x 50 ms on 2 slots
    busy = pool.publish_load()[0]
    assert busy["exec_q"] + busy["inflight"] > 0
    assert m.snapshot()["gauges"]["stream.node0.exec_queue"] == \
        busy["exec_q"]
    deadline = time.monotonic() + 10.0
    max_cpu = busy.get("cpu") or 0.0
    while time.monotonic() < deadline:
        snap = pool.publish_load()[0]
        max_cpu = max(max_cpu, snap.get("cpu") or 0.0)
        if snap["done"] >= done0 + 6:
            break
        time.sleep(0.02)
    assert snap["done"] >= done0 + 6
    assert max_cpu > 0


# --------------------------------------------- real faults -> recovery
def test_a_cuda_worker_without_a_card_fails_to_start():
    """A worker asked for CUDA where there is none reports its error and
    the channel raises it; it does not carry on with the plain
    versions."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the worker would start")
    ch = W.WorkerChannel(0, 1, torch.device("cuda"))
    try:
        with pytest.raises(RuntimeError, match="could not start on cuda"):
            ch.started()
    finally:
        ch.close()
    assert not ch.proc.is_alive()


def test_dead_channel_raises_workerfault_and_records():
    p = W.WorkerPool(CAT, pd_slots=1)
    try:
        p.kill(1)
        reqs = engine.plan_requests(Q.build_query("Q6"), CAT)
        sub = [r for r in reqs if r.part.node_id == 1]
        cplan = compile_push_plan(sub[0].plan)
        wait_dead(p, 1)
        with pytest.raises(WorkerFault) as ei:
            p.execute_group(cplan, sub, EXECUTOR_BATCHED)
        assert ei.value.kind == "crash" and ei.value.node == 1
        assert p.fault_counts() == {"crash": 1}
        assert p.events == [{"kind": "crash", "node": 1, "table": "lineitem",
                             "op": "exec"}]
        assert p.alive(0)                 # the blast radius is one node
    finally:
        p.close()


def test_overdue_request_raises_workerfault_timeout():
    cat = small_catalog()
    p = W.WorkerPool(cat, pd_slots=1, request_timeout_s=0.05)
    try:
        p.burn(0, 0.6, tasks=2)           # the only slot and the queue
        reqs = engine.plan_requests(Q.build_query("Q6"), cat)
        cplan = compile_push_plan(reqs[0].plan)
        with pytest.raises(WorkerFault) as ei:
            p.execute_group(cplan, reqs[:1], EXECUTOR_BATCHED)
        assert ei.value.kind == "timeout"
        assert p.fault_counts() == {"timeout": 1}
        assert p.alive(0)                 # overdue, not dead
    finally:
        p.close()


def stream_of(qids):
    return [runtime.StreamQuery(Q.build_query(q), 0.0) for q in qids]


def test_stream_worker_kill_mid_wave_recovers_and_reconciles():
    """A worker SIGKILLs itself mid-wave (its pinned ``die_after``
    schedule); the stream recovers by retry and demotion with results
    equal to the clean in-process stream's, and the pool's real-fault
    ledger reconciles with the ``faults.*`` counters."""
    qids = ["Q1", "Q6", "Q12"]
    clean = runtime.run_stream(stream_of(qids), CAT, engine.EngineConfig(
        device="cpu", measured_feedback=False), time_scale=0)
    tmetrics.set_metrics(tmetrics.Metrics())
    p = W.WorkerPool(CAT, pd_slots=2)
    try:
        p.die_after(0, 2)                 # node 0 dies at its 3rd item
        cfg = engine.EngineConfig(device="cpu", worker_pool=p, retry=FAST,
                                  measured_feedback=False)
        run = runtime.run_stream(stream_of(qids), CAT, cfg, time_scale=0)
        for qid in qids:
            assert_identical(clean.results[qid], run.results[qid], qid)
        assert not p.alive(0) and p.alive(1)
        assert run.n_demoted > 0
        c = tmetrics.get_metrics().snapshot()["counters"]
        events = p.events
        assert len(events) > 0 and all(ev["node"] == 0 for ev in events)
        assert c.get("faults.crash", 0) + c.get("faults.timeout", 0) == \
            len(events)
        assert sum(v for k, v in c.items() if k.startswith("faults.node")
                   and k.endswith(".failures")) == len(events)
        assert c.get("retry.demotions", 0) + \
            c.get("retry.local_replays", 0) > 0
        assert run.retries == c.get("retry.attempts", 0)
    finally:
        p.close()


def test_stream_worker_kill_no_demote_aggregates_error():
    """With ``demote_on_exhaust=False`` a killed worker surfaces as the
    stream's RuntimeError whose cause is the ``FaultExhausted``."""
    p = W.WorkerPool(CAT, pd_slots=2)
    try:
        p.die_after(0, 0)                 # the first work item kills it
        cfg = engine.EngineConfig(
            device="cpu", worker_pool=p,
            retry=RetryPolicy(sleep_scale=0.0, demote_on_exhaust=False),
            measured_feedback=False)
        with pytest.raises(RuntimeError) as ei:
            runtime.run_stream(stream_of(["Q6"]), CAT, cfg, time_scale=0)
        assert isinstance(ei.value.__cause__, FaultExhausted)
        assert ei.value.__cause__.kind == "crash"
    finally:
        p.close()


def test_split_recovery_after_kill_is_byte_identical(registries):
    """``execute_split`` against a killed worker on both packages: every
    node-0 group demotes, the merged tables equal the in-process split's,
    and the recovery, the counters and the real-fault ledger equal the
    reference pool's under the same kill."""
    m, rm = registries
    p = W.WorkerPool(CAT, pd_slots=1)
    rp = RW.WorkerPool(RCAT, pd_slots=1)
    try:
        p.kill(0)
        rp.kill(0)
        wait_dead(p, 0)
        wait_dead(rp, 0)
        reqs = engine.plan_requests(Q.build_query("Q14"), CAT)
        rreqs = reng.plan_requests(rqueries.build_query("Q14"), RCAT)
        dec = {r.req_id: PUSHDOWN for r in reqs}
        ref = runtime.execute_split(reqs, dec)
        got = runtime.execute_split(reqs, dec, retry=FAST, tier=p)
        want = rruntime.execute_split(rreqs, dec, retry=RFAST, tier=rp)
        for table in ref.merged:
            assert_identical(ref.merged[table], got.merged[table], table)
            assert not differing_columns(got.merged[table],
                                         want.merged[table], table)
        assert got.n_demoted == sum(1 for r in reqs if r.part.node_id == 0)
        assert {o.req_id for o in got.outcomes if o.demoted} == \
            {r.req_id for r in reqs if r.part.node_id == 0}
        assert (got.n_demoted, got.retries, got.n_pushdown,
                got.n_pushback) == (want.n_demoted, want.retries,
                                    want.n_pushdown, want.n_pushback)
        assert outcomes(got) == outcomes(want)
        assert counters(m, RECOVERY) == counters(rm, RECOVERY)
        assert counters(m, WIRE) == counters(rm, WIRE)
        assert p.events == rp.events and len(p.events) > 0
    finally:
        p.close()
        rp.close()


# ------------------------------------------------------ staleness + tracing
def test_catalog_mutation_triggers_reship():
    """``append_to_partition`` bumps the version; the pool re-ships the
    stale partition, so the worker never serves old bytes."""
    cat = small_catalog()
    p = W.WorkerPool(cat, pd_slots=1)
    try:
        q = Q.build_query("Q6")
        reqs = engine.plan_requests(q, cat)
        dec = {r.req_id: PUSHDOWN for r in reqs}
        before = runtime.execute_split(reqs, dec, retry=FAST, tier=p)
        part = cat.tables["lineitem"][0]
        extra = ColumnTable({c: v[:64].clone()
                             for c, v in part.data.cols.items()})
        cat.append_to_partition("lineitem", 0, extra)
        reqs2 = engine.plan_requests(q, cat)
        dec2 = {r.req_id: PUSHDOWN for r in reqs2}
        ref = runtime.execute_split(reqs2, dec2)
        got = runtime.execute_split(reqs2, dec2, retry=FAST, tier=p)
        assert_identical(ref.merged["lineitem"], got.merged["lineitem"],
                         "post-append")
        b, g = before.merged["lineitem"], got.merged["lineitem"]
        assert any(not torch.equal(b.cols[c], g.cols[c]) for c in b.columns)
    finally:
        p.close()


def test_worker_spans_stitched_into_compute_trace(pool):
    """Worker spans come back in the response and are adopted under the
    dispatching span, echo it as ``remote_parent`` and carry the
    worker's pid."""
    reqs = engine.plan_requests(Q.build_query("Q6"), CAT)
    dec = {r.req_id: (PUSHDOWN if i % 2 == 0 else PUSHBACK)
           for i, r in enumerate(reqs)}
    with T.tracing() as tr:
        runtime.execute_split(reqs, dec, retry=FAST, tier=pool)
    execs = tr.find("worker_execute")
    fetches = tr.find("worker_fetch")
    assert execs and fetches
    sids = {s.sid: s for s in tr.snapshot()}
    for sp in execs + fetches:
        assert sp.cat == "worker"
        assert sp.attrs["pid"] != os.getpid()
        assert sp.attrs["pid"] in {w["pid"] for w in pool.workers.values()}
        assert sp.dur is not None and sp.dur >= 0
        assert sp.parent is not None
        assert sp.attrs["remote_parent"] == sp.parent
        assert sids[sp.parent].name in ("storage_execute", "compute_replay")
    assert {sp.attrs["node"] for sp in execs} <= {0, 1}
