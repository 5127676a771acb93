"""The port's tracing, decision channels, metrics and exporters against
the JAX package's, on the CPU.

Both sides run on the sf=1, 2-node, 4,000-row catalog of
``tests/test_obs.py``: the reference's from
``repro.queryproc.tpch.build_catalog``, the port's from the same arrays
through ``catalog_from_arrays``. Every test gives both sides fresh metric
registries and runs the default ``measured_feedback`` on both: from a
fresh registry no queue depth has been published, so both Arbitrators
read their fluid queues. Span trees are compared by their names, parents
and attribute keys; the arbitrate decision channel's snapshot, the
filter decisions and the ``stream.*``/``engine.*`` counters for exact
equality. The port's own guarantees are held as the reference's tests
hold the reference's: tracing never changes a result, and the bytes a
trace's execution spans claim equal the run's real bytes exactly. The
spans the port adds (``tests/port_spans.py``: the residual's ``op.*``
spans, ``gc``, ``device_sync`` and the uncosted ``compile``) are left out
of every comparison with the reference and held on their own.
"""
import contextlib
import dataclasses
import gc
import json
import signal
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import port_spans

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.compiler import compile as rcompile
from repro.core import executor as rexecutor
from repro.core import runtime as rruntime
from repro.core.cost import StorageResources as RResources
from repro.obs import export as rexport
from repro.obs import metrics as rmetrics
from repro.obs import trace as rtrace
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnTable as RTable
from repro_torch import compiler
from repro_torch.core import bitmap as bm
from repro_torch.core import engine, executor, runtime
from repro_torch.core.cost import StorageResources
from repro_torch.obs import export, metrics, trace
from repro_torch.obs.trace import (NULL_SPAN, NULL_TRACER, DecisionChannel,
                                   Tracer, get_tracer, tracing)
from repro_torch.queryproc import operators as ops
from repro_torch.queryproc import queries
from repro_torch.queryproc.expressions import Col
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays

ROOT = Path(__file__).resolve().parents[1]
SF, SEED, NODES, RPP = 1.0, 0, 2, 4000
STREAM_QIDS = ("Q1", "Q6", "Q12", "Q18")


@pytest.fixture(scope="module")
def cats():
    arrays = {n: t.cols for n, t in rtpch.generate_tables(SF, SEED).items()}
    return (catalog_from_arrays(arrays, NODES, RPP, device="cpu"),
            rtpch.build_catalog(SF, SEED, NODES, RPP))


@pytest.fixture(scope="module")
def ccats():
    """The catalogs with lineitem clustered by ``l_orderkey``."""
    arrays = {n: t.cols for n, t in rtpch.generate_tables(SF, SEED).items()}
    cluster = {"lineitem": "l_orderkey"}
    return (catalog_from_arrays(arrays, NODES, RPP, device="cpu",
                                cluster=cluster),
            rtpch.build_catalog(SF, SEED, NODES, RPP, cluster=cluster))


@pytest.fixture(autouse=True)
def registries():
    """(port registry, reference registry), fresh for every test."""
    prev = metrics.set_metrics(metrics.Metrics())
    rprev = rmetrics.set_metrics(rmetrics.Metrics())
    yield metrics.get_metrics(), rmetrics.get_metrics()
    metrics.set_metrics(prev)
    rmetrics.set_metrics(rprev)


def _cfg(mode="adaptive", power=1.0, **kw):
    return engine.EngineConfig(res=StorageResources(storage_power=power),
                               mode=mode, device="cpu", **kw)


def _rcfg(mode="adaptive", power=1.0, **kw):
    return reng.EngineConfig(res=RResources(storage_power=power), mode=mode,
                             **kw)


def assert_identical(a: ColumnTable, b: ColumnTable, ctx=""):
    """Same columns in the same order, dtypes and values bitwise."""
    assert a.columns == b.columns, (ctx, a.columns, b.columns)
    for c in a.columns:
        x, y = a.cols[c], b.cols[c]
        assert x.dtype == y.dtype, (ctx, c, x.dtype, y.dtype)
        assert np.array_equal(x.numpy(), y.numpy(), equal_nan=True), (ctx, c)


def same_result(got: ColumnTable, want) -> bool:
    return reng.results_equal(RTable(got.to_numpy()), want)


def shape(node):
    """A span tree's names, attribute keys and children, in order."""
    return (node["name"], sorted(node["attrs"]),
            [shape(c) for c in node["children"]])


def shape_unordered(node):
    """``shape`` with each span's children as a sorted multiset: spans of
    concurrent workers open in no fixed order."""
    return (node["name"], tuple(sorted(node["attrs"])),
            tuple(sorted(shape_unordered(c) for c in node["children"])))


def multi_element_tensors(obj, path="attrs"):
    """Paths of every tensor of more than one element inside ``obj``."""
    if isinstance(obj, torch.Tensor):
        return [path] if obj.numel() > 1 else []
    if isinstance(obj, dict):
        return [p for k, v in obj.items()
                for p in multi_element_tensors(v, f"{path}.{k}")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj)
                for p in multi_element_tensors(v, f"{path}[{i}]")]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [p for f in dataclasses.fields(obj)
                for p in multi_element_tensors(getattr(obj, f.name),
                                               f"{path}.{f.name}")]
    return []


def stream_of(qids, gap):
    return ([runtime.StreamQuery(queries.build_query(q), arrival=i * gap)
             for i, q in enumerate(qids)],
            [rruntime.StreamQuery(rqueries.build_query(q), arrival=i * gap)
             for i, q in enumerate(qids)])


# ------------------------------------------------------------- tracer core
def test_default_tracer_is_disabled_noop():
    tr = get_tracer()
    assert tr is NULL_TRACER and not tr.enabled
    with tr.span("anything", foo=1) as sp:
        assert not sp
        sp.set(bar=2)
    assert tr.snapshot() == [] and tr.tree() == []
    assert tr.start("x") is NULL_SPAN and tr.current() is None
    tr.end(NULL_SPAN, y=3)
    tr.decisions.record(kind="x")
    assert len(tr.decisions) == 0


def test_span_nesting_and_parenting():
    with tracing() as tr:
        with tr.span("a") as a:
            with tr.span("b"):
                assert tr.current().name == "b"
                tr.event("e")
            det = tr.start("c", parent=a)
            assert tr.current() is a       # a detached span is never current
        tr.end(det, done=True)
    (ra,) = port_spans.strip(tr.tree())
    assert ra["name"] == "a"
    assert [c["name"] for c in ra["children"]] == ["b", "c"]
    assert ra["children"][0]["children"][0]["name"] == "e"
    assert ra["children"][0]["children"][0]["dur"] == 0.0
    assert ra["children"][1]["attrs"] == {"done": True}
    assert all(s.dur is not None for s in tr.snapshot())


def test_tracer_max_spans_drops_not_grows():
    tr = Tracer(max_spans=3)
    with tracing(tr), port_spans.no_collections():
        for _ in range(10):
            tr.event("e")
    assert len(tr.snapshot()) == 3 and tr.dropped == 7


def test_cross_thread_detached_span():
    with tracing() as tr:
        root = tr.start("root")

        def worker():
            with tr.span("child", parent=root):
                pass
            tr.end(root)

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    (rt,) = port_spans.strip(tr.tree())
    assert rt["name"] == "root" and rt["dur"] is not None
    assert [c["name"] for c in rt["children"]] == ["child"]


def test_sink_hears_every_open_and_close():
    heard = []

    class Sink:
        def on_start(self, sp):
            heard.append(("start", sp.name))

        def on_end(self, sp):
            heard.append(("end", sp.name, sp.dur is not None))

    tr = Tracer().attach_sink(Sink())
    with tracing(tr), port_spans.no_collections():
        with tr.span("a"):
            tr.event("e")
        s = tr.start("d")
        tr.end(s)
        tr.amend(s, late=1)
    assert heard == [("start", "a"), ("start", "e"), ("end", "e", True),
                     ("end", "a", True), ("start", "d"), ("end", "d", True),
                     ("end", "d", True)]


# -------------------------------------------------------- decision channel
def test_decision_channel_cap_and_counts():
    for ch in (DecisionChannel(cap=4), rtrace.DecisionChannel(cap=4)):
        for i in range(10):
            ch.record(branch="gather" if i % 2 else "concat", i=i)
        assert len(ch) == 4 and ch.dropped == 6
        assert ch.counts("branch") == {"concat": 2, "gather": 2}
        ch.record_batch([(1, "pushdown"), (2, "pushback")], kind="k")
        assert len(ch) == 4 and ch.dropped == 8
        ch.clear()
        assert len(ch) == 0 and ch.dropped == 0


def test_decision_channel_batches_expand_like_the_reference():
    ch, rch = DecisionChannel(), rtrace.DecisionChannel()
    for c in (ch, rch):
        c.record_batch([(3, "pushdown"), (4, "pushback")], kind="arbitrate",
                       queue_depth=2, free_pd=0, free_pb=1)
        c.record(kind="one", req_id=5)
        c.record_batch([], kind="none")
    assert ch.snapshot() == rch.snapshot()
    assert len(ch) == len(rch) == 3
    assert ch.counts("path") == rch.counts("path")


def test_decision_channel_thread_safety():
    ch = DecisionChannel(cap=50_000)
    n_threads, per = 8, 2_000
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda k=k: [ch.record(k=k, i=i) for i in range(per)])
            for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert len(ch) == n_threads * per and ch.dropped == 0
    assert ch.counts("k") == {k: per for k in range(n_threads)}


@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_filter_decisions_match_the_reference(cats, registries, qid):
    """One ``concat`` decision wherever the reference records a batch,
    with its estimate, partitions and rows; ``executor.filter.*`` counts
    them."""
    cat, rcat = cats
    executor.reset_filter_decisions()
    rexecutor.reset_filter_decisions()
    engine.execute_requests(engine.plan_requests(queries.build_query(qid),
                                                 cat))
    reng.execute_requests(reng.plan_requests(rqueries.build_query(qid), rcat))
    got = trace.filter_decision_channel().snapshot()
    want = rtrace.filter_decision_channel().snapshot()
    assert [d["branch"] for d in got] == ["concat"] * len(want)
    assert [{k: v for k, v in d.items() if k != "branch"} for d in got] == \
        [{k: v for k, v in d.items() if k != "branch"} for d in want]
    counts = executor.filter_decision_counts()
    assert counts == {"gather": 0, "concat": len(want)}
    m, _ = registries
    assert m.snapshot()["counters"].get("executor.filter.concat", 0) == \
        len(want)


def test_filter_decision_of_an_apply_bitmap_batch_is_exact(cats):
    cat, _ = cats
    parts = [p.data for p in cat.partitions_of("lineitem")][:3]
    words = [ops.selection_bitmap(p, Col("l_quantity") <= 25) for p in parts]
    executor.reset_filter_decisions()
    bm.compute_side_apply_batched(parts, words, ("l_orderkey",))
    (d,) = trace.filter_decision_channel().snapshot()
    rows = sum(len(p) for p in parts)
    kept = sum(int((p.cols["l_quantity"] <= 25).sum()) for p in parts)
    assert d == {"table": "lineitem", "est_selectivity": kept / rows,
                 "branch": "concat", "n_parts": 3, "rows": rows}


# --------------------------------------------------------------- metrics
def test_metrics_registry_and_epoch_match_the_reference():
    outs = []
    for m in (metrics.Metrics(), rmetrics.Metrics()):
        m.counter("a").inc()
        m.counter("a").inc(4)
        m.gauge("g").set(2.5)
        for v in (1, 2, 1000):
            m.histogram("h").observe(v)
        e1 = m.epoch()
        m.counter("a").inc(2)
        e2 = m.epoch()
        assert e1["counters"]["a"] == 5.0 and e2["counters"]["a"] == 2.0
        assert e2["epoch"] == e1["epoch"] + 1
        outs.append((m.snapshot(), e1, e2))
    assert outs[0] == outs[1]


def test_engine_metrics_counters(cats, registries):
    cat, rcat = cats
    run = engine.run_query(queries.build_query("Q6"), cat, _cfg())
    reng.run_query(rqueries.build_query("Q6"), rcat, _rcfg())
    m, rm = registries
    snap = m.snapshot()
    assert snap["counters"]["engine.queries"] == 1
    assert snap["counters"]["engine.requests.pushdown"] == run.n_admitted
    assert snap["counters"]["engine.net_bytes.real"] == run.real_net_bytes
    engine_counters = [{k: v for k, v in r.snapshot()["counters"].items()
                        if k.startswith(("engine.", "executor."))}
                       for r in (m, rm)]
    assert engine_counters[0]["executor.filter.concat"] == \
        sum(engine_counters[1].get(f"executor.filter.{b}", 0)
            for b in ("concat", "gather"))
    for counters in engine_counters:
        counters.pop("executor.filter.concat", None)
        counters.pop("executor.filter.gather", None)
    assert engine_counters[0] == engine_counters[1]


# ------------------------------------------------- span-tree goldens
def test_span_tree_golden_q1(cats):
    cat, rcat = cats
    with tracing() as tr, rtrace.tracing() as rtr:
        run = engine.run_query(queries.build_query("Q1"), cat, _cfg())
        reng.run_query(rqueries.build_query("Q1"), rcat, _rcfg())
    (qt,) = port_spans.strip(tr.tree())
    assert shape(qt) == shape(rtr.tree()[0])
    assert qt["name"] == "query" and qt["attrs"]["qid"] == "Q1"
    assert [c["name"] for c in qt["children"]] == [
        "plan_requests", "arbitrate", "execute_split", "residual_compute"]
    es = qt["children"][2]
    inner = [c["name"] for c in es["children"]]
    assert inner[-1] == "merge" and "storage_execute" in inner
    assert es["attrs"]["pushdown_bytes"] + es["attrs"]["pushback_bytes"] \
        == qt["attrs"]["real_net_bytes"] == run.real_net_bytes


def test_span_tree_golden_q19_costed(cats):
    cat, rcat = cats
    with tracing() as tr, rtrace.tracing() as rtr:
        cq = compiler.compile_query_costed("q19", cat)
        engine.run_query(cq.query, cat, _cfg())
        rcq = rcompile.compile_query_costed("q19", rcat)
        reng.run_query(rcq.query, rcat, _rcfg())
    forest = port_spans.strip(tr.tree())
    assert [shape(t) for t in forest] == [shape(t) for t in rtr.tree()]
    assert [t["name"] for t in forest] == ["compile", "query"]
    comp, rcomp = forest[0], rtr.tree()[0]
    cuts = [c for c in comp["children"] if c["name"] == "cut_scoring"]
    assert {c["attrs"]["table"] for c in cuts} == {"lineitem", "part"}
    for c in cuts:
        assert len(c["attrs"]["scores"]) == len(c["attrs"]["signatures"]) \
            == c["attrs"]["maximal"] + 1
        assert 0 <= c["attrs"]["chosen"] <= c["attrs"]["maximal"]
    strip = [{k: v for k, v in c["attrs"].items() if k != "scores"}
             for c in comp["children"]]
    assert strip == [{k: v for k, v in c["attrs"].items() if k != "scores"}
                     for c in rcomp["children"]]
    for c, rc in zip(comp["children"], rcomp["children"]):
        assert c["attrs"]["scores"] == pytest.approx(rc["attrs"]["scores"],
                                                     rel=1e-12)
    assert comp["attrs"]["frontier"] == rcomp["attrs"]["frontier"]


def test_span_tree_golden_q18_clustered_having(ccats):
    """The clustered-catalog Q18 trace: the chooser's ``cut_scoring``
    event picks the ``scan+agg+having`` candidate and the executed plan's
    signature carries it, as in the reference's."""
    ccat, rccat = ccats
    with tracing() as tr, rtrace.tracing() as rtr:
        cq = compiler.compile_query_costed("q18", ccat)
        engine.run_query(cq.query, ccat, _cfg())
        rcq = rcompile.compile_query_costed("q18", rccat)
        reng.run_query(rcq.query, rccat, _rcfg())
    forest = port_spans.strip(tr.tree())
    assert [shape(t) for t in forest] == [shape(t) for t in rtr.tree()]
    (cut,) = [c for c in forest[0]["children"]
              if c["name"] == "cut_scoring"
              and c["attrs"]["table"] == "lineitem"]
    assert cut["attrs"]["signatures"][cut["attrs"]["chosen"]] \
        == "scan+agg+having"
    sigs = {s.attrs.get("signature") for s in tr.find("storage_execute")}
    assert "scan+agg+having" in sigs


@pytest.mark.parametrize("mode", engine.MODES)
@pytest.mark.parametrize("power", (1.0, 0.1))
def test_arbitrate_decision_channel_matches_the_reference(cats, mode, power):
    """The channel's snapshot (load at each decision batch) equals the
    reference's entry for entry, with the measured load on."""
    cat, rcat = cats
    with tracing() as tr, rtrace.tracing() as rtr:
        run = engine.run_query(queries.build_query("Q6"), cat,
                               _cfg(mode, power))
        reng.run_query(rqueries.build_query("Q6"), rcat, _rcfg(mode, power))
    decs = tr.decisions.snapshot()
    assert decs == rtr.decisions.snapshot()
    assert len(decs) == len(run.requests)
    assert {d["req_id"]: d["path"] for d in decs} == run.sim.decisions()
    for d in decs:
        assert d["kind"] == "arbitrate"
        assert d["free_pd"] >= 0 and d["free_pb"] >= 0 \
            and d["queue_depth"] >= 0
    (arb,) = tr.find("arbitrate")
    assert arb.attrs["n_pushdown"] == run.n_admitted


def test_oracle_decisions_are_recorded_as_forced(cats):
    cat, rcat = cats
    reqs = engine.plan_requests(queries.build_query("Q14"), cat)
    res = StorageResources(storage_power=0.25)
    decisions = {r.req_id: ("pushdown" if r.req_id % 3 else "pushback")
                 for r in reqs}
    from repro.core.simulator import SimRequest as RSimRequest
    from repro.core.simulator import simulate as rsimulate
    from repro_torch.core.simulator import SimRequest, simulate
    with tracing() as tr, rtrace.tracing() as rtr:
        simulate([SimRequest(r.req_id, r.part.node_id, "Q14", r.cost)
                  for r in reqs], res, decisions=decisions)
        rsimulate([RSimRequest(r.req_id, r.part.node_id, "Q14", r.cost)
                   for r in reqs], RResources(storage_power=0.25),
                  decisions=decisions)
    assert tr.decisions.snapshot() == rtr.decisions.snapshot()
    assert {d["forced"] for d in tr.decisions.snapshot()} == {"oracle"}


# ------------------------------------- tracing on and off: the same bytes
@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_tracing_byte_identity_all_modes(cats, qid):
    cat, _ = cats
    q = queries.build_query(qid)
    for mode in engine.MODES:
        base = engine.run_query(q, cat, _cfg(mode))
        with tracing() as tr:
            traced = engine.run_query(q, cat, _cfg(mode))
        assert_identical(base.result, traced.result, (qid, mode))
        assert base.real_net_bytes == traced.real_net_bytes, (qid, mode)
        assert not [p for s in tr.snapshot()
                    for p in multi_element_tensors(s.attrs)], (qid, mode)


# --------------------------------------------------------- exporters
def _traced_q1(cat):
    with tracing() as tr:
        engine.run_query(queries.build_query("Q1"), cat, _cfg())
    return tr


def test_jsonl_round_trip_tree_equality(cats, tmp_path):
    tr = _traced_q1(cats[0])
    path = tmp_path / "trace.jsonl"
    export.to_jsonl(tr, path, meta={"suite": "test"})
    meta, spans = export.from_jsonl(path)
    assert meta["format"] == "repro-trace-v1"
    assert meta["n_spans"] == len(tr.snapshot()) and meta["suite"] == "test"
    want = json.loads(json.dumps(tr.tree(), default=export._coerce))
    assert export.build_tree(spans) == want


def test_chrome_trace_is_valid_and_complete(cats, tmp_path):
    tr = _traced_q1(cats[0])
    path = tmp_path / "trace.json"
    export.to_chrome_trace(tr, path, meta={"mode": "adaptive"})
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    assert events[0]["ph"] == "M"
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == len(tr.snapshot())
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0 and e["name"]
    assert {"query", "execute_split", "merge", "arbitrate"} <= \
        {e["name"] for e in xs}
    assert doc["otherData"] == {"mode": "adaptive"}


def test_summary_table_and_attribution_match_the_reference_shape(cats):
    cat, rcat = cats
    tr = _traced_q1(cat)
    with rtrace.tracing() as rtr:
        reng.run_query(rqueries.build_query("Q1"), rcat, _rcfg())
    lines = export.summary_table(tr).splitlines()
    rlines = rexport.summary_table(rtr).splitlines()
    assert lines[0].split() == rlines[0].split()
    assert any("Q1" in ln for ln in lines)
    # the query line's columns past the wall time are the same numbers
    assert lines[2].split()[2:] == rlines[2].split()[2:]
    att = export.span_attribution(tr)
    assert sorted((r["name"], r["count"])
                  for r in port_spans.strip_rows(att, tr)) == \
        sorted((r["name"], r["count"]) for r in rexport.span_attribution(rtr))
    assert all(abs(r["total_s"] - r["self_s"] - r["child_s"]) < 1e-9
               for r in att)


def test_scalar_attrs_coerce_to_json(tmp_path):
    with tracing() as tr:
        tr.event("e", a=np.int64(3), b=np.array([1, 2]),
                 c=np.float32(0.5), d={"x", "y"}, t=torch.tensor(7),
                 f=torch.tensor(0.25, dtype=torch.float64))
    _, (span,) = export.from_jsonl(export.to_jsonl(tr, tmp_path / "t.jsonl"))
    assert span["attrs"] == {"a": 3, "b": [1, 2], "c": 0.5, "d": ["x", "y"],
                             "t": 7, "f": 0.25}


# ------------------------------ stream driver: spans + exact reconciliation
def test_run_stream_trace_reconciles_exactly(cats, tmp_path):
    """A traced stream: the same results as untraced; each query span's
    ``real_net_bytes`` equals the driver's accounting and its execution
    spans' ``shipped_bytes`` sum to it exactly; the span tree has the
    reference's shape; the Chrome trace holds every span."""
    cat, rcat = cats
    stream, rstream = stream_of(STREAM_QIDS, 0.004)
    cfg = _cfg(power=0.25)
    base = runtime.run_stream(stream, cat, cfg)
    metrics.set_metrics(metrics.Metrics())
    with tracing() as tr, rtrace.tracing() as rtr:
        run = runtime.run_stream(stream, cat, cfg)
        rruntime.run_stream(rstream, rcat, _rcfg(power=0.25))
    for qid in run.results:
        assert_identical(base.results[qid], run.results[qid], qid)
    (st,) = [t for t in port_spans.strip(tr.tree())
             if t["name"] == "run_stream"]
    (rst,) = [t for t in rtr.tree() if t["name"] == "run_stream"]
    assert shape_unordered(st) == shape_unordered(rst)
    assert st["attrs"]["real_net_bytes"] == run.real_net_bytes \
        == rst["attrs"]["real_net_bytes"]
    qnodes = {c["attrs"]["qid"]: c for c in st["children"]
              if c["name"] == "query"}
    assert set(qnodes) == set(run.per_query)
    for key, qn in qnodes.items():
        want = run.per_query[key]["real_net_bytes"]
        assert qn["attrs"]["real_net_bytes"] == want, key
        got = sum(c["attrs"]["shipped_bytes"] for c in qn["children"]
                  if c["name"] in ("storage_execute", "compute_replay"))
        assert got == want, key
        (res,) = [c for c in qn["children"]
                  if c["name"] == "residual_compute"]
        assert res["attrs"] == {"backend": "interpreter", "jit_hits": None,
                                "jit_misses": None}
    assert run.n_pushback and tr.find("pushback_ship")
    for ws in tr.find("wave_sample"):
        assert "exec_queue" in ws.attrs and "ship_queue" in ws.attrs
    assert not [p for s in tr.snapshot()
                for p in multi_element_tensors(s.attrs)]
    doc = json.loads(open(export.to_chrome_trace(
        tr, tmp_path / "stream.json")).read())
    assert len(doc["traceEvents"]) == len(tr.snapshot()) + 1


def test_run_stream_metrics_match_the_reference(cats, registries):
    cat, rcat = cats
    stream, rstream = stream_of(("Q1", "Q6", "Q6"), 0.003)
    run = runtime.run_stream(stream, cat, _cfg())
    rruntime.run_stream(rstream, rcat, _rcfg())
    m, rm = registries
    snap, rsnap = m.snapshot(), rm.snapshot()
    assert snap["counters"]["stream.requests.pushdown"] == run.n_pushdown
    assert snap["counters"].get("stream.requests.pushback", 0) \
        == run.n_pushback
    assert snap["counters"]["stream.net_bytes.real"] == run.real_net_bytes
    assert snap["histograms"]["stream.query_finish_s"]["count"] == 3
    assert {k: v for k, v in snap["counters"].items()
            if k.startswith("stream.")} == \
        {k: v for k, v in rsnap["counters"].items()
         if k.startswith("stream.")}
    assert sorted(snap["gauges"]) == sorted(rsnap["gauges"])


# --------------------------------------------- bitmap via execute_split
def test_compute_side_bitmap_routes_through_execute_split(cats):
    cat, _ = cats
    parts = [p.data for p in cat.partitions_of("lineitem")][:4]
    pred = Col("l_quantity") <= 25
    out_cols = ("l_orderkey", "l_extendedprice")
    words = [ops.selection_bitmap(p, pred) for p in parts]
    with tracing() as tr:
        got = bm.compute_side_apply_batched(parts, words, out_cols)
    want = [ops.apply_bitmap(p.select(list(out_cols)), w)
            for p, w in zip(parts, words)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_identical(g, w)
    es = tr.find("execute_split")
    assert es and es[0].attrs["n_pushdown"] == len(parts)
    assert tr.find("storage_execute")


# ------------------------------ crash-safe streaming export
def test_stream_writer_round_trip_merges_pairs(tmp_path):
    path = tmp_path / "stream.jsonl"
    w = export.JsonlStreamWriter(path, meta={"suite": "t"})
    tr = Tracer()
    tr.attach_sink(w)
    with tracing(tr), port_spans.no_collections():
        with tr.span("closed", qid="Q1") as sp:
            sp.set(late_attr=7)
            tr.event("ev", k=1)
        never = tr.start("never_closed")
    w.close()
    tr.end(never)                      # after close: dropped, no error
    meta, spans = export.from_jsonl(path)
    assert meta["streaming"] is True and meta["suite"] == "t"
    by_name = {s["name"]: s for s in spans}
    assert by_name["closed"]["dur"] is not None
    assert by_name["closed"]["attrs"]["late_attr"] == 7
    assert by_name["ev"]["dur"] == 0.0
    assert by_name["never_closed"]["dur"] is None
    roots = export.build_tree(spans)
    assert [r["name"] for r in roots] == ["closed", "never_closed"]
    assert [c["name"] for c in roots[0]["children"]] == ["ev"]


def test_stream_writer_hears_gc_spans_without_reentering_its_lock(
        tmp_path):
    """A collection inside the writer's own lock (here forced in its file
    write, the point a real allocation could trigger one) records a ``gc``
    span and hands it to the writer later, outside the collector."""
    path = tmp_path / "stream.jsonl"
    w = export.JsonlStreamWriter(path)

    class CollectingFile:
        def __init__(self, fh):
            self.fh, self.left = fh, 3

        def write(self, line):
            n = self.fh.write(line)
            if self.left:
                self.left -= 1
                gc.collect()
            return n

        def __getattr__(self, name):
            return getattr(self.fh, name)

    tr = Tracer()
    tr.attach_sink(w)

    def body():
        with tracing(tr):
            w._fh = CollectingFile(w._fh)
            for i in range(3):
                with tr.span("s", i=i):
                    tr.event("e")
                    gc.collect()

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout=60)
    if t.is_alive():                # deadlocked: free the rest of the run
        tr.attach_sink(None)
        trace.set_tracer(None)
    assert not t.is_alive(), "a collection re-entered the writer's lock"
    w.close()
    want = tr.find("gc")
    assert len(want) >= 6           # three in writes, three in spans
    _, spans = export.from_jsonl(path)
    got = [s for s in spans if s["name"] == "gc"]
    assert sorted(s["sid"] for s in got) == sorted(s.sid for s in want)
    assert all(s["dur"] is not None and s["attrs"]["collected"] >= 0
               for s in got)
    assert {s["name"] for s in spans} == {"s", "e", "gc"}


def test_threaded_stream_streams_every_span_with_collections_on(
        cats, tmp_path):
    """A threaded ``run_stream`` into a ``JsonlStreamWriter`` while the
    collector runs often, in every worker: no deadlock, and the file holds
    every span the tracer kept, ``gc`` spans among them, all closed."""
    cat, _ = cats
    stream, _ = stream_of(STREAM_QIDS, 0.004)
    w = export.JsonlStreamWriter(tmp_path / "s.jsonl")
    tr = Tracer()
    tr.attach_sink(w)
    was = gc.get_threshold()

    def body():
        gc.set_threshold(50, 2, 2)
        try:
            with tracing(tr):
                runtime.run_stream(stream, cat, _cfg(power=0.25))
        finally:
            gc.set_threshold(*was)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout=300)
    if t.is_alive():                # deadlocked: free the rest of the run
        tr.attach_sink(None)
        trace.set_tracer(None)
    assert not t.is_alive(), "a collection re-entered the writer's lock"
    w.close()
    _, spans = export.from_jsonl(tmp_path / "s.jsonl")
    assert len(spans) == len(tr.snapshot())
    assert all(s["dur"] is not None for s in spans)
    assert tr.find("gc") and sum(s["name"] == "gc" for s in spans) == \
        len(tr.find("gc"))


def test_stream_writer_tolerates_torn_tail(tmp_path):
    path = tmp_path / "stream.jsonl"
    with export.JsonlStreamWriter(path) as w:
        tr = Tracer()
        tr.attach_sink(w)
        with tracing(tr):
            with tr.span("a"):
                pass
            with tr.span("b"):
                pass
    raw = path.read_bytes()
    path.write_bytes(raw[:len(raw) - 17])
    meta, spans = export.from_jsonl(path)
    assert meta.get("streaming") is True
    a = next(s for s in spans if s["name"] == "a")
    assert a["dur"] is not None


def test_stream_writer_survives_kill_dash_nine(tmp_path):
    """A child process streaming a trace is SIGKILLed with spans open:
    the file parses, the finished span has its ``dur``, the open ones
    read back open."""
    path = tmp_path / "killed.jsonl"
    child = subprocess.Popen(
        [sys.executable, "-c", f"""
import time
from repro_torch.obs.trace import Tracer, tracing
from repro_torch.obs.export import JsonlStreamWriter

w = JsonlStreamWriter({str(path)!r})
tr = Tracer()
tr.attach_sink(w)
with tracing(tr):
    with tr.span("finished", qid="Q1"):
        pass
    open_outer = tr.start("query", qid="Q9")
    open_inner = tr.start("storage_execute", parent=open_outer, node=0)
    print("SPANS_OPEN", flush=True)
    time.sleep(60)
"""],
        stdout=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(ROOT / "src")}, cwd=str(tmp_path))
    try:
        assert child.stdout.readline().strip() == "SPANS_OPEN"
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    assert child.returncode == -signal.SIGKILL
    meta, spans = export.from_jsonl(path)
    assert meta.get("streaming") is True
    by_name = {s["name"]: s for s in spans}
    assert by_name["finished"]["dur"] is not None
    assert by_name["query"]["dur"] is None
    assert by_name["storage_execute"]["dur"] is None
    assert by_name["storage_execute"]["parent"] == by_name["query"]["sid"]
    assert by_name["query"]["attrs"]["qid"] == "Q9"


def test_stream_writer_matches_batch_export_shape(cats, tmp_path):
    tr = Tracer()
    w = export.JsonlStreamWriter(tmp_path / "live.jsonl")
    tr.attach_sink(w)
    with tracing(tr):
        engine.run_query(queries.build_query("Q6"), cats[0], _cfg())
    w.close()
    export.to_jsonl(tr, tmp_path / "batch.jsonl")
    _, live = export.from_jsonl(tmp_path / "live.jsonl")
    _, batch = export.from_jsonl(tmp_path / "batch.jsonl")
    assert export.build_tree(live) == export.build_tree(batch)


# ---------------------------------------- the port's own spans and counters
def test_uncosted_compile_is_one_compile_span():
    with tracing() as tr:
        compiler.compile_query("q6")
    (sp,) = tr.find("compile")
    assert sp.cat == "compiler" and sp.parent is None and sp.dur >= 0
    assert sp.attrs == {"qid": "Q6", "costed": False}
    assert get_tracer() is NULL_TRACER
    compiler.compile_query("q6")
    assert len(tr.find("compile")) == 1


def _op_plan():
    """A residual over two merged tables that runs every traced operator
    once, with a Project and a Shuffle (no span) between them."""
    from repro_torch.compiler import ir
    a, b = ir.Merged("a"), ir.Merged("b")
    f = ir.Filter(a, Col("v") > 15.0)
    m = ir.Map(f, (("v2", ("v",), lambda v: v * 2),))
    j = ir.Join(ir.Shuffle(m, "k"), b, "k", "k2")
    s = ir.SemiJoin(j, b, "k", "k2")
    g = ir.Aggregate(ir.Project(s, ("k", "v2")), ("k",),
                     (("tot", "sum", "v2"),))
    return ir.TopK(ir.Sort(g, ("tot",), ascending=False), "tot", 2)


def test_residual_operators_are_spans_in_evaluation_order():
    """One ``op.*`` span an operator, in the order the interpreter runs
    them, with the rows of its inputs and output, none overlapping and
    all inside the caller's span."""
    from repro_torch.compiler import interpreter
    merged = {"a": ColumnTable({"k": torch.arange(1, 6),
                                "v": torch.arange(10.0, 60.0, 10.0)}),
              "b": ColumnTable({"k2": torch.tensor([2, 3, 4, 9]),
                                "w": torch.ones(4)})}
    plan = _op_plan()
    want = interpreter.run(plan, merged)
    with tracing() as tr:
        with tr.span("residual_compute") as rc:
            got = interpreter.run(plan, merged)
    assert_identical(got, want)
    ops_ = [s for s in tr.snapshot() if s.name.startswith("op.")]
    assert [(s.name, s.attrs["rows_in"], s.attrs["rows_out"])
            for s in ops_] == [
        ("op.filter", 5, 4), ("op.map", 4, 4), ("op.join", 8, 3),
        ("op.semijoin", 7, 3), ("op.aggregate", 3, 3), ("op.sort", 3, 3),
        ("op.topk", 3, 2)]
    assert all(s.parent == rc.sid and s.cat == "residual" for s in ops_)
    for x, y in zip(ops_, ops_[1:]):
        assert x.t0 + x.dur <= y.t0
    assert sum(s.dur for s in ops_) <= rc.dur


def test_query_residual_spans_sit_under_residual_compute(cats):
    cat, _ = cats
    with tracing() as tr:
        run = engine.run_query(queries.build_query("Q3"), cat, _cfg())
    (rc,) = tr.find("residual_compute")
    ops_ = [s for s in tr.snapshot() if s.name.startswith("op.")]
    assert {s.name for s in ops_} >= {"op.join", "op.aggregate"}
    assert all(s.parent == rc.sid for s in ops_)
    assert ops_[-1].attrs["rows_out"] == len(run.result)


def test_a_cluster_traces_routing_gathers_and_nodes(cats):
    """Under a 4-node cluster with shuffle pushdown: one ``route`` span a
    routed table, each join of two routed tables once a node, gathers to
    node 0 before the aggregate, and the query span carries the fabric's
    bytes."""
    from repro_torch.core import cluster
    cat, _ = cats
    cfg = _cfg(power=0.1, num_compute_nodes=4, shuffle="storage")
    with tracing() as tr:
        run = engine.compile_and_run("Q3", cat, cfg)
    routes = tr.find("route")
    assert sorted(s.attrs["table"] for s in routes) == ["lineitem", "orders"]
    (split,) = tr.find("execute_split")
    assert all(s.parent == split.sid and s.cat == "shuffle"
               and s.attrs["nodes"] == 4 for s in routes)
    assert sum(s.attrs["rows_routed"] for s in routes) \
        == run.exchange["routed_rows"] > 0
    joins = tr.find("op.join")
    assert sorted(s.attrs["node"] for s in joins) == [0, 0, 1, 1, 2, 2, 3, 3]
    gathers = tr.find("gather")
    assert gathers and all(s.cat == "shuffle" for s in gathers)
    assert sum(s.attrs["bytes"] for s in gathers) \
        == run.exchange["gather_bytes"]
    (agg,) = tr.find("op.aggregate")
    assert "node" not in agg.attrs
    (q,) = tr.find("query")
    assert q.attrs["exchange"] == run.exchange
    assert set(run.exchange) >= {n.split(".", 1)[1]
                                 for n in cluster.COUNTERS}


@pytest.mark.parametrize("traced", [False, True])
def test_a_cluster_counts_its_fabric_once_a_query(cats, registries, traced):
    """The ``shuffle.*`` counters add each query's ``exchange``, traced or
    not, and the tracer hands them back for its window."""
    from repro_torch.core import cluster
    cat, _ = cats
    m, _ = registries
    cfg = _cfg(power=0.1, num_compute_nodes=4, shuffle="compute")
    with (tracing() if traced else contextlib.nullcontext()):
        runs = [engine.compile_and_run(q, cat, cfg) for q in ("Q3", "Q10")]
    c = m.snapshot()["counters"]
    for name in cluster.COUNTERS:
        field = name.split(".", 1)[1]
        assert c[name] == sum(r.exchange[field] for r in runs) > 0
        if traced:
            assert trace.last_counters()[name] == c[name]


def _sim_requests():
    """Two equal pushback requests at 0 on one node, a third at 1 s: each
    batch drains its disk stage, then its net stage, together."""
    from repro_torch.core.cost import RequestCost
    from repro_torch.core.simulator import SimRequest
    cost = RequestCost(s_in=10 ** 6, s_out=10 ** 5, compute_in=10 ** 6)
    return [SimRequest(0, 0, "q", cost), SimRequest(1, 0, "q", cost),
            SimRequest(2, 0, "q", cost, arrival=1.0)]


@pytest.mark.parametrize("traced", [False, True])
def test_simulator_counts_its_events_and_rerates(registries, traced):
    """By hand: events at 0 (both on disk), at 0.25 ms (both on the net),
    none for the idle jump to 1 s, then two for the third alone: 4
    events, 2 + 2 + 1 + 1 = 6 re-rated tasks, traced or not."""
    from repro_torch.core.simulator import simulate
    m, _ = registries
    with (tracing() if traced else contextlib.nullcontext()):
        simulate(_sim_requests(), StorageResources(), mode="no_pushdown")
    c = m.snapshot()["counters"]
    assert (c["sim.events"], c["sim.rerates"]) == (4, 6)


def test_tracer_counts_what_the_registry_counted_while_installed(
        registries):
    from repro_torch.core.simulator import simulate
    simulate(_sim_requests(), StorageResources(), mode="no_pushdown")
    with tracing() as tr:
        simulate(_sim_requests(), StorageResources(), mode="no_pushdown")
        simulate(_sim_requests(), StorageResources(), mode="no_pushdown")
    simulate(_sim_requests(), StorageResources(), mode="no_pushdown")
    c = trace.last_counters()
    assert c["sim.events"] == 8 and c["sim.rerates"] == 12
    m, _ = registries
    assert m.snapshot()["counters"]["sim.events"] == 16


def test_a_collection_is_a_gc_span_only_while_tracing():
    assert trace._on_gc not in gc.callbacks
    with tracing() as tr:
        with tr.span("outer") as outer:
            gc.collect()
        assert trace._on_gc in gc.callbacks
    spans = tr.find("gc")
    full = [s for s in spans if s.attrs["generation"] == 2]
    assert full and all(s.parent == outer.sid and s.cat == "host"
                        and s.dur is not None and s.dur >= 0
                        and s.attrs["collected"] >= 0 for s in full)
    gc.collect()
    assert len(tr.find("gc")) == len(spans)
    assert trace._on_gc not in gc.callbacks
    assert trace._sync_route is None


def test_no_device_sync_hook_without_cuda():
    """Where CUDA is not initialised the sync route stays off: no filter,
    no warning hook, no ``device_sync``."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        pytest.skip("CUDA is initialised in this process")
    filters, show = list(warnings.filters), warnings.showwarning
    with tracing() as tr:
        with tr.span("s"):
            torch.ones(3).sum().item()
        assert warnings.showwarning is show
        assert list(warnings.filters) == filters
        assert trace._sync_route is None
    assert not tr.find("device_sync")

