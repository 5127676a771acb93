"""A compute cluster of n nodes with shuffle pushdown (``core.cluster``)
against the plain reference of ``tests/shuffle_cluster_ref.py``, and its
answers against the single-node path and the JAX package's, on the CPU.

The catalog is ``tests/test_torch_engine.py``'s arrays (sf=0.5, seed 0,
2,000-row lineitem partitions) over 4 storage nodes, arbitrated at storage
power 0.2 so that the adaptive split pushes some partitions of lineitem
or orders back in Q3, Q5, Q7 and Q10, and all of them in Q8 and Q18. Per-node tables must equal the reference's routing
bitwise, the compute fabric's byte counts exactly; answers agree to 1e-9
(the per-node joins change the order in which floats are added).
"""
import dataclasses
import types

import pytest
import torch

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.core.cost import StorageResources as RResources
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnTable as RTable
from repro_torch import compiler
from repro_torch.compiler import interpreter
from repro_torch.core import cluster, engine, runtime
from repro_torch.core.arbitrator import PUSHBACK
from repro_torch.core.cost import StorageResources
from repro_torch.core.executor import compile_push_plan
from repro_torch.core.faults import FaultPlan
from repro_torch.kernels import fused_scan_shuffle as fss
from repro_torch.kernels import hash_partition as hpk
from repro_torch.obs import metrics, trace
from repro_torch.queryproc import queries
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays

import shuffle_cluster_ref as ref

SF, SEED, NODES, RPP, POWER = 0.5, 0, 4, 2000, 0.2
JOIN_QUERIES = ("Q3", "Q5", "Q7", "Q8", "Q10", "Q18")
TOL = 1e-9


@pytest.fixture(scope="module")
def arrays():
    return {n: t.cols for n, t in rtpch.generate_tables(SF, SEED).items()}


@pytest.fixture(scope="module")
def catalog(arrays):
    return catalog_from_arrays(arrays, NODES, RPP, device="cpu")


@pytest.fixture(scope="module")
def ref_catalog():
    return rtpch.build_catalog(SF, SEED, NODES, RPP)


@pytest.fixture(autouse=True)
def registry():
    was = metrics.get_metrics()
    metrics.set_metrics(metrics.Metrics())
    yield
    metrics.set_metrics(was)


def _cfg(shuffle="none", n=1, mode="adaptive"):
    return engine.EngineConfig(device="cpu", num_compute_nodes=n,
                               shuffle=shuffle, mode=mode,
                               res=StorageResources(storage_power=POWER),
                               measured_feedback=False)


_SINGLE = {}


def _single(catalog, qid, mode="adaptive"):
    """The single-node run, once per query and mode."""
    if (qid, mode) not in _SINGLE:
        _SINGLE[qid, mode] = engine.compile_and_run(qid, catalog,
                                                    _cfg(mode=mode))
    return _SINGLE[qid, mode]


def _table(t: ColumnTable):
    return dict(t.cols)


def _apply(node, ins):
    """The port's operator for everything but the joins the reference runs
    itself."""
    tabs = [ColumnTable(t) for t in ins]
    if isinstance(node, compiler.ir.Project):
        return _table(tabs[0].select([c for c in node.columns
                                      if c in tabs[0].cols]))
    if isinstance(node, compiler.ir.PyOp):
        return _table(node.fn(*tabs))
    return _table(interpreter._apply(node, tabs))


def _reference(run, shuffle, n):
    """The reference's per-node tables and evaluation of one routed run,
    from the port's per-partition plan outputs (the plans without the
    partition function) and the run's decisions."""
    decisions = run.sim.decisions()
    keys = cluster.route_query(compiler.compile_query(run.qid),
                               shuffle, n)[1].keys
    by_table = {}
    for r in run.requests:
        plan = dataclasses.replace(r.plan, shuffle=None)
        res, _ = compile_push_plan(plan).execute(r.part.data)
        at_compute = (shuffle == cluster.SHUFFLE_COMPUTE
                      or decisions.get(r.req_id) == PUSHBACK)
        by_table.setdefault(r.table, []).append(
            (r.part.index, _table(res), at_compute))
    leaves, routed, off = {}, 0, 0
    for t, results in by_table.items():
        if t in keys:
            nodes, rr, oo = ref.route(results, keys[t], n)
            leaves[t] = ref.Split(nodes, keys[t])
            routed, off = routed + rr, off + oo
        else:
            leaves[t] = ref.concat([res for _, res, _ in results])
    residual = compiler.compile_query(run.qid).residual
    answer, cl = ref.evaluate(residual, leaves, n, _apply)
    return leaves, answer, {"routed_rows": routed,
                            "redistributed_bytes": off,
                            "broadcast_bytes": cl.broadcast_bytes,
                            "gather_bytes": cl.gather_bytes}


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("shuffle", (cluster.SHUFFLE_STORAGE,
                                     cluster.SHUFFLE_COMPUTE))
@pytest.mark.parametrize("qid", JOIN_QUERIES)
def test_a_cluster_matches_the_plain_reference(catalog, ref_catalog, qid,
                                               shuffle, n):
    run = engine.compile_and_run(qid, catalog, _cfg(shuffle, n))
    leaves, answer, counts = _reference(run, shuffle, n)
    # the port's per-node tables under the run's own decisions
    routing = cluster.route_query(compiler.compile_query(qid),
                                  shuffle, n)[1]
    split = runtime.execute_split(run.requests, run.sim.decisions(),
                                  routing=routing,
                                  exchange=cluster.Exchange())
    assert set(routing.keys) == {"lineitem", "orders"}
    for t, want in leaves.items():
        got = split.merged[t]
        if t not in routing.keys:
            assert isinstance(got, ColumnTable)
            continue
        assert isinstance(got, cluster.Partitioned) and got.n == n
        for node, (g, w) in enumerate(zip(got.slices, want.nodes)):
            assert list(g.cols) == list(w), (t, node)
            for c in w:
                assert g.cols[c].dtype == w[c].dtype, (t, node, c)
                assert torch.equal(g.cols[c], w[c]), (t, node, c)
    assert {k: run.exchange[k] for k in counts} == counts
    assert engine.results_equal(run.result, ColumnTable(answer), tol=TOL)
    single = _single(catalog, qid)
    assert engine.results_equal(run.result, single.result, tol=TOL)
    jax = reng.compile_and_run(qid, ref_catalog, reng.EngineConfig(
        res=RResources(storage_power=POWER), measured_feedback=False))
    assert reng.results_equal(RTable(run.result.to_numpy()), jax.result,
                              tol=TOL)
    if shuffle == cluster.SHUFFLE_COMPUTE:
        # nothing hashes at storage: the same costs, decisions and bytes
        assert run.sim.decisions() == single.sim.decisions()
        assert run.real_net_bytes == single.real_net_bytes


def test_the_adaptive_split_mixes_both_paths_on_routed_tables(catalog):
    run = engine.compile_and_run("Q10", catalog,
                                 _cfg(cluster.SHUFFLE_STORAGE, 4))
    paths = {(o.table, o.replayed) for o in run.outcomes}
    assert {("lineitem", True), ("lineitem", False), ("orders", True),
            ("orders", False)} <= paths
    assert 0 < run.exchange["routed_rows"] < sum(
        len(p.data) for p in catalog.partitions_of("lineitem"))


@pytest.mark.parametrize("mode", ("eager", "no_pushdown"))
@pytest.mark.parametrize("qid", JOIN_QUERIES)
def test_storage_shuffle_ships_the_same_bytes(catalog, qid, mode,
                                              monkeypatch):
    """Hashing at storage changes no shipped byte; pushed down everywhere,
    nothing is routed at compute."""
    calls = {"hash_partition": 0}

    def counted(keys, n):
        calls["hash_partition"] += 1
        return hpk.hash_partition(keys, n)
    # the compute layer's launches only: the executor's stay uncounted
    monkeypatch.setattr(cluster, "hpk", types.SimpleNamespace(
        hash_partition=counted, check_targets=hpk.check_targets))
    run = engine.compile_and_run(qid, catalog,
                                 _cfg(cluster.SHUFFLE_STORAGE, 4, mode))
    single = _single(catalog, qid, mode)
    assert run.real_net_bytes == single.real_net_bytes
    assert run.sim.decisions() == single.sim.decisions()
    assert engine.results_equal(run.result, single.result, tol=TOL)
    if mode == "eager":
        assert run.exchange["routed_rows"] == 0
        assert run.exchange["redistributed_bytes"] == 0
        assert calls["hash_partition"] == 0
    else:
        assert calls["hash_partition"] == 2  # lineitem and orders, once each


@pytest.mark.parametrize("qid", JOIN_QUERIES)
def test_no_shuffle_keeps_the_single_node_path(catalog, ref_catalog, qid,
                                               monkeypatch):
    """``shuffle="none"``: no partition function runs, no routing span or
    per-node operator, no fabric counter, and the bytes and decisions are
    the JAX package's."""
    calls = []
    for mod, name in ((hpk, "hash_partition"), (fss, "fused_scan_shuffle")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    with trace.tracing() as tr:
        run = engine.compile_and_run(qid, catalog, _cfg())
    assert calls == [] and run.exchange is None
    names = {s.name for s in tr.snapshot()}
    assert not names & {"route", "gather"}
    assert all("node" not in s.attrs for s in tr.snapshot()
               if s.name.startswith("op."))
    assert not any(k.startswith("shuffle.") for k in
                   metrics.get_metrics().snapshot()["counters"])
    jax = reng.compile_and_run(qid, ref_catalog, reng.EngineConfig(
        res=RResources(storage_power=POWER), measured_feedback=False))
    assert run.real_net_bytes == jax.real_net_bytes
    assert run.sim.decisions() == jax.sim.decisions()


def test_a_dropped_slice_changes_the_answer(catalog, monkeypatch):
    real = cluster.assemble

    def lossy(*a, **k):
        out = real(*a, **k)
        out.slices[1] = ColumnTable({c: v[:0] for c, v in
                                     out.slices[1].cols.items()})
        return out
    monkeypatch.setattr(runtime.cluster, "assemble", lossy)
    run = engine.compile_and_run("Q10", catalog,
                                 _cfg(cluster.SHUFFLE_STORAGE, 4))
    assert not engine.results_equal(run.result,
                                     _single(catalog, "Q10").result, tol=TOL)


def _refused(catalog, cfg):
    from repro_torch.core.result_cache import ResultCache
    return {
        "run_stream": lambda: runtime.run_stream(
            [runtime.StreamQuery(compiler.compile_query("Q3"))], catalog,
            cfg),
        "run_concurrent": lambda: engine.run_concurrent(
            [compiler.compile_query("Q3")], catalog, cfg),
        "process tier": lambda: engine.compile_and_run(
            "Q3", catalog, dataclasses.replace(cfg, storage_tier="process")),
        "tensor residual": lambda: engine.compile_and_run(
            "Q3", catalog, dataclasses.replace(cfg, residual="tensor")),
        "result cache": lambda: engine.compile_and_run(
            "Q3", catalog, dataclasses.replace(cfg,
                                               result_cache=ResultCache())),
        "fault plan": lambda: engine.compile_and_run(
            "Q3", catalog, dataclasses.replace(
                cfg, faults=FaultPlan.from_spec("crash:0.5"))),
        "hand-built query": lambda: engine.run_query(
            queries.build_query_legacy("Q3"),
            catalog, cfg)}


@pytest.mark.parametrize("path", ("run_stream", "run_concurrent",
                                  "process tier", "tensor residual",
                                  "result cache", "fault plan",
                                  "hand-built query"))
@pytest.mark.parametrize("shuffle", (cluster.SHUFFLE_STORAGE,
                                     cluster.SHUFFLE_COMPUTE))
def test_paths_that_do_not_route_refuse_a_cluster(catalog, path, shuffle):
    with pytest.raises(ValueError, match="compute nodes"):
        _refused(catalog, _cfg(shuffle, 4))[path]()


def test_an_unknown_shuffle_is_refused(catalog):
    with pytest.raises(ValueError, match="unknown shuffle"):
        engine.compile_and_run("Q3", catalog, _cfg("everywhere", 4))


def test_the_partition_function_is_the_kernels(catalog):
    keys = torch.cat([torch.arange(-70000, 70000, 7, dtype=torch.int64),
                      torch.tensor([2 ** 31 - 1, -2 ** 31, 2 ** 32 + 5])])
    for n in (1, 2, 3, 4, 7):
        assert torch.equal(ref.partition_ids(keys, n),
                           hpk.hash_partition(keys, n)[0])
