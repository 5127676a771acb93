"""End-to-end query engine over the device-resident storage layer.

Port of ``repro.core.engine`` (``compile_and_run``, ``run_query`` and
what they need). For one query the engine:

1. plans one request per partition of every scanned table and costs it
   from the partition's column stats,
2. runs the Arbitrator + fluid simulator for the pushdown/pushback
   decision vector,
3. executes that split on the device (``core.runtime``),
4. runs the query's residual over the merged tables.

With a ``CardinalityCorrector`` in the config, every request's ``s_out``
is rescaled by the ratios learned so far, and every run feeds its real
pushdown bytes back. With a ``ResultCache``, warm partitions arbitrate
with ``compute_in=0`` and the cached bytes as ``s_out`` and are served
instead of run. With a ``FaultPlan``, every request group runs through
the runtime's retry/demote loop; results stay the same under any
schedule. ``run_concurrent`` arbitrates several queries' requests
together (§6.2's PA-aware experiment); ``theoretical_split`` is the §3.1
oracle split of one query (Fig 7); ``core.runtime.run_stream`` drives
an arrival-timed stream of queries on worker pools. With
``measured_feedback`` (the default) the Arbitrator's backlog guard reads
the queue depths a running stream publishes, and its fluid queue where
none was published. With ``storage_tier="process"`` (or a
``worker_pool``) the storage side runs in one worker process per catalog
node (``distributed.workers``), with the same results. With
``residual="tensor"`` (or ``"auto"`` above a calibrated row count) the
residual runs as padded stage programs (``compiler.tensorize``), with
the same results. With ``shuffle="storage"`` or ``"compute"`` the
residual runs on ``num_compute_nodes`` compute nodes, the tables its
joins need split by key routed to them (``core.cluster``), with the same
results.

Modes: no_pushdown / eager / adaptive / adaptive_pa (§6.2 baselines).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import cluster, optimum, runtime
from repro_torch.core.arbitrator import MeasuredLoad
from repro_torch.core.cost import (CardinalityCorrector, RequestCost,
                                   StorageResources)
from repro_torch.core.executor import (EXECUTOR_BATCHED, EXECUTOR_REFERENCE,
                                       compile_push_plan)
from repro_torch.core.plan import PushPlan, plan_signature
from repro_torch.core.simulator import (MODE_ADAPTIVE, MODES, SimRequest,
                                        SimResult, simulate)
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_metrics
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import Catalog, Partition

__all__ = ["MODES", "STORAGE_TIERS", "EngineConfig", "PlannedRequest",
           "QueryRun", "compile_and_run", "execute_requests",
           "plan_requests", "resolve_tier", "run_concurrent", "run_query",
           "results_equal", "theoretical_split"]

# storage tiers (EngineConfig.storage_tier): where a split's storage side
# runs. "inproc": in this process (the oracle). "process": one worker
# process per catalog node (distributed.workers.WorkerPool), plans and
# results over a wire, real worker faults recovered by retry -> demote;
# the results are the same for any decision vector and fault schedule
STORAGE_INPROC = "inproc"
STORAGE_PROCESS = "process"
STORAGE_TIERS = (STORAGE_INPROC, STORAGE_PROCESS)


def resolve_tier(cfg, catalog: Catalog):
    """The worker pool a config's storage tier runs through, or None for
    the in-process oracle. ``cfg.worker_pool`` wins over the named tier;
    ``storage_tier="process"`` gets the catalog's shared pool
    (``workers.pool_for``, ``cfg.res.pd_slots`` threads a worker). The
    pool must run on the config's device."""
    pool = cfg.worker_pool
    if pool is None:
        if cfg.storage_tier in (None, STORAGE_INPROC):
            return None
        if cfg.storage_tier != STORAGE_PROCESS:
            raise ValueError(f"unknown storage_tier {cfg.storage_tier!r}; "
                             f"expected one of {STORAGE_TIERS}")
        from repro_torch.distributed.workers import pool_for  # lazy: keeps
        #   multiprocessing off the in-process import path
        pool = pool_for(catalog, pd_slots=cfg.res.pd_slots)
    dev = resolve_device(cfg.device)
    if pool.device != dev:
        raise ValueError(f"the worker pool runs on {pool.device}, the engine "
                         f"is configured for {dev}")
    return pool


@dataclasses.dataclass
class EngineConfig:
    res: StorageResources = StorageResources()
    mode: str = MODE_ADAPTIVE
    compute_bw: float = 2.4e9   # compute-node operator bandwidth (16 vCPU)
    num_compute_nodes: int = 1
    device: Optional[str] = None  # None = cuda; "cpu" = plain versions
    # online s_out correction: requests are costed with its ratios, and
    # every run feeds its real pushdown bytes back (results never change)
    corrector: Optional[CardinalityCorrector] = None
    executor: str = EXECUTOR_BATCHED  # or "reference": the per-partition
    #                                   oracle (results identical)
    # a core.result_cache.ResultCache: storage-side pushdown serves and
    # fills it per partition, and plan_requests probes it, so a warm
    # partition arbitrates with compute_in=0 and its known result bytes
    result_cache: Optional[object] = None
    # arbitrate over the measured queue depths run_stream publishes every
    # dispatch wave (arbitrator.MeasuredLoad); a node never published
    # falls back to the fluid queue, and False is the fluid model alone
    measured_feedback: bool = True
    # core.faults: with a FaultPlan (here or from REPRO_FAULT_SPEC) every
    # group retries under `retry` (default RetryPolicy) and exhausted
    # pushdown groups demote to pushback; a CircuitBreaker feeds the
    # Arbitrator; a HedgePolicy hedges run_stream's pushdown stragglers.
    # None of them set: the fault-free path
    faults: Optional[object] = None       # faults.FaultPlan
    retry: Optional[object] = None        # faults.RetryPolicy
    hedge: Optional[object] = None        # faults.HedgePolicy (run_stream)
    breaker: Optional[object] = None      # faults.CircuitBreaker
    # STORAGE_TIERS: "process" runs the storage side in worker processes
    # (same results); `worker_pool` (a distributed.workers.WorkerPool)
    # names the pool and wins over the tier
    storage_tier: str = STORAGE_INPROC
    worker_pool: Optional[object] = None
    # runtime.RESIDUALS: "interpreter" walks the residual IR; "tensor"
    # runs it as padded stage programs (compiler.tensorize, programs
    # cached per shape bucket); "auto" takes tensor at or above the
    # calibrated row crossover. The results are the same under every
    # backend
    residual: str = runtime.RESIDUAL_INTERPRETER
    # cluster.SHUFFLE_MODES: "none" merges every table whole, one compute
    # node's path; "storage" (shuffle pushdown) and "compute" (the Fig-15
    # baseline) split each table of a query's shuffle_keys over the
    # num_compute_nodes nodes, hashed while storage scans it or at compute,
    # and the residual's joins run per node. The results are the same
    shuffle: str = cluster.SHUFFLE_NONE


@dataclasses.dataclass
class PlannedRequest:
    req_id: int
    query_id: str
    table: str
    part: Partition
    plan: PushPlan
    cost: RequestCost      # as arbitrated (rescaled by the corrector)
    s_out_raw: int = 0     # the uncorrected s_out estimate, which the
    #                        corrector's feedback is measured against


@dataclasses.dataclass
class QueryRun:
    qid: str
    result: ColumnTable
    sim: SimResult
    t_pushable: float
    t_nonpushable: float
    requests: List[PlannedRequest]
    net_bytes: float            # simulated traffic (cost-model s_out/s_in)
    n_admitted: int
    n_pushed_back: int
    real_net_bytes: float = 0.0
    net_bytes_recon: Optional[Dict] = None
    outcomes: Optional[List[runtime.RequestOutcome]] = None
    # n_demoted, retries, faults_injected; None on a run no fault touched
    recovery: Optional[Dict] = None
    # the backend that evaluated the residual ("interpreter" | "tensor")
    # and, on the tensor path, its program-cache hits/misses, fallback,
    # observe and stage counts (None when the interpreter ran)
    residual_backend: str = "interpreter"
    residual_jit: Optional[Dict] = None
    # the compute fabric's traffic (cluster.Exchange.as_dict()) on a run
    # routed over compute nodes; None under shuffle="none"
    exchange: Optional[Dict] = None

    @property
    def t_total(self) -> float:
        return self.t_pushable + self.t_nonpushable

    @property
    def cache_hits(self) -> int:
        """Pushdown partitions the result cache served."""
        return sum(1 for o in (self.outcomes or ()) if o.cache)

    @property
    def n_demoted(self) -> int:
        """Admitted pushdown requests recovered by demotion to pushback."""
        return sum(1 for o in (self.outcomes or ()) if o.demoted)


def plan_requests(query, catalog: Catalog, start_id: int = 0,
                  corrector: Optional[CardinalityCorrector] = None,
                  cache=None) -> List[PlannedRequest]:
    """One costed request per partition of every table the query scans,
    numbered from ``start_id``; ``corrector`` rescales each ``s_out``.
    A partition ``cache`` holds a result for costs nothing to compute and
    ships the cached bytes (the corrector is skipped: nothing is
    estimated)."""
    tr = obs_trace.get_tracer()
    with tr.span("plan_requests", qid=query.qid) as sp:
        out: List[PlannedRequest] = []
        rid = start_id
        n_warm = 0
        for table, plan in query.plans.items():
            cplan = compile_push_plan(plan)
            sig = plan_signature(plan)
            for part in catalog.partitions_of(table):
                cost = cplan.estimate_cost(part)
                raw = cost.s_out
                hint = (cache.cost_hint(cplan, part)
                        if cache is not None else None)
                if hint is not None:
                    cost = dataclasses.replace(cost, compute_in=0,
                                               s_out=max(64, int(hint)))
                    n_warm += 1
                elif corrector is not None:
                    cost = corrector.correct(query.qid, table, sig, cost)
                out.append(PlannedRequest(rid, query.qid, table, part, plan,
                                          cost, s_out_raw=raw))
                rid += 1
        if tr.enabled:
            sp.set(n_requests=len(out), n_tables=len(query.plans),
                   est_s_out=sum(r.cost.s_out for r in out),
                   n_cache_warm=n_warm,
                   # the corrector's state as these estimates used it
                   corrector_state=(corrector.state(query.qid)
                                    if corrector is not None else None))
    return out


def _measured_of(cfg: EngineConfig) -> Optional[MeasuredLoad]:
    """The measured-load source, when the config asks for it."""
    return MeasuredLoad() if cfg.measured_feedback else None


def execute_requests(reqs: List[PlannedRequest],
                     executor: str = EXECUTOR_BATCHED
                     ) -> Dict[str, ColumnTable]:
    """Every request storage-side, merged per table in request order (the
    split's merge with every request pushed down)."""
    return runtime.execute_split(reqs, {}, executor=executor).merged


def nonpushable_time(merged: Dict[str, ColumnTable], cfg: EngineConfig,
                     exchange: Optional[cluster.Exchange] = None) -> float:
    """Joins/final aggregation at the compute layer: input bytes over the
    compute-node operator bandwidth, plus the redistribution of a run
    routed over compute nodes (``Exchange.redistribution_time``)."""
    b = sum(cluster.table_bytes(t) for t in merged.values())
    t = b / (cfg.compute_bw * cfg.num_compute_nodes)
    if exchange is not None:
        t += exchange.redistribution_time(cfg.num_compute_nodes)
    return t


def check_unrouted(cfg: EngineConfig, what: str) -> None:
    """Refuse a path that does not route over compute nodes."""
    if cfg.shuffle != cluster.SHUFFLE_NONE:
        raise ValueError(f"{what} does not split tables over compute "
                         f"nodes: shuffle={cfg.shuffle!r} needs "
                         f"shuffle={cluster.SHUFFLE_NONE!r}")


def _routed(query, cfg: EngineConfig, requests, bitmaps):
    """``(query, routing)``: the query as ``cfg.shuffle`` routes it
    (``cluster.route_query``), after refusing what routing does not
    carry."""
    query, routing = cluster.route_query(query, cfg.shuffle,
                                         cfg.num_compute_nodes)
    if routing is None:
        return query, None
    refused = [
        (requests is not None or bitmaps, "given requests or bitmaps"),
        (cfg.result_cache is not None, "the result cache"),
        (cfg.worker_pool is not None
         or cfg.storage_tier not in (None, STORAGE_INPROC),
         "the process tier"),
        (cfg.residual != runtime.RESIDUAL_INTERPRETER,
         f"the {cfg.residual!r} residual"),
        (getattr(query, "residual", None) is None, "a hand-built query")]
    for hit, what in refused:
        if hit:
            check_unrouted(cfg, what)
    return query, routing


def _run_decided(query, reqs: List[PlannedRequest], sim: SimResult,
                 cfg: EngineConfig, t_pushable: float, net_bytes: float,
                 bitmaps: Optional[Dict[int, torch.Tensor]] = None,
                 tier=None, routing: Optional[cluster.Routing] = None
                 ) -> QueryRun:
    """Execute the split ``sim`` decided for ``reqs`` (its storage side on
    ``tier``'s workers when given; its tables split over compute nodes by
    ``routing``), feed the corrector, run the residual and reconcile the
    bytes."""
    tr = obs_trace.get_tracer()
    exchange = cluster.Exchange() if routing is not None else None
    split = runtime.execute_split(reqs, sim.decisions(), bitmaps,
                                  executor=cfg.executor,
                                  cache=cfg.result_cache, faults=cfg.faults,
                                  retry=cfg.retry, breaker=cfg.breaker,
                                  tier=tier, routing=routing,
                                  exchange=exchange)
    # one decision vector, two uses: every admitted request ran pushdown
    # or, its retries exhausted, was demoted to pushback
    admitted = sim.admitted(query.qid)
    if split.n_pushdown + split.n_demoted != admitted:
        raise RuntimeError(f"{query.qid}: executed {split.n_pushdown} "
                           f"pushdowns and {split.n_demoted} demotions, "
                           f"arbitrated {admitted}")
    if cfg.corrector is not None:
        runtime.feed_corrector(cfg.corrector, query.qid, reqs, split.outcomes)
    with tr.span("residual_compute", qid=query.qid,
                 backend=cfg.residual) as rsp:
        result, trun = runtime.run_residual(query, split.merged,
                                            cfg.residual, exchange)
        if tr.enabled and trun is not None:
            tr.amend(rsp, backend="tensor", jit_hits=trun.jit_hits,
                     jit_misses=trun.jit_misses, fell_back=trun.fell_back)
    residual_jit = None
    if trun is not None:
        residual_jit = {"hits": trun.jit_hits, "misses": trun.jit_misses,
                        "fell_back": trun.fell_back,
                        "observed": trun.observed,
                        "n_stages": trun.n_stages}
    m = get_metrics()
    m.counter("engine.queries").inc()
    m.counter("engine.requests.pushdown").inc(split.n_pushdown)
    m.counter("engine.requests.pushback").inc(len(reqs) - split.n_pushdown)
    m.counter("engine.net_bytes.real").inc(split.real_net_bytes)
    n_hit = sum(1 for o in split.outcomes if o.cache)
    if n_hit:
        m.counter("engine.cache_hits").inc(n_hit)
    if split.n_demoted:
        m.counter("engine.requests.demoted").inc(split.n_demoted)
    if exchange is not None:
        exchange.publish()
    recovery = None
    if split.n_demoted or split.retries or split.faults_injected:
        recovery = {"n_demoted": split.n_demoted, "retries": split.retries,
                    "faults_injected": split.faults_injected}
    return QueryRun(
        qid=query.qid, result=result, sim=sim, t_pushable=t_pushable,
        t_nonpushable=nonpushable_time(split.merged, cfg, exchange),
        requests=reqs,
        net_bytes=net_bytes, n_admitted=admitted,
        n_pushed_back=sim.pushed_back_by_query.get(query.qid, 0),
        real_net_bytes=split.real_net_bytes,
        net_bytes_recon=runtime.reconcile_net_bytes(sim, reqs, split),
        outcomes=split.outcomes, recovery=recovery,
        residual_backend=("tensor" if trun is not None else "interpreter"),
        residual_jit=residual_jit,
        exchange=exchange.as_dict() if exchange is not None else None)


def _set_query_attrs(qs, run: QueryRun) -> None:
    """Roll the run's accounting up onto its ``query`` span."""
    recon = run.net_bytes_recon or {}
    qs.set(real_net_bytes=float(run.real_net_bytes),
           sim_net_bytes=float(run.net_bytes),
           n_pushdown=run.n_admitted, n_pushback=run.n_pushed_back,
           t_pushable=run.t_pushable, t_nonpushable=run.t_nonpushable,
           s_out_est_ratio=recon.get("s_out_estimate_ratio"),
           cache_hits=run.cache_hits, net_bytes_recon=recon)
    if run.exchange is not None:
        qs.set(exchange=run.exchange)


def _check_catalog(catalog: Catalog, cfg: EngineConfig) -> None:
    dev = resolve_device(cfg.device)
    if catalog.device != dev:
        raise ValueError(f"catalog lives on {catalog.device}, the engine is "
                         f"configured for {dev}")
    if cfg.executor == EXECUTOR_REFERENCE and dev.type != "cpu":
        raise ValueError("the reference executor is the CPU oracle; the "
                         "card runs the batched executor")


def run_query(query, catalog: Catalog, cfg: EngineConfig,
              requests: Optional[List[PlannedRequest]] = None,
              bitmaps: Optional[Dict[int, torch.Tensor]] = None) -> QueryRun:
    """Plan, arbitrate, execute and finish one query on ``cfg.device``
    (the GPU unless it says ``"cpu"``), which must hold the catalog.
    ``requests`` replaces the planned requests (e.g. recosted by
    ``core.bitmap.rewrite_all``); ``bitmaps`` maps request ids to the
    packed words their ``apply_bitmap`` plans filter with. Under
    ``cfg.shuffle`` other than ``"none"`` a request of a plan that hashes
    at storage is costed with it (``RequestCost.shuffled``)."""
    _check_catalog(catalog, cfg)
    query, routing = _routed(query, cfg, requests, bitmaps)
    tr = obs_trace.get_tracer()
    with tr.span("query", qid=query.qid, mode=cfg.mode) as qs:
        reqs = requests if requests is not None else plan_requests(
            query, catalog, corrector=cfg.corrector, cache=cfg.result_cache)
        if routing is not None and routing.at_storage:
            reqs = [dataclasses.replace(r, cost=r.cost.shuffled())
                    if r.table in routing.keys else r for r in reqs]
        sim = simulate([SimRequest(r.req_id, r.part.node_id, query.qid,
                                   r.cost) for r in reqs],
                       cfg.res, cfg.mode, measured=_measured_of(cfg),
                       breaker=cfg.breaker)
        run = _run_decided(query, reqs, sim, cfg, sim.makespan,
                           sim.net_bytes, bitmaps,
                           tier=resolve_tier(cfg, catalog), routing=routing)
        if tr.enabled:
            _set_query_attrs(qs, run)
    return run


def run_concurrent(queries, catalog: Catalog, cfg: EngineConfig
                   ) -> Dict[str, QueryRun]:
    """Several queries submitted at once (§6.2's PA-aware experiment): all
    their requests share the storage nodes' queues and slots in one
    simulation, then each query runs its decided split, finishing at its
    last request."""
    _check_catalog(catalog, cfg)
    check_unrouted(cfg, "run_concurrent")
    all_reqs: List[PlannedRequest] = []
    for q in queries:
        all_reqs.extend(plan_requests(q, catalog, start_id=len(all_reqs),
                                      corrector=cfg.corrector,
                                      cache=cfg.result_cache))
    sim = simulate([SimRequest(r.req_id, r.part.node_id, r.query_id, r.cost)
                    for r in all_reqs], cfg.res, cfg.mode,
                   measured=_measured_of(cfg), breaker=cfg.breaker)
    tr = obs_trace.get_tracer()
    tier = resolve_tier(cfg, catalog)
    out: Dict[str, QueryRun] = {}
    for q in queries:
        with tr.span("query", qid=q.qid, mode=cfg.mode,
                     concurrent=True) as qs:
            run = _run_decided(
                q, [r for r in all_reqs if r.query_id == q.qid], sim, cfg,
                t_pushable=sim.finish_by_query[q.qid],
                net_bytes=sim.net_bytes_by_query[q.qid], tier=tier)
            if tr.enabled:
                _set_query_attrs(qs, run)
        out[q.qid] = run
    return out


def compile_and_run(qid: str, catalog: Catalog, cfg: EngineConfig,
                    fact_selectivity: Optional[float] = None,
                    cost_based: bool = False) -> QueryRun:
    """Compiler front door: logical-plan IR -> amenability split -> run,
    i.e. ``run_query(compiler.compile_query(qid, fact_selectivity), ...)``.
    ``cost_based=True`` compiles with ``compile_query_costed`` instead: each
    table's cut is chosen by estimated cost over this catalog (and the
    config's corrector, when set); the results are the same."""
    from repro_torch import compiler  # deferred: a cycle
    if cost_based:
        cq = compiler.compile_query_costed(
            qid, catalog, res=cfg.res, corrector=cfg.corrector,
            fact_selectivity=fact_selectivity, compute_bw=cfg.compute_bw)
        return run_query(cq.query, catalog, cfg)
    return run_query(compiler.compile_query(qid, fact_selectivity), catalog,
                     cfg)


def theoretical_split(query, catalog: Catalog, res: StorageResources
                      ) -> optimum.Split:
    """The discrete oracle split (§3.1) of the query's requests, for the
    gap evaluation of Fig 7."""
    reqs = plan_requests(query, catalog)
    return optimum.discrete_optimum([r.cost for r in reqs], res)


def results_equal(a: ColumnTable, b: ColumnTable, tol: float = 1e-6) -> bool:
    """Order-insensitive table equality on the host: the same row multiset
    up to float tolerance (rows aligned by one lexsort over all columns,
    exact columns leading)."""
    a, b = a.to_numpy(), b.to_numpy()
    if set(a) != set(b):
        return False
    n = len(next(iter(a.values()))) if a else 0
    if n != (len(next(iter(b.values()))) if b else 0):
        return False
    if n == 0:
        return True
    cols = sorted(a)
    is_float = {c: a[c].dtype.kind in "fc" or b[c].dtype.kind in "fc"
                for c in cols}
    key_order = [c for c in cols if is_float[c]] + \
                [c for c in cols if not is_float[c]]
    ia = np.lexsort(tuple(a[c] for c in key_order))
    ib = np.lexsort(tuple(b[c] for c in key_order))
    for c in cols:
        x, y = a[c][ia], b[c][ib]
        if is_float[c]:
            if not np.allclose(x, y, rtol=tol, atol=tol):
                return False
        elif not np.array_equal(x, y):
            return False
    return True
