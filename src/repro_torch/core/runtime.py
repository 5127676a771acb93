"""Decision-faithful runtime: the Arbitrator's decisions route real work.

Port of ``repro.core.runtime``:

- pushdown requests run storage-side through the batched executor and
  ship only their results;
- pushback requests ship the raw accessed-column projection (a device
  copy) and the compute side replays the same compiled plan over it,
  through the same kernels.

Per-partition results merge in original request order, so the merged
tables are the same for any decision vector. Real bytes ride along:
pushdown requests are charged their result bytes plus any packed bitmap
they ship, pushback requests the stored bytes of their accessed columns
(the simulator's ``s_in``). Requests of ``apply_bitmap`` plans carry the
compute layer's words for their partition (``bitmaps``) down either
path.

A ``core.result_cache.ResultCache`` serves and fills the storage-side
pushdown groups. A ``core.faults.FaultPlan`` (passed in, or from
``REPRO_FAULT_SPEC``) sends every group through the recovery loop
(``_exec_group_recovered``): each attempt draws from the schedule at the
storage-execute boundary, failures retry under the charged deadline, and
an exhausted pushdown group is demoted to pushback, which is the pushback
path itself, on the same kernels. Without a plan and a cache the split
runs as it did before either existed.

A ``tier`` (a ``distributed.workers.WorkerPool``) runs the storage side
in worker processes: pushdown groups on the node's worker, pushback
groups fetched from it as serialized bytes and replayed here. A dead or
overdue worker raises ``core.faults.WorkerFault``, which the recovery
loop treats as a fault of its kind; a demoted group replays from this
process's catalog copy.

``run_stream`` is the arrival-timed driver of many queries at once:
per-node worker pools sized by the slot pools, dispatch ordered by the
Arbitrator's live decisions, pushback transfers as device copies, and
hedged storage futures under a ``core.faults.HedgePolicy``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from concurrent.futures import (FIRST_COMPLETED, Future, ThreadPoolExecutor,
                                TimeoutError as FutTimeout, wait as fut_wait)
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import cluster
from repro_torch.core import faults as _faults
from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN
from repro_torch.core.cost import CardinalityCorrector
from repro_torch.core.executor import (EXECUTOR_BATCHED, EXECUTOR_REFERENCE,
                                       CompiledPushPlan, compile_push_plan)
from repro_torch.core.plan import execute_push_plan, plan_signature
from repro_torch.core.simulator import SimRequest, simulate
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_metrics
from repro_torch.queryproc.table import ColumnTable


# residual backends (EngineConfig.residual): how the compute layer
# evaluates the residual plan over the merged tables.
#   interpreter — the tree-walker (compiler.interpreter), the oracle
#   tensor      — padded stage programs (compiler.tensorize), the same
#                 results
#   auto        — tensor iff the merged input has at least the calibrated
#                 crossover's rows (tensorize.auto_threshold)
RESIDUAL_INTERPRETER = "interpreter"
RESIDUAL_TENSOR = "tensor"
RESIDUAL_AUTO = "auto"
RESIDUALS = (RESIDUAL_INTERPRETER, RESIDUAL_TENSOR, RESIDUAL_AUTO)


def run_residual(query, merged: Dict[str, ColumnTable],
                 backend: str = RESIDUAL_INTERPRETER, exchange=None):
    """Evaluate ``query``'s residual over the merged per-table results.

    Returns ``(table, info)``: ``info`` is None on the interpreter path
    and a ``tensorize.TensorRun`` (program-cache hits and misses, fallback
    and observe accounting) on the tensor path. A query with no residual
    IR (the hand-built ones) runs its ``compute`` closure under every
    backend: the tensor backend needs the IR. With an ``exchange`` (a
    ``core.cluster.Exchange``: some merged tables are split over compute
    nodes) the interpreter runs the residual per node and counts the
    compute fabric's bytes into it."""
    if backend is not None and backend not in RESIDUALS:
        raise ValueError(f"unknown residual backend {backend!r}; "
                         f"expected one of {RESIDUALS}")
    residual = getattr(query, "residual", None)
    if exchange is not None:
        if residual is None or backend not in (None, RESIDUAL_INTERPRETER):
            raise ValueError("a residual over compute nodes needs the "
                             "compiled IR and the interpreter")
        from repro_torch.compiler import interpreter  # deferred: a cycle
        return interpreter.run(residual, merged, exchange), None
    if residual is None or backend in (None, RESIDUAL_INTERPRETER):
        return query.compute(merged), None
    from repro_torch.compiler import tensorize  # deferred: a cycle
    if backend == RESIDUAL_AUTO:
        rows = sum(len(t) for t in merged.values())
        if rows < tensorize.auto_threshold(tensorize.device_of(merged)):
            return query.compute(merged), None
    run = tensorize.execute(residual, merged)
    return run.table, run


@dataclasses.dataclass
class RequestOutcome:
    """What one request really did: where it ran and what it shipped."""
    req_id: int
    table: str
    path: str            # PUSHDOWN | PUSHBACK
    rows_out: int        # plan-output rows for this partition
    shipped_bytes: int   # pushdown: result bytes; pushback: stored s_in
    replayed: bool       # True when the plan ran at the compute layer
    cache: Optional[str] = None  # "exact" | "containment" when the result
    #                              cache served it
    attempts: int = 1    # storage-execute attempts (1: clean first try)
    demoted: bool = False  # decided pushdown, exhausted its retries and
    #                        ran as pushback (``path`` says so)
    hedged: bool = False   # a hedge duplicate won this group's race


@dataclasses.dataclass
class SplitExecution:
    """Merged tables + real-traffic accounting of one decision vector."""
    merged: Dict[str, ColumnTable]
    outcomes: List[RequestOutcome]   # original request order
    n_pushdown: int
    n_pushback: int
    pushdown_bytes: int
    pushback_bytes: int
    n_demoted: int = 0         # decided-pushdown requests demoted
    retries: int = 0           # retried attempts over all groups
    faults_injected: int = 0   # injected fault events this run hit

    @property
    def real_net_bytes(self) -> int:
        return self.pushdown_bytes + self.pushback_bytes


def result_bytes(result: ColumnTable, aux: Dict) -> int:
    """Bytes a pushdown result ships: its columns (64-byte floor for an
    empty one) plus the packed bitmap of a ``bitmap_only`` plan."""
    b = result.nbytes(stored=False) if len(result) else 64
    if "bitmap" in aux:
        b += aux["bitmap"].numel() * aux["bitmap"].element_size()
    return int(b)


def pushback_bytes(cplan: CompiledPushPlan, data: ColumnTable) -> int:
    """Stored bytes of the raw accessed-column projection (exactly ``s_in``)."""
    return int(data.nbytes([c for c in cplan.accessed if c in data.cols],
                           stored=True))


def _exec_group(cplan: CompiledPushPlan, sub, path: str, executor: str,
                bitmaps: Optional[Dict[int, torch.Tensor]] = None,
                shipped: Optional[List[ColumnTable]] = None,
                cache=None, tier=None,
                parent: Optional[obs_trace.Span] = None
                ) -> List[Tuple[ColumnTable, Dict]]:
    """Execute one same-(table, plan, path) request group: pushdown over
    the partitions, pushback over raw projections replayed compute-side
    (``shipped``: projections the stream driver already copied). ``cache``
    serves and fills the storage-side pushdown path only. ``tier`` sends
    a pushdown group to its node's worker process, and fetches a pushback
    group's projections from it to replay here; ``parent`` is the span
    the worker's spans are adopted under."""
    if tier is not None and shipped is None:
        if path == PUSHDOWN:
            return tier.execute_group(cplan, sub, executor, bitmaps=bitmaps,
                                      parent=parent)
        shipped = tier.fetch_projection(cplan, sub, parent=parent)
    if shipped is not None:
        tabs = shipped
    elif path == PUSHDOWN:
        tabs = [r.part.data for r in sub]
    else:  # ship the raw projection, replay compute-side
        tabs = [cplan.raw_projection(r.part.data) for r in sub]
    bms = [bitmaps[r.req_id] for r in sub] if bitmaps else None
    if executor == EXECUTOR_REFERENCE:
        return [execute_push_plan(cplan.plan, t,
                                  None if bms is None else bms[i])
                for i, t in enumerate(tabs)]
    use_cache = cache is not None and path == PUSHDOWN and shipped is None
    parts, aux = cplan.execute_batch_parts(
        tabs, bms, cache=cache if use_cache else None,
        parts=[r.part for r in sub] if use_cache else None)
    return list(zip(parts, aux))


def _exec_group_traced(cplan: CompiledPushPlan, sub, path: str,
                       executor: str,
                       bitmaps: Optional[Dict[int, torch.Tensor]] = None,
                       shipped: Optional[List[ColumnTable]] = None,
                       parent: Optional[obs_trace.Span] = None,
                       node: Optional[int] = None, cache=None, tier=None
                       ) -> Tuple[List[Tuple[ColumnTable, Dict]],
                                  obs_trace.Span]:
    """``_exec_group`` under a span (child of ``parent`` when given),
    ``storage_execute`` for pushdown and ``compute_replay`` for pushback;
    the closed span comes back so the caller can attach the
    ``shipped_bytes`` it accounts anyway."""
    tr = obs_trace.get_tracer()
    name = "storage_execute" if path == PUSHDOWN else "compute_replay"
    with tr.span(name, parent=parent, table=sub[0].table, n_parts=len(sub),
                 node=node) as sp:
        out = _exec_group(cplan, sub, path, executor, bitmaps=bitmaps,
                          shipped=shipped, cache=cache, tier=tier, parent=sp)
        if tr.enabled:
            sp.set(rows_out=int(sum(len(res) for res, _ in out)),
                   signature=plan_signature(cplan.plan),
                   cache_hits=sum(1 for _res, a in out if a.get("cache")))
    return out, sp


@dataclasses.dataclass
class GroupRecovery:
    """What recovery did for one executed request group."""
    attempts: int = 1                 # executions tried (the success too)
    retries: int = 0                  # failed attempts that were retried
    injected: List[str] = dataclasses.field(default_factory=list)
    demoted: bool = False             # exhausted: the fallback ran


def _exec_group_recovered(cplan: CompiledPushPlan, sub, path: str,
                          executor: str,
                          faults: Optional["_faults.FaultPlan"],
                          retry: "_faults.RetryPolicy",
                          breaker: Optional["_faults.CircuitBreaker"] = None,
                          bitmaps: Optional[Dict[int, torch.Tensor]] = None,
                          shipped: Optional[List[ColumnTable]] = None,
                          parent: Optional[obs_trace.Span] = None,
                          node: Optional[int] = None, cache=None,
                          salt: str = "", tier=None,
                          abort: Optional[threading.Event] = None
                          ) -> Tuple[List[Tuple[ColumnTable, Dict]],
                                     obs_trace.Span, GroupRecovery]:
    """``_exec_group_traced`` under the fault and recovery contract.

    Each attempt draws from the ``FaultPlan`` (when there is one) at the
    storage-execute boundary, keyed ``"<min req_id>x<n requests>"``. A
    ``straggler`` completes late (its delay charged, and slept scaled by
    ``retry.real_scale()``); ``crash``/``timeout``/``transient`` abort the
    attempt, charge the deadline their nominal detection cost and retry
    after capped exponential backoff with deterministic jitter. On the
    process ``tier`` a real :class:`core.faults.WorkerFault` (a dead or
    overdue worker) is handled as an injected fault of its kind, except
    that a real timeout has already waited on the wire and is not slept.
    On exhaustion (attempts or charged budget):

    - ``retry.demote_on_exhaust``: a pushdown group is **demoted to
      pushback** (the raw projection shipped and replayed compute-side on
      the same kernels); a pushback group replays from the durable
      projection (``retry.local_replays``). The fallback is not drawn
      from the schedule again, and runs in this process from its own
      catalog copy whatever the tier: recovery lies outside the fault
      model.
    - otherwise: raise ``core.faults.FaultExhausted``, the fail-to-error
      baseline.

    ``salt`` varies the draws (a hedge duplicate is a new attempt, not a
    replay). ``abort`` is a hedge loser's token: once set, the loop raises
    ``core.faults.HedgeAborted`` at its next attempt boundary and before
    the demote fallback, so a lost race charges no further draws,
    counters or demotions. Kernels it already launched run to their end.

    Every outcome feeds the breaker (when given) and the
    ``faults.node<N>.<path>.failures``/``.successes`` counters."""
    m = get_metrics()
    tr = obs_trace.get_tracer()
    node_id = node if node is not None else sub[0].part.node_id
    table = sub[0].table
    key = f"{min(r.req_id for r in sub)}x{len(sub)}"
    rec = GroupRecovery()
    budget = retry.deadline_s
    scale = retry.real_scale()
    attempt = 1
    while True:
        if abort is not None and abort.is_set():
            raise _faults.HedgeAborted(node_id, path, table)
        action = faults.draw(node_id, path, table, key, attempt, salt) \
            if faults is not None else None
        real = False
        if action is None or action.kind == _faults.FAULT_STRAGGLER:
            if action is not None:
                m.counter(f"faults.{_faults.FAULT_STRAGGLER}").inc()
                rec.injected.append(_faults.FAULT_STRAGGLER)
                delay = action.param if action.param is not None \
                    else retry.attempt_timeout_s
                if tr.enabled:
                    tr.event("fault_injected", parent=parent,
                             kind=_faults.FAULT_STRAGGLER, node=node_id,
                             table=table, path=path, attempt=attempt,
                             delay_s=delay)
                if delay * scale > 0:
                    time.sleep(delay * scale)
            try:
                out, sp = _exec_group_traced(cplan, sub, path, executor,
                                             bitmaps=bitmaps, shipped=shipped,
                                             parent=parent, node=node_id,
                                             cache=cache, tier=tier)
            except _faults.WorkerFault as wf:
                kind, real = wf.kind, True
            else:
                rec.attempts = attempt
                m.counter(f"faults.node{node_id}.{path}.successes").inc()
                if breaker is not None:
                    breaker.record_success(node_id, path)
                return out, sp, rec
        else:
            kind = action.kind
            rec.injected.append(kind)
        m.counter(f"faults.{kind}").inc()
        m.counter(f"faults.node{node_id}.{path}.failures").inc()
        if breaker is not None:
            breaker.record_failure(node_id, path)
        if tr.enabled:
            tr.event("worker_fault" if real else "fault_injected",
                     parent=parent, kind=kind, node=node_id, table=table,
                     path=path, attempt=attempt)
        charge = retry.charge(kind)
        budget -= charge
        if not real and kind == _faults.FAULT_TIMEOUT and charge * scale > 0:
            time.sleep(charge * scale)  # an injected timeout waits the
            #   attempt out; a real one already did, on the wire
        if attempt < retry.max_attempts and budget > 0:
            back = retry.backoff_s(attempt, faults.jitter(
                node_id, path, table, key, attempt)
                if faults is not None else 0.5)
            budget -= back
            if budget > 0:
                rec.retries += 1
                m.counter("retry.attempts").inc()
                if tr.enabled:
                    tr.event("retry", parent=parent, attempt=attempt + 1,
                             node=node_id, table=table, backoff_s=back,
                             budget_s=budget)
                if back * scale > 0:
                    time.sleep(back * scale)
                attempt += 1
                continue
        # exhausted: attempts or the charged deadline budget ran out
        rec.attempts = attempt
        if not retry.demote_on_exhaust:
            m.counter("retry.exhausted").inc()
            raise _faults.FaultExhausted(kind, node_id, path, table, attempt)
        if abort is not None and abort.is_set():
            raise _faults.HedgeAborted(node_id, path, table)
        rec.demoted = True
        m.counter("retry.demotions" if path == PUSHDOWN
                  else "retry.local_replays").inc()
        with tr.span("demote", parent=parent, node=node_id, table=table,
                     from_path=path, attempts=attempt, kind=kind):
            out, sp = _exec_group_traced(cplan, sub, PUSHBACK, executor,
                                         bitmaps=bitmaps, shipped=shipped,
                                         parent=parent, node=node_id)
        if breaker is not None and path == PUSHDOWN:
            # the fallback succeeded on the other path
            breaker.record_success(node_id, PUSHBACK)
        return out, sp, rec


def execute_split(reqs, decisions: Dict[int, str],
                  bitmaps: Optional[Dict[int, torch.Tensor]] = None,
                  executor: str = EXECUTOR_BATCHED, cache=None,
                  faults=None, retry=None, breaker=None,
                  tier=None, routing=None,
                  exchange=None) -> SplitExecution:
    """Route every request down its decided path and merge.

    ``reqs`` are ``engine.PlannedRequest``s; ``decisions`` maps
    ``req_id -> PUSHDOWN | PUSHBACK`` (missing ids default to pushdown);
    ``bitmaps`` maps ``req_id`` to the packed words an ``apply_bitmap``
    plan filters its partition with. Requests sharing a (table, plan,
    path) run as one fused batch, and the per-table merge keeps request
    order, so the merged tables are the same for any decision vector.

    ``executor``: ``"batched"`` (one device pass per group) or
    ``"reference"`` (``plan.execute_push_plan`` per partition).
    ``cache``: a ``core.result_cache.ResultCache`` for the pushdown
    groups. ``faults``/``retry``/``breaker`` (``core.faults``): with a
    plan (passed in, or from ``REPRO_FAULT_SPEC``) groups split further
    per storage node, the fleet's failure unit, and each runs through the
    recovery loop; the split then carries ``n_demoted``, ``retries`` and
    ``faults_injected``. ``tier`` (a ``distributed.workers.WorkerPool``)
    runs the storage side in its worker processes: groups split per node
    (each worker holds its node's partitions), the recovery loop is armed
    so that a real worker fault retries and demotes, and the cache is
    bypassed (the workers hold the storage side).

    ``routing`` (a ``core.cluster.Routing``) splits each of its tables
    over the compute nodes in place of the merge: the merged value is a
    ``core.cluster.Partitioned``, and ``exchange`` (a
    ``core.cluster.Exchange``) counts the rows routed at compute. A
    pushed-back request of a plan that hashes at storage is replayed
    without the partition function, then routed. Routing runs neither
    with a fault plan nor on a tier."""
    if faults is None:
        faults = _faults.env_plan()
    if routing is not None and (faults is not None or tier is not None):
        raise ValueError("a split routed over compute nodes runs neither "
                         "under a fault plan nor on a storage tier")
    recovered = faults is not None or tier is not None
    if recovered and retry is None:
        retry = _faults.RetryPolicy()
    if tier is not None:
        cache = None
    tr = obs_trace.get_tracer()
    with tr.span("execute_split", n_requests=len(reqs)) as es:
        per_req: Dict[int, ColumnTable] = {}
        out_by_id: Dict[int, RequestOutcome] = {}
        n_pd = n_pb = n_dem = retries = injected = 0
        pd_bytes = pb_bytes = 0
        groups: Dict[Tuple, List] = {}
        for r in reqs:
            gkey = (r.table, id(r.plan)) if not recovered \
                else (r.table, id(r.plan), r.part.node_id)
            groups.setdefault(gkey, []).append(r)
        aux_of: Dict[int, Dict] = {}
        for rs in groups.values():
            cplan = compile_push_plan(rs[0].plan)
            for path in (PUSHDOWN, PUSHBACK):
                sub = [r for r in rs
                       if decisions.get(r.req_id, PUSHDOWN) == path]
                if not sub:
                    continue
                if path == PUSHBACK and routing is not None \
                        and cplan.plan.shuffle is not None:
                    # raw at the compute layer: replayed, then routed
                    cplan = compile_push_plan(dataclasses.replace(
                        cplan.plan, shuffle=None))
                rec = None
                if not recovered:
                    out, gsp = _exec_group_traced(
                        cplan, sub, path, executor, bitmaps=bitmaps,
                        cache=cache)
                else:
                    out, gsp, rec = _exec_group_recovered(
                        cplan, sub, path, executor, faults, retry,
                        breaker=breaker, bitmaps=bitmaps, cache=cache,
                        tier=tier)
                    retries += rec.retries
                    injected += len(rec.injected)
                demoted = rec is not None and rec.demoted \
                    and path == PUSHDOWN
                eff_path = PUSHBACK if rec is not None and rec.demoted \
                    else path
                g_bytes = 0
                for r, (res, aux) in zip(sub, out):
                    per_req[r.req_id] = res
                    if routing is not None:
                        aux_of[r.req_id] = aux
                    if eff_path == PUSHDOWN:
                        b = result_bytes(res, aux)
                        pd_bytes += b
                        n_pd += 1
                    else:
                        b = pushback_bytes(cplan, r.part.data)
                        pb_bytes += b
                        n_pb += 1
                        if demoted:
                            n_dem += 1
                    g_bytes += b
                    out_by_id[r.req_id] = RequestOutcome(
                        r.req_id, r.table, eff_path, len(res), b,
                        replayed=(eff_path == PUSHBACK),
                        cache=aux.get("cache"),
                        attempts=rec.attempts if rec is not None else 1,
                        demoted=demoted)
                tr.amend(gsp, shipped_bytes=int(g_bytes))
        by_table: Dict[str, List[ColumnTable]] = {}
        for r in reqs:
            by_table.setdefault(r.table, []).append(per_req[r.req_id])
        routed = routing.keys if routing is not None else {}
        with tr.span("merge", tables=sorted(set(by_table) - set(routed))):
            merged = {t: ColumnTable.concat(parts)
                      for t, parts in by_table.items() if t not in routed}
        for t, key in routed.items():
            merged[t] = cluster.assemble(
                t, key, routing.n,
                [(r.part.index, per_req[r.req_id], aux_of[r.req_id])
                 for r in reqs if r.table == t], exchange)
        outs = [out_by_id[r.req_id] for r in reqs]
        if tr.enabled:
            es.set(n_pushdown=n_pd, n_pushback=n_pb,
                   pushdown_bytes=int(pd_bytes),
                   pushback_bytes=int(pb_bytes),
                   cache_hits=sum(1 for o in outs if o.cache),
                   n_demoted=n_dem, retries=retries,
                   faults_injected=injected, outcomes=outs)
    return SplitExecution(merged, outs, n_pd, n_pb, pd_bytes, pb_bytes,
                          n_demoted=n_dem, retries=retries,
                          faults_injected=injected)


def reconcile_net_bytes(sim, reqs, split: SplitExecution) -> Dict:
    """Line real shipped bytes up against the simulator's ``net_bytes``:
    the pushback component matches exactly, the pushdown one differs by
    the cost model's ``s_out`` estimation error, overall
    (``s_out_estimate_ratio``, sim / real) and per table (``by_table``,
    what the ``CardinalityCorrector`` learns from)."""
    decisions = sim.decisions()
    sim_pd = sum(r.cost.s_out for r in reqs
                 if decisions.get(r.req_id, PUSHDOWN) == PUSHDOWN)
    sim_pb = sum(r.cost.s_in for r in reqs
                 if decisions.get(r.req_id, PUSHDOWN) == PUSHBACK)
    by_table: Dict[str, Dict[str, float]] = {}
    real_pd_by_id = {o.req_id: o.shipped_bytes for o in split.outcomes
                     if o.path == PUSHDOWN}
    for r in reqs:
        if r.req_id not in real_pd_by_id:
            continue
        row = by_table.setdefault(r.table, {"sim_pushdown_bytes": 0,
                                            "real_pushdown_bytes": 0})
        row["sim_pushdown_bytes"] += r.cost.s_out
        row["real_pushdown_bytes"] += real_pd_by_id[r.req_id]
    for row in by_table.values():
        row["s_out_estimate_ratio"] = (
            row["sim_pushdown_bytes"] / row["real_pushdown_bytes"]
            if row["real_pushdown_bytes"] else None)
    return {
        "sim_net_bytes": sim_pd + sim_pb,
        "real_net_bytes": split.real_net_bytes,
        "sim_pushdown_bytes": sim_pd,
        "real_pushdown_bytes": split.pushdown_bytes,
        "sim_pushback_bytes": sim_pb,
        "real_pushback_bytes": split.pushback_bytes,
        "s_out_estimate_ratio": (sim_pd / split.pushdown_bytes
                                 if split.pushdown_bytes else None),
        "by_table": by_table,
    }


def feed_corrector(corrector: CardinalityCorrector, qid: str, reqs,
                   outcomes: Sequence[RequestOutcome]) -> None:
    """Feed one executed decision split back into the corrector: per
    (table, frontier signature), the summed uncorrected ``s_out`` estimate
    of the pushdown requests against the bytes they really shipped.
    Pushback requests teach nothing: their bytes (stored ``s_in``) are
    exact by construction."""
    real_by_id = {o.req_id: o.shipped_bytes for o in outcomes
                  if o.path == PUSHDOWN}
    groups: Dict[Tuple[str, str], List] = {}
    for r in reqs:
        if r.req_id in real_by_id:
            groups.setdefault((r.table, plan_signature(r.plan)),
                              []).append(r)
    for (table, sig), rs in groups.items():
        est = sum(r.s_out_raw or r.cost.s_out for r in rs)
        real = sum(real_by_id[r.req_id] for r in rs)
        corrector.observe(qid, table, sig, est, real)


# ------------------------------------------------- concurrent stream driver
@dataclasses.dataclass
class StreamQuery:
    query: object                 # queries.Query
    arrival: float = 0.0          # seconds after the stream starts


@dataclasses.dataclass
class StreamRun:
    mode: str
    wall_clock: float             # execution makespan, seconds
    t_decide: float               # planning + arbitration (the fluid
    #   simulator) seconds, kept out of wall_clock: the simulator stands in
    #   for the storage node's microsecond-scale arbitration
    per_query: Dict[str, Dict]    # key -> timings + split counts
    results: Dict[str, ColumnTable]   # key -> final query result
    sim: object                   # the shared SimResult
    n_pushdown: int
    n_pushback: int
    real_net_bytes: int
    n_demoted: int = 0
    retries: int = 0
    hedged: int = 0               # hedge races won by the duplicate


def _ship(cplan: CompiledPushPlan, parts_data: List[ColumnTable]
          ) -> List[ColumnTable]:
    """The pushback transfer: a device copy of each partition's raw
    accessed-column projection (``CompiledPushPlan.raw_projection``), so
    the replay reads moved bytes, not the partition in place."""
    return [cplan.raw_projection(d) for d in parts_data]


def _ship_traced(cplan: CompiledPushPlan, parts_data: List[ColumnTable],
                 parent: Optional[obs_trace.Span] = None,
                 node: Optional[int] = None) -> List[ColumnTable]:
    """``_ship`` under a ``pushback_ship`` span; its ``ship_bytes`` is the
    stored ``s_in`` the transfer moves, which the matching
    ``compute_replay`` span counts once as ``shipped_bytes``."""
    tr = obs_trace.get_tracer()
    with tr.span("pushback_ship", parent=parent,
                 n_parts=len(parts_data), node=node) as sp:
        out = _ship(cplan, parts_data)
        if tr.enabled:
            sp.set(ship_bytes=int(sum(pushback_bytes(cplan, d)
                                      for d in parts_data)))
    return out


def run_stream(stream: Sequence[StreamQuery], catalog, cfg,
               time_scale: float = 1.0) -> StreamRun:
    """Drive an arrival-timed stream of queries through real split
    execution on per-node worker pools sized by the slot pools.

    Per storage node: ``res.pd_slots`` pushdown-execution workers and
    ``res.pb_slots`` transfer workers (a pushback slot is the transfer, as
    in the simulator), each capped at the node's share of the host's
    cores; a compute pool replays pushed-back groups, and a finish pool
    merges each query and runs its residual. All requests of the stream
    are planned and arbitrated together in one simulation (arrivals
    ``time_scale`` seconds apart per unit), and each query's groups are
    dispatched in the order the Arbitrator decided them. A query id that
    appears several times is keyed ``qid``, ``qid#1``, ... in
    ``per_query`` and ``results``.

    Under a ``cfg.hedge`` policy, a pushdown group still running after the
    calibrated delay gets a duplicate on the same node's pool; the first
    to finish wins and only its results reach the bytes, the counters and
    the calibration samples. Calibration samples are host-clock seconds
    of a group until its device work is done: on the GPU the worker
    synchronizes its stream before reading the clock.

    Every worker launches on the current stream of the catalog's device,
    which a pool thread leaves at the device's default stream: all
    workers share one CUDA stream, so the card runs their kernels one
    after another, in the order the host queued them. ``cfg.device`` must
    hold the catalog.

    On the process tier (``cfg.storage_tier="process"`` or
    ``cfg.worker_pool``) every storage group runs through the recovery
    loop on its node's worker process: pushdown on the exec pool, the
    pushback fetch on the transfer pool (a dead worker mid-fetch retries
    and replays locally), neither gated by the core semaphore (the thread
    waits on the wire), and each dispatch wave polls the workers' load
    into the gauges.
    """
    from repro_torch.core import engine as _engine  # engine imports us
    _engine._check_catalog(catalog, cfg)
    _engine.check_unrouted(cfg, "run_stream")
    tr = obs_trace.get_tracer()
    with tr.span("run_stream", mode=cfg.mode,
                 n_queries=len(stream)) as stream_span:
        return _run_stream_body(stream, catalog, cfg, time_scale, tr,
                                stream_span, _engine)


def _run_stream_body(stream, catalog, cfg, time_scale, tr, stream_span,
                     _engine) -> StreamRun:
    metrics = get_metrics()
    t_plan0 = time.perf_counter()
    ordered = sorted(stream, key=lambda s: s.arrival)
    seen: Dict[str, int] = {}
    keys: List[str] = []
    for sq in ordered:
        n = seen.get(sq.query.qid, 0)
        seen[sq.query.qid] = n + 1
        keys.append(sq.query.qid if n == 0 else f"{sq.query.qid}#{n}")
    all_reqs: List = []
    reqs_by_key: Dict[str, List] = {}
    cache = cfg.result_cache
    for key, sq in zip(keys, ordered):
        reqs = _engine.plan_requests(sq.query, catalog,
                                     start_id=len(all_reqs),
                                     corrector=cfg.corrector, cache=cache)
        for r in reqs:
            r.query_id = key   # one simulation identity per stream entry
        reqs_by_key[key] = reqs
        all_reqs.extend(reqs)
    arrival_of = dict(zip(keys, (sq.arrival for sq in ordered)))
    sim_reqs = [SimRequest(r.req_id, r.part.node_id, r.query_id, r.cost,
                           arrival=arrival_of[r.query_id])
                for r in all_reqs]
    decision_pos: Dict[int, int] = {}
    sim = simulate(sim_reqs, cfg.res, cfg.mode,
                   on_decision=lambda rid, _path: decision_pos.setdefault(
                       rid, len(decision_pos)),
                   measured=_engine._measured_of(cfg), breaker=cfg.breaker)
    decisions = sim.decisions()
    t_decide = time.perf_counter() - t_plan0

    nodes = sorted({r.part.node_id for r in all_reqs})
    # pools sized by the slot pools, capped at each node's share of the
    # host's cores, and a semaphore capping running tasks at the core
    # count: the pools carry the paper's queueing (which path waits on
    # which slot class), the semaphore the host's physics
    ncpu = os.cpu_count() or 1
    per_node = max(1, ncpu // max(1, len(nodes)))
    cores = threading.BoundedSemaphore(ncpu)
    exec_pools = {n: ThreadPoolExecutor(
        max(1, min(cfg.res.pd_slots, per_node))) for n in nodes}
    ship_pools = {n: ThreadPoolExecutor(
        max(1, min(cfg.res.pb_slots, per_node))) for n in nodes}
    compute_pool = ThreadPoolExecutor(
        max(1, min(2 * cfg.num_compute_nodes, ncpu)))
    finish_pool = ThreadPoolExecutor(max(1, min(len(ordered),
                                                max(2, ncpu))))

    faults = cfg.faults if cfg.faults is not None else _faults.env_plan()
    # the process tier arms the recovery loop: real worker faults retry
    # and demote even without a fault plan
    tier = _engine.resolve_tier(cfg, catalog)
    recovered = faults is not None or tier is not None
    retry = cfg.retry
    if recovered and retry is None:
        retry = _faults.RetryPolicy()
    hedge = cfg.hedge
    breaker = cfg.breaker
    exec_samples: List[float] = []     # the winners' group durations, which
    samples_lock = threading.Lock()    # the hedge delay calibrates on
    dev = catalog.device
    if dev.type == "cuda":
        def device_done():
            torch.cuda.current_stream(dev).synchronize()
    else:
        def device_done():
            pass

    def on_core(fn, *args, **kw):
        with cores:
            return fn(*args, **kw)

    def ungated(fn, *args, **kw):
        return fn(*args, **kw)
    # on the process tier a storage thread waits on the wire while the
    # worker process works: the core semaphore would serialize the waits
    gate = on_core if tier is None else ungated

    def exec_group(cplan, sub, path, shipped=None, qspan=None, node=None,
                   salt="", abort=None):
        """One storage-execute (or replay) group, through the recovery
        loop under a fault plan: ``(out, span, GroupRecovery or None,
        seconds until its device work was done)``."""
        t_ex = time.perf_counter()
        if not recovered:
            out, sp = _exec_group_traced(cplan, sub, path, cfg.executor,
                                         shipped=shipped, parent=qspan,
                                         node=node, cache=cache)
            rec = None
        else:
            out, sp, rec = _exec_group_recovered(
                cplan, sub, path, cfg.executor, faults, retry,
                breaker=breaker, shipped=shipped, parent=qspan, node=node,
                cache=cache, salt=salt, tier=tier, abort=abort)
        device_done()
        return out, sp, rec, time.perf_counter() - t_ex

    def sample_wave(qspan) -> None:
        """The load at each dispatch wave: the slot pools' queue depths
        and the free cores, or on the process tier each worker's own
        snapshot polled over the wire (``WorkerPool.publish_load``),
        written to the gauges ``MeasuredLoad`` reads and, when tracing,
        stamped on the query as a ``wave_sample``."""
        cores_free = getattr(cores, "_value", None)
        if cores_free is not None:
            metrics.gauge("stream.cores_free").set(cores_free)
        if tier is not None:
            loads = tier.publish_load()
            if tr.enabled:
                tr.event("wave_sample", parent=qspan, worker_loads=loads,
                         cores_free=cores_free)
            return
        exec_q = {n: exec_pools[n]._work_queue.qsize() for n in nodes}
        ship_q = {n: ship_pools[n]._work_queue.qsize() for n in nodes}
        for n in nodes:
            metrics.gauge(f"stream.node{n}.exec_queue").set(exec_q[n])
            metrics.gauge(f"stream.node{n}.ship_queue").set(ship_q[n])
        if tr.enabled:
            tr.event("wave_sample", parent=qspan, exec_queue=exec_q,
                     ship_queue=ship_q, cores_free=cores_free)

    def submit_query(key: str, qspan) -> List[Tuple[object, Future]]:
        """Fan the query's requests out as (request group, future) chunks
        in decision order."""
        sample_wave(qspan)
        chunks: Dict[Tuple[str, int, int, str], List] = {}
        for r in reqs_by_key[key]:
            path = decisions.get(r.req_id, PUSHDOWN)
            chunks.setdefault(
                (r.table, id(r.plan), r.part.node_id, path), []).append(r)
        futs: List[Tuple[object, Future]] = []
        for (_table, _pid, node, path), sub in sorted(
                chunks.items(),
                key=lambda kv: min(decision_pos.get(r.req_id, 0)
                                   for r in kv[1])):
            cplan = compile_push_plan(sub[0].plan)
            abort = threading.Event() if hedge is not None else None
            if path == PUSHDOWN:
                fut = exec_pools[node].submit(
                    gate, exec_group, cplan, sub, path,
                    qspan=qspan, node=node, abort=abort)
            elif tier is not None:
                # the fetch is a wire transfer made inside the recovery
                # loop, on the node's transfer pool; the replay follows
                fut = ship_pools[node].submit(
                    gate, exec_group, cplan, sub, path,
                    qspan=qspan, node=node, abort=abort)
            else:
                ship_fut = ship_pools[node].submit(
                    on_core, _ship_traced, cplan,
                    [r.part.data for r in sub], parent=qspan, node=node)
                # wait for the transfer outside the core gate, replay in it
                fut = compute_pool.submit(
                    lambda cp=cplan, s=sub, sf=ship_fut, qs=qspan, nd=node,
                    ab=abort:
                    on_core(exec_group, cp, s, PUSHBACK,
                            shipped=sf.result(), qspan=qs, node=nd,
                            abort=ab))
            futs.append(((sub, path, cplan, node, abort), fut))
        return futs

    t0 = time.perf_counter()

    def resolve(meta, fut, qspan):
        """Await one group's future, hedging a pushdown straggler: past
        the calibrated delay a duplicate (salted, so its fault draws
        differ) runs on the same node's pool, and the first to finish
        wins. The loser is cancelled if still queued and its abort token
        set otherwise, so it stops at its next attempt boundary. Only the
        winner's results and duration reach the accounting and the
        calibration samples (``stream.exec_samples`` counts them), however
        close the race. Returns ``(out, span, rec, hedge_won)``."""
        sub, path, cplan, node, abort = meta
        delay = None
        if hedge is not None and path == PUSHDOWN:
            with samples_lock:
                delay = hedge.delay_s(exec_samples)
        winner, won = fut, False
        if delay is not None:
            try:
                fut.result(timeout=delay)
            except FutTimeout:
                metrics.counter("hedge.launched").inc()
                if tr.enabled:
                    tr.event("hedge", parent=qspan, node=node,
                             table=sub[0].table, delay_s=delay)
                dup_abort = threading.Event()
                dup = exec_pools[node].submit(
                    gate, exec_group, cplan, sub, path, qspan=qspan,
                    node=node, salt="hedge", abort=dup_abort)
                done, _ = fut_wait({fut, dup}, return_when=FIRST_COMPLETED)
                if fut not in done:                # the original preferred
                    winner, won = dup, True
                loser, loser_abort = (fut, abort) if won \
                    else (dup, dup_abort)
                loser.cancel()
                loser_abort.set()
                metrics.counter("hedge.won" if won else "hedge.lost").inc()
        out, sp, rec, seconds = winner.result()
        with samples_lock:
            exec_samples.append(seconds)
        metrics.counter("stream.exec_samples").inc()
        return out, sp, rec, won

    def finish_query(key: str, sq: StreamQuery, futs, qspan) -> Dict:
        try:
            return _finish_query(key, sq, futs, qspan)
        except BaseException as e:
            # close the query span with the failure and re-raise: the
            # driver surfaces it after draining the other queries
            if tr.enabled:
                tr.end(qspan, error=repr(e))
            raise

    def _finish_query(key: str, sq: StreamQuery, futs, qspan) -> Dict:
        per_req: Dict[int, ColumnTable] = {}
        outcomes: List[RequestOutcome] = []
        n_pd = n_pb = n_hit = n_dem = n_retry = n_hedge = 0
        pd_b = pb_b = 0
        for meta, fut in futs:
            sub, path, cplan, _node, _abort = meta
            out, gsp, rec, hedged = resolve(meta, fut, qspan)
            eff_path = PUSHBACK if (rec is not None and rec.demoted) \
                else path
            demoted = eff_path != path
            if rec is not None:
                n_retry += rec.retries
            if hedged:
                n_hedge += 1
            g_bytes = 0
            for r, (res, aux) in zip(sub, out):
                per_req[r.req_id] = res
                if eff_path == PUSHDOWN:
                    n_pd += 1
                    b = result_bytes(res, aux)
                    pd_b += b
                else:
                    n_pb += 1
                    b = pushback_bytes(cplan, r.part.data)
                    pb_b += b
                    if demoted:
                        n_dem += 1
                g_bytes += b
                kind = aux.get("cache")
                if kind:
                    n_hit += 1
                outcomes.append(RequestOutcome(
                    r.req_id, r.table, eff_path, len(res), b,
                    replayed=(eff_path == PUSHBACK), cache=kind,
                    attempts=rec.attempts if rec is not None else 1,
                    demoted=demoted, hedged=hedged))
            tr.amend(gsp, shipped_bytes=int(g_bytes))
        if cfg.corrector is not None:
            # the correction belongs to the query, not the stream slot
            feed_corrector(cfg.corrector, sq.query.qid, reqs_by_key[key],
                           outcomes)
        by_table: Dict[str, List[ColumnTable]] = {}
        for r in reqs_by_key[key]:
            by_table.setdefault(r.table, []).append(per_req[r.req_id])

        def merge_and_compute():
            with tr.span("merge", parent=qspan, tables=sorted(by_table)):
                merged = {t: ColumnTable.concat(p)
                          for t, p in by_table.items()}
            with tr.span("residual_compute", parent=qspan) as rsp:
                res, trun = run_residual(sq.query, merged, cfg.residual)
                if tr.enabled:
                    tr.amend(rsp, backend=("tensor" if trun is not None
                                           else "interpreter"),
                             jit_hits=(trun.jit_hits if trun else None),
                             jit_misses=(trun.jit_misses if trun else None))
                return res

        result = on_core(merge_and_compute)
        sim_pd = sum(r.cost.s_out for r in reqs_by_key[key]
                     if decisions.get(r.req_id, PUSHDOWN) == PUSHDOWN)
        finish_s = time.perf_counter() - t0
        metrics.counter("stream.requests.pushdown").inc(n_pd)
        metrics.counter("stream.requests.pushback").inc(n_pb)
        metrics.counter("stream.net_bytes.real").inc(pd_b + pb_b)
        if n_hit:
            metrics.counter("stream.cache_hits").inc(n_hit)
        if n_dem:
            metrics.counter("stream.requests.demoted").inc(n_dem)
        metrics.histogram("stream.query_finish_s").observe(finish_s)
        if tr.enabled:
            sim_pb = sum(r.cost.s_in for r in reqs_by_key[key]
                         if decisions.get(r.req_id, PUSHDOWN) == PUSHBACK)
            tr.end(qspan, real_net_bytes=int(pd_b + pb_b),
                   sim_net_bytes=int(sim_pd + sim_pb),
                   n_pushdown=n_pd, n_pushback=n_pb, cache_hits=n_hit,
                   n_demoted=n_dem, retries=n_retry, hedged=n_hedge,
                   s_out_est_ratio=(sim_pd / pd_b if pd_b else None),
                   finish_s=finish_s)
        return {"result": result, "finish_s": finish_s,
                "n_pushdown": n_pd, "n_pushback": n_pb,
                "cache_hits": n_hit,
                "n_demoted": n_dem, "retries": n_retry, "hedged": n_hedge,
                "real_net_bytes": pd_b + pb_b,
                "s_out_estimate_ratio": (sim_pd / pd_b if pd_b else None),
                "sim_finish": sim.finish_by_query.get(key)}

    finishers: Dict[str, Future] = {}
    errors: Dict[str, BaseException] = {}
    per_query: Dict[str, Dict] = {}
    try:
        for key, sq in zip(keys, ordered):
            delay = t0 + sq.arrival * time_scale - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            # detached span: opened here, closed by the finish-pool worker
            qspan = tr.start("query", parent=stream_span,
                             qid=key, mode=cfg.mode, arrival=sq.arrival)
            finishers[key] = finish_pool.submit(
                finish_query, key, sq, submit_query(key, qspan), qspan)
        # drain every finisher before surfacing a failure, so no worker
        # is left on a half-shut pool
        for key, f in finishers.items():
            try:
                per_query[key] = f.result()
            except BaseException as e:  # noqa: BLE001 - drained, re-raised
                errors[key] = e
        wall = time.perf_counter() - t0
    finally:
        # cancel what never started, then join every worker thread
        for p in (*exec_pools.values(), *ship_pools.values(),
                  compute_pool, finish_pool):
            p.shutdown(wait=True, cancel_futures=True)
    if errors:
        key, err = next(iter(errors.items()))
        raise RuntimeError(
            f"stream query {key!r} failed "
            f"({len(errors)}/{len(finishers)} queries errored)") from err
    results = {key: d.pop("result") for key, d in per_query.items()}
    totals = {f: sum(d[f] for d in per_query.values())
              for f in ("n_pushdown", "n_pushback", "n_demoted", "retries",
                        "hedged", "real_net_bytes")}
    if tr.enabled:
        stream_span.set(wall_clock=wall, t_decide=t_decide, **totals)
    return StreamRun(mode=cfg.mode, wall_clock=wall, t_decide=t_decide,
                     per_query=per_query, results=results, sim=sim,
                     **totals)
