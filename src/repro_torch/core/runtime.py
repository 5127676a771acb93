"""Decision-faithful runtime: the Arbitrator's decisions route real work.

Port of the in-process path of ``repro.core.runtime`` (``run_stream``
and the process tier are not ported):

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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import faults as _faults
from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN
from repro_torch.core.cost import CardinalityCorrector
from repro_torch.core.executor import (EXECUTOR_BATCHED, EXECUTOR_REFERENCE,
                                       CompiledPushPlan, compile_push_plan)
from repro_torch.core.plan import execute_push_plan, plan_signature
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_metrics
from repro_torch.queryproc.table import ColumnTable


def run_residual(query, merged: Dict[str, ColumnTable]) -> ColumnTable:
    """The query's residual over the merged per-table results: the
    interpreter branch of the reference's ``run_residual``. A compiled
    query's ``compute`` interprets its ``residual`` IR
    (``compiler.interpreter``); a hand-built one runs its own closure."""
    return query.compute(merged)


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
    hedged: bool = False   # ``run_stream``'s hedging (not ported)


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
                cache=None) -> List[Tuple[ColumnTable, Dict]]:
    """Execute one same-(table, plan, path) request group: pushdown over
    the partitions, pushback over raw projections replayed compute-side.
    ``cache`` serves and fills the storage-side pushdown path only."""
    if path == PUSHDOWN:
        tabs = [r.part.data for r in sub]
    else:  # ship the raw projection, replay compute-side
        tabs = [cplan.raw_projection(r.part.data) for r in sub]
    bms = [bitmaps[r.req_id] for r in sub] if bitmaps else None
    if executor == EXECUTOR_REFERENCE:
        return [execute_push_plan(cplan.plan, t,
                                  None if bms is None else bms[i])
                for i, t in enumerate(tabs)]
    use_cache = cache is not None and path == PUSHDOWN
    parts, aux = cplan.execute_batch_parts(
        tabs, bms, cache=cache if use_cache else None,
        parts=[r.part for r in sub] if use_cache else None)
    return list(zip(parts, aux))


def _exec_group_traced(cplan: CompiledPushPlan, sub, path: str,
                       executor: str,
                       bitmaps: Optional[Dict[int, torch.Tensor]] = None,
                       node: Optional[int] = None, cache=None
                       ) -> Tuple[List[Tuple[ColumnTable, Dict]],
                                  obs_trace.Span]:
    """``_exec_group`` under a span, ``storage_execute`` for pushdown and
    ``compute_replay`` for pushback; the closed span comes back so the
    caller can attach the ``shipped_bytes`` it accounts anyway."""
    tr = obs_trace.get_tracer()
    name = "storage_execute" if path == PUSHDOWN else "compute_replay"
    with tr.span(name, table=sub[0].table, n_parts=len(sub),
                 node=node) as sp:
        out = _exec_group(cplan, sub, path, executor, bitmaps=bitmaps,
                          cache=cache)
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
                          executor: str, faults: "_faults.FaultPlan",
                          retry: "_faults.RetryPolicy",
                          breaker: Optional["_faults.CircuitBreaker"] = None,
                          bitmaps: Optional[Dict[int, torch.Tensor]] = None,
                          cache=None
                          ) -> Tuple[List[Tuple[ColumnTable, Dict]],
                                     obs_trace.Span, GroupRecovery]:
    """``_exec_group_traced`` under the fault and recovery contract.

    Each attempt draws from the ``FaultPlan`` at the storage-execute
    boundary, keyed ``"<min req_id>x<n requests>"``. A ``straggler``
    completes late (its delay charged, and slept scaled by
    ``retry.real_scale()``); ``crash``/``timeout``/``transient`` abort the
    attempt, charge the deadline their nominal detection cost and retry
    after capped exponential backoff with deterministic jitter. On
    exhaustion (attempts or charged budget):

    - ``retry.demote_on_exhaust``: a pushdown group is **demoted to
      pushback** (the raw projection shipped and replayed compute-side on
      the same kernels); a pushback group replays from the durable
      projection (``retry.local_replays``). The fallback is not drawn
      from the schedule again: recovery lies outside the fault model.
    - otherwise: raise ``core.faults.FaultExhausted``, the fail-to-error
      baseline.

    Every outcome feeds the breaker (when given) and the
    ``faults.node<N>.<path>.failures``/``.successes`` counters."""
    m = get_metrics()
    tr = obs_trace.get_tracer()
    node_id = sub[0].part.node_id
    table = sub[0].table
    key = f"{min(r.req_id for r in sub)}x{len(sub)}"
    rec = GroupRecovery()
    budget = retry.deadline_s
    scale = retry.real_scale()
    attempt = 1
    while True:
        action = faults.draw(node_id, path, table, key, attempt)
        if action is None or action.kind == _faults.FAULT_STRAGGLER:
            if action is not None:
                m.counter(f"faults.{_faults.FAULT_STRAGGLER}").inc()
                rec.injected.append(_faults.FAULT_STRAGGLER)
                delay = action.param if action.param is not None \
                    else retry.attempt_timeout_s
                if tr.enabled:
                    tr.event("fault_injected",
                             kind=_faults.FAULT_STRAGGLER, node=node_id,
                             table=table, path=path, attempt=attempt,
                             delay_s=delay)
                if delay * scale > 0:
                    time.sleep(delay * scale)
            out, sp = _exec_group_traced(cplan, sub, path, executor,
                                         bitmaps=bitmaps, node=node_id,
                                         cache=cache)
            rec.attempts = attempt
            m.counter(f"faults.node{node_id}.{path}.successes").inc()
            if breaker is not None:
                breaker.record_success(node_id, path)
            return out, sp, rec
        kind = action.kind
        rec.injected.append(kind)
        m.counter(f"faults.{kind}").inc()
        m.counter(f"faults.node{node_id}.{path}.failures").inc()
        if breaker is not None:
            breaker.record_failure(node_id, path)
        if tr.enabled:
            tr.event("fault_injected", kind=kind, node=node_id,
                     table=table, path=path, attempt=attempt)
        charge = retry.charge(kind)
        budget -= charge
        if kind == _faults.FAULT_TIMEOUT and charge * scale > 0:
            time.sleep(charge * scale)  # a timeout waits the attempt out
        if attempt < retry.max_attempts and budget > 0:
            back = retry.backoff_s(attempt, faults.jitter(
                node_id, path, table, key, attempt))
            budget -= back
            if budget > 0:
                rec.retries += 1
                m.counter("retry.attempts").inc()
                if tr.enabled:
                    tr.event("retry", attempt=attempt + 1,
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
        rec.demoted = True
        m.counter("retry.demotions" if path == PUSHDOWN
                  else "retry.local_replays").inc()
        with tr.span("demote", node=node_id, table=table, from_path=path,
                     attempts=attempt, kind=kind):
            out, sp = _exec_group_traced(cplan, sub, PUSHBACK, executor,
                                         bitmaps=bitmaps, node=node_id)
        if breaker is not None and path == PUSHDOWN:
            # the fallback succeeded on the other path
            breaker.record_success(node_id, PUSHBACK)
        return out, sp, rec


def execute_split(reqs, decisions: Dict[int, str],
                  bitmaps: Optional[Dict[int, torch.Tensor]] = None,
                  executor: str = EXECUTOR_BATCHED, cache=None,
                  faults=None, retry=None, breaker=None) -> SplitExecution:
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
    ``faults_injected``."""
    if faults is None:
        faults = _faults.env_plan()
    recovered = faults is not None
    if recovered and retry is None:
        retry = _faults.RetryPolicy()
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
        for rs in groups.values():
            cplan = compile_push_plan(rs[0].plan)
            for path in (PUSHDOWN, PUSHBACK):
                sub = [r for r in rs
                       if decisions.get(r.req_id, PUSHDOWN) == path]
                if not sub:
                    continue
                rec = None
                if not recovered:
                    out, gsp = _exec_group_traced(
                        cplan, sub, path, executor, bitmaps=bitmaps,
                        cache=cache)
                else:
                    out, gsp, rec = _exec_group_recovered(
                        cplan, sub, path, executor, faults, retry,
                        breaker=breaker, bitmaps=bitmaps, cache=cache)
                    retries += rec.retries
                    injected += len(rec.injected)
                demoted = rec is not None and rec.demoted \
                    and path == PUSHDOWN
                eff_path = PUSHBACK if rec is not None and rec.demoted \
                    else path
                g_bytes = 0
                for r, (res, aux) in zip(sub, out):
                    per_req[r.req_id] = res
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
        with tr.span("merge", tables=sorted(by_table)):
            merged = {t: ColumnTable.concat(parts)
                      for t, parts in by_table.items()}
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
