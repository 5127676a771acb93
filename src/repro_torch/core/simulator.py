"""Deterministic fluid discrete-event simulator of the storage layer.

Port of ``repro.core.simulator``; its decisions equal the reference's
exactly, a shared circuit breaker's routing and measured load included.
``decisions`` fixes every request's path up front: the §3.1 oracle that
``core.optimum`` evaluates. ``on_decision`` hears every assignment as it
is made (``run_stream`` orders real work by it), and the whole run is
one ``arbitrate`` span.
Every task is a sequence of (resource, bytes) stages; resources serve the
active tasks at deterministic rates; events fire when the earliest stage
drains. The active set is a few arrays in the order the Arbitrators
assigned the tasks, so that an event is a few vector passes (numpy, on
the host) and only the tasks whose stage drained are handled one by one;
the order is kept because their freed slots are released in it, and a
release can start tasks. The floats are the reference's per-task loop's,
bit for bit. Per storage node:

- disk: shared scan bandwidth, equal fluid share across active scans
- cpu:  one pushdown execution slot = one core at ``eff_core_bw``
- net:  shared storage<->compute pipe, equal share capped at BW_net

    pushdown: scan(s_in) -> cpu(compute_in) -> net(s_out)  [slot held
              through scan+compute]
    pushback: scan(s_in) -> net(s_in)        [slot held to completion]
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN, Arbitrator
from repro_torch.core.cost import RequestCost, StorageResources
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_metrics

EPS = 1e-12

MODE_NO_PUSHDOWN = "no_pushdown"
MODE_EAGER = "eager"
MODE_ADAPTIVE = "adaptive"
MODE_ADAPTIVE_PA = "adaptive_pa"
MODES = (MODE_NO_PUSHDOWN, MODE_EAGER, MODE_ADAPTIVE, MODE_ADAPTIVE_PA)
_RESOURCE = {"disk": 0, "cpu": 1, "net": 2}   # a row's rate-table block


@dataclasses.dataclass
class SimRequest:
    req_id: int
    node_id: int
    query_id: str
    cost: RequestCost
    arrival: float = 0.0


@dataclasses.dataclass
class TaskState:
    req: SimRequest
    path: str
    # (resource, bytes) of the cost; the current stage's remaining bytes
    # are in the event loop's arrays
    stages: List[Tuple[str, float]]
    slot_until: int = 10 ** 9         # slot frees once idx passes this stage
    idx: int = 0
    start: float = 0.0
    finish: Optional[float] = None
    slot_freed: bool = False
    thr: float = 0.0                  # a stage at or below this retires


@dataclasses.dataclass
class SimResult:
    per_request: Dict[int, Tuple[str, float, float]]  # id -> (path, start, finish)
    finish_by_query: Dict[str, float]
    admitted_by_query: Dict[str, int]
    pushed_back_by_query: Dict[str, int]
    net_bytes: float                 # storage->compute traffic
    net_bytes_by_query: Dict[str, float]
    cpu_busy_by_node: Dict[int, float]
    makespan: float

    def admitted(self, qid: Optional[str] = None) -> int:
        if qid is None:
            return sum(self.admitted_by_query.values())
        return self.admitted_by_query.get(qid, 0)

    def decisions(self) -> Dict[int, str]:
        """The per-request path decisions the runtime routes real work by."""
        return {rid: path for rid, (path, _s, _f) in self.per_request.items()}


def _mk_task(req: SimRequest, path: str, now: float) -> TaskState:
    c = req.cost
    if path == PUSHDOWN:
        stages = [("disk", float(c.s_in)), ("cpu", float(c.compute_in)),
                  ("net", float(c.s_out))]
        slot_until = 1
    else:
        stages = [("disk", float(c.s_in)), ("net", float(c.s_in))]
        slot_until = 10 ** 9
    return TaskState(req, path, stages, slot_until, 0, now,
                     thr=EPS * max(1.0, c.s_in))


class _ForcedArbitrator:
    """Oracle mode: every request's path fixed up front (a global view,
    §3.1); one FIFO queue per path, so a full path never blocks the
    other."""

    def __init__(self, res: StorageResources, decisions: Dict[int, str],
                 on_decide: Optional[Callable[[int, str], None]] = None):
        self.decisions = decisions
        self.on_decide = on_decide
        self.q: Dict[str, List[int]] = {PUSHDOWN: [], PUSHBACK: []}
        self.free = {PUSHDOWN: res.pd_slots, PUSHBACK: res.pb_slots}

    def submit(self, req_id: int, cost: RequestCost) -> List[Tuple[int, str]]:
        self.q[self.decisions[req_id]].append(req_id)
        return self.drain()

    def release(self, path: str) -> List[Tuple[int, str]]:
        self.free[path] += 1
        return self.drain()

    def drain(self) -> List[Tuple[int, str]]:
        out = []
        for path in (PUSHDOWN, PUSHBACK):
            while self.q[path] and self.free[path] > 0:
                self.free[path] -= 1
                out.append((self.q[path].pop(0), path))
        if out:
            tr = obs_trace.get_tracer()
            if tr.enabled:
                tr.decisions.record_batch(
                    out, kind="arbitrate",
                    queue_depth=len(self.q[PUSHDOWN]) + len(self.q[PUSHBACK]),
                    free_pd=self.free[PUSHDOWN], free_pb=self.free[PUSHBACK],
                    pa_aware=False, forced="oracle")
        if self.on_decide is not None:
            for rid, path in out:
                self.on_decide(rid, path)
        return out


def simulate(requests: List[SimRequest], res: StorageResources,
             mode: str = MODE_ADAPTIVE,
             decisions: Optional[Dict[int, str]] = None,
             on_decision: Optional[Callable[[int, str], None]] = None,
             measured=None, breaker=None) -> SimResult:
    """Run the requests through every node's Arbitrator in ``mode``, or
    down the paths ``decisions`` fixes (req_id -> path) when given.
    ``on_decision(req_id, path)`` hears every assignment as it is made.
    ``measured`` (an ``arbitrator.MeasuredLoad``) makes every node's
    backlog guard read the measured ``stream.*`` queue depths;
    ``breaker`` (a ``core.faults.CircuitBreaker``) is shared by every
    node's Arbitrator. Each call adds its event loop's work to the
    registry, traced or not: ``sim.events``, the iterations that advance
    time, ``sim.rerates``, the active tasks re-rated over them, and
    ``sim.advances``, the drained stages handled one task at a time."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    tr = obs_trace.get_tracer()
    with tr.span("arbitrate", mode=mode, n_requests=len(requests)) as sp:
        result = _simulate(requests, res, mode, decisions, on_decision,
                           measured, breaker)
        if tr.enabled:
            # per_request is attached by reference (complete once
            # _simulate returns); the exporters coerce it
            sp.set(makespan=result.makespan,
                   sim_net_bytes=float(result.net_bytes),
                   n_pushdown=result.admitted(),
                   n_pushback=sum(result.pushed_back_by_query.values()),
                   decisions=result.per_request)
    return result


def _simulate(requests: List[SimRequest], res: StorageResources, mode: str,
              decisions: Optional[Dict[int, str]],
              on_decision: Optional[Callable[[int, str], None]],
              measured, breaker) -> SimResult:
    """The event loop, with the active set held as arrays: one row a
    task, in active order (the order the Arbitrators assigned them in),
    with its resource and node as one code into the rate table (kept
    current with the per-code task counts), its current stage's remaining
    bytes and its retire threshold. An event is a few vector passes:
    gather the rates, take the next drain, advance every stage. Only the
    tasks whose stage drained go through Python, in active order, as the
    per-task loop took them: their freed slots are released in that
    order, and each release can start tasks. So a started task's row is
    appended and a finished one's cut out with the rows behind it moved
    up. Every float is the per-task loop's: the same IEEE operations on
    the same values in the same order."""
    nodes = sorted({r.node_id for r in requests})
    forced = {MODE_NO_PUSHDOWN: PUSHBACK, MODE_EAGER: PUSHDOWN}.get(mode)
    if decisions is not None:
        arbs = {n: _ForcedArbitrator(res, decisions, on_decide=on_decision)
                for n in nodes}
    else:
        arbs = {n: Arbitrator(res, pa_aware=(mode == MODE_ADAPTIVE_PA),
                              forced_path=forced, on_decide=on_decision,
                              measured=measured, node_id=n, breaker=breaker)
                for n in nodes}
    by_id = {r.req_id: r for r in requests}
    pending = sorted(requests, key=lambda r: (r.arrival, r.req_id))
    n_nodes = len(nodes)
    pos = {n: k for k, n in enumerate(nodes)}
    disk_bw, net_bw = res.disk_bw, res.net_bw
    stream_bw = res.stream_bw
    # row j of the arrays is active[j]; a code is resource * n_nodes + node
    active: List[TaskState] = []
    code = np.empty(len(requests), dtype=np.intp)
    rem = np.empty(len(requests))
    thr = np.empty(len(requests))
    count = [0] * (3 * n_nodes)           # active tasks per code
    rates = np.full(3 * n_nodes, res.eff_core_bw)   # a task's rate per code

    def recount(c: int, step: int) -> None:
        """Move code ``c``'s count by ``step``, and its fluid rate with it."""
        k = count[c] = count[c] + step
        if c < n_nodes:
            rates[c] = disk_bw / max(1, k)
        elif c >= 2 * n_nodes:
            rates[c] = min(stream_bw, net_bw / max(1, k))

    for c in range(3 * n_nodes):
        recount(c, 0)
    done: Dict[int, TaskState] = {}
    cpu_busy = [0.0] * n_nodes
    now = 0.0
    i = 0
    n_events = n_rerates = n_advances = 0

    def start_assignments(assigns, t):
        for req_id, path in assigns:
            req = by_id[req_id]
            task = _mk_task(req, path, t)
            j = len(active)
            active.append(task)
            c = pos[req.node_id]          # every task starts on the disk
            code[j] = c
            rem[j] = task.stages[0][1]
            thr[j] = task.thr
            recount(c, 1)

    while i < len(pending) or active:
        while i < len(pending) and pending[i].arrival <= now + EPS:
            r = pending[i]
            start_assignments(arbs[r.node_id].submit(r.req_id, r.cost), now)
            i += 1
        if not active:
            if i < len(pending):
                now = pending[i].arrival
                continue
            break
        n = len(active)
        n_events += 1
        n_rerates += n

        # fluid rates for the current instant
        rate = rates[code[:n]]
        left = rem[:n]                    # a view: advancing it advances rem

        # next event: earliest stage completion or next arrival
        dt = float(np.where(left > 0, left / rate, 0.0).min())
        if i < len(pending):
            dt = min(dt, pending[i].arrival - now)
        dt = max(dt, 0.0)

        left -= rate * dt
        # one add a cpu-stage task, as the per-task loop made them: k adds
        # of dt can round otherwise than one add of k * dt
        for k in range(n_nodes):
            busy = cpu_busy[k]
            for _ in range(count[n_nodes + k]):
                busy += dt
            cpu_busy[k] = busy
        now += dt

        drained = (left <= thr[:n]).nonzero()[0].tolist()
        if not drained:
            continue
        n_advances += len(drained)
        freed: List[Tuple[int, str]] = []
        gone: List[int] = []
        for j in drained:
            t = active[j]
            recount(int(code[j]), -1)
            stages = t.stages
            t.idx += 1
            while t.idx < len(stages) and stages[t.idx][1] <= t.thr:
                t.idx += 1
            if not t.slot_freed and t.idx > t.slot_until:
                t.slot_freed = True
                freed.append((t.req.node_id, t.path))
            if t.idx >= len(stages):
                t.finish = now
                done[t.req.req_id] = t
                gone.append(j)
                if not t.slot_freed:
                    t.slot_freed = True
                    freed.append((t.req.node_id, t.path))
            else:
                res_name, left_bytes = stages[t.idx]
                c = _RESOURCE[res_name] * n_nodes + pos[t.req.node_id]
                code[j] = c
                rem[j] = left_bytes
                recount(c, 1)
        for j in reversed(gone):          # close each gap, keeping order
            code[j:n - 1] = code[j + 1:n]
            rem[j:n - 1] = rem[j + 1:n]
            thr[j:n - 1] = thr[j + 1:n]
            del active[j]
            n -= 1
        for node, path in freed:
            start_assignments(arbs[node].release(path), now)

    m = get_metrics()
    m.counter("sim.events").inc(n_events)
    m.counter("sim.rerates").inc(n_rerates)
    m.counter("sim.advances").inc(n_advances)
    per_request = {rid: (t.path, t.start, t.finish) for rid, t in done.items()}
    fin_q: Dict[str, float] = {}
    adm_q: Dict[str, int] = {}
    pb_q: Dict[str, int] = {}
    net_q: Dict[str, float] = {}
    net_total = 0.0
    for t in done.values():
        q = t.req.query_id
        fin_q[q] = max(fin_q.get(q, 0.0), t.finish)
        b = t.req.cost.s_out if t.path == PUSHDOWN else t.req.cost.s_in
        net_total += b
        net_q[q] = net_q.get(q, 0.0) + b
        if t.path == PUSHDOWN:
            adm_q[q] = adm_q.get(q, 0) + 1
        else:
            pb_q[q] = pb_q.get(q, 0) + 1
    return SimResult(per_request, fin_q, adm_q, pb_q, net_total, net_q,
                     dict(zip(nodes, cpu_busy)),
                     max(fin_q.values()) if fin_q else 0.0)
