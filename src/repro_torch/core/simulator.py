"""Deterministic fluid discrete-event simulator of the storage layer.

Port of ``repro.core.simulator`` (without the forced-decision oracle,
measured load and tracing); its decisions equal the reference's exactly.
Every task is a sequence of (resource, bytes) stages; resources serve the
active tasks at deterministic rates; events fire when the earliest stage
drains. Per storage node:

- disk: shared scan bandwidth, equal fluid share across active scans
- cpu:  one pushdown execution slot = one core at ``eff_core_bw``
- net:  shared storage<->compute pipe, equal share capped at BW_net

    pushdown: scan(s_in) -> cpu(compute_in) -> net(s_out)  [slot held
              through scan+compute]
    pushback: scan(s_in) -> net(s_in)        [slot held to completion]
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN, Arbitrator
from repro_torch.core.cost import RequestCost, StorageResources

EPS = 1e-12

MODE_NO_PUSHDOWN = "no_pushdown"
MODE_EAGER = "eager"
MODE_ADAPTIVE = "adaptive"
MODE_ADAPTIVE_PA = "adaptive_pa"
MODES = (MODE_NO_PUSHDOWN, MODE_EAGER, MODE_ADAPTIVE, MODE_ADAPTIVE_PA)


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
    stages: List[Tuple[str, float]]   # (resource, remaining bytes)
    slot_until: int = 10 ** 9         # slot frees once idx passes this stage
    idx: int = 0
    start: float = 0.0
    finish: Optional[float] = None
    slot_freed: bool = False

    @property
    def resource(self) -> str:
        return self.stages[self.idx][0]


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
    return TaskState(req, path, stages, slot_until, 0, now)


def simulate(requests: List[SimRequest], res: StorageResources,
             mode: str = MODE_ADAPTIVE) -> SimResult:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    nodes = sorted({r.node_id for r in requests})
    forced = {MODE_NO_PUSHDOWN: PUSHBACK, MODE_EAGER: PUSHDOWN}.get(mode)
    arbs = {n: Arbitrator(res, pa_aware=(mode == MODE_ADAPTIVE_PA),
                          forced_path=forced) for n in nodes}
    by_id = {r.req_id: r for r in requests}
    pending = sorted(requests, key=lambda r: (r.arrival, r.req_id))
    active: List[TaskState] = []
    done: Dict[int, TaskState] = {}
    cpu_busy = {n: 0.0 for n in nodes}
    now = 0.0
    i = 0

    def start_assignments(assigns, t):
        for req_id, path in assigns:
            active.append(_mk_task(by_id[req_id], path, t))

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

        # fluid rates for the current instant
        disk_n = {n: 0 for n in nodes}
        net_n = {n: 0 for n in nodes}
        for t in active:
            if t.resource == "disk":
                disk_n[t.req.node_id] += 1
            elif t.resource == "net":
                net_n[t.req.node_id] += 1

        def rate(t: TaskState) -> float:
            n = t.req.node_id
            if t.resource == "disk":
                return res.disk_bw / max(1, disk_n[n])
            if t.resource == "cpu":
                return res.eff_core_bw
            return min(res.stream_bw, res.net_bw / max(1, net_n[n]))

        # next event: earliest stage completion or next arrival
        dt = math.inf
        for t in active:
            rem = t.stages[t.idx][1]
            dt = min(dt, rem / rate(t) if rem > 0 else 0.0)
        if i < len(pending):
            dt = min(dt, pending[i].arrival - now)
        dt = max(dt, 0.0)

        for t in active:
            r = rate(t)
            res_name, rem = t.stages[t.idx]
            t.stages[t.idx] = (res_name, rem - r * dt)
            if res_name == "cpu":
                cpu_busy[t.req.node_id] += dt
        now += dt

        still: List[TaskState] = []
        freed: List[Tuple[int, str]] = []
        for t in active:
            while t.idx < len(t.stages) and t.stages[t.idx][1] <= EPS * max(
                    1.0, t.req.cost.s_in):
                t.idx += 1
            if not t.slot_freed and t.idx > t.slot_until:
                t.slot_freed = True
                freed.append((t.req.node_id, t.path))
            if t.idx >= len(t.stages):
                t.finish = now
                done[t.req.req_id] = t
                if not t.slot_freed:
                    t.slot_freed = True
                    freed.append((t.req.node_id, t.path))
            else:
                still.append(t)
        active = still
        for n, path in freed:
            start_assignments(arbs[n].release(path), now)

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
                     cpu_busy, max(fin_q.values()) if fin_q else 0.0)
