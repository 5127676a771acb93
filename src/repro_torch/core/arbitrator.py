"""Adaptive Pushdown Arbitrator — the paper's Algorithm 1 (+ §3.4 PA-aware).

Port of ``repro.core.arbitrator``. Runs at each storage node: a wait
queue and two finite slot pools (pushdown execution / pushback
transfer).

FIFO mode (Algorithm 1): head-of-queue only; the faster path by the cost
model is tried first, then the slower one while the faster pool's backlog
would take at least as long (the backlog guard); if neither fits,
arbitration stops. With a ``MeasuredLoad``, the backlog guard reads the
queue depth ``run_stream`` measured instead of the fluid wait queue, and
falls back to the fluid queue where no depth was published. PA-aware
mode (§3.4): the queue is sorted by PA = t_pb - t_pd; pushdown slots
take from the high-PA end, pushback slots from the low-PA end.

A shared ``core.faults.CircuitBreaker``, fed by the runtime's
storage-execute outcomes, makes new decisions on a node whose pushdown
circuit is open go to pushback (recovery routing beats the cost ordering
and the backlog guard); a half-open probe is admitted down pushdown so a
recovered node can close it. The forced baselines ignore it.

Every batch of assignments goes to ``on_decide`` (request by request:
``run_stream`` orders real work by it) and, when tracing, to the
tracer's decision channel with the queue depth and free slots the batch
was decided under.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cost import RequestCost, StorageResources
from repro_torch.core.faults import ROUTE_DENY
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import Metrics, get_metrics

PUSHDOWN, PUSHBACK = "pushdown", "pushback"

# called once per request the moment the Arbitrator assigns it a path
DecisionHook = Callable[[int, str], None]


class MeasuredLoad:
    """Measured load for the backlog guard (``EngineConfig.
    measured_feedback``, on by default).

    In place of the fluid model's own wait queue, the Arbitrator gauges
    backlog from the occupancy ``runtime.run_stream`` publishes every
    dispatch wave: the ``stream.node{n}.exec_queue`` /
    ``stream.node{n}.ship_queue`` gauges. One
    instance serves every node's Arbitrator in a ``simulate()`` call; each
    ``drain()`` refreshes the snapshot through ``metrics.epoch()``, which
    advances the registry's shared epoch marker. Where a node's gauges
    were never published, ``queue_depth`` returns None and the Arbitrator
    falls back to its fluid queue."""

    def __init__(self, metrics: Optional[Metrics] = None):
        self._m = metrics
        self._gauges: Dict[str, float] = {}

    def refresh(self) -> None:
        m = self._m if self._m is not None else get_metrics()
        self._gauges = dict(m.epoch().get("gauges", {}))

    def queue_depth(self, node_id: int, path: str) -> Optional[float]:
        kind = "exec" if path == PUSHDOWN else "ship"
        return self._gauges.get(f"stream.node{node_id}.{kind}_queue")


@dataclasses.dataclass
class Pending:
    req_id: int
    cost: RequestCost
    pa: float


class Arbitrator:
    def __init__(self, res: StorageResources, pa_aware: bool = False,
                 forced_path: Optional[str] = None,
                 on_decide: Optional[DecisionHook] = None,
                 measured: Optional[MeasuredLoad] = None,
                 node_id: int = 0, breaker=None):
        self.res = res
        self.pa_aware = pa_aware
        self.forced_path = forced_path  # the baselines force one path
        self.on_decide = on_decide      # live callback: (req_id, path)
        self.measured = measured        # the measured backlog source
        self.node_id = node_id
        self.breaker = breaker          # core.faults.CircuitBreaker
        self.queue: List[Pending] = []
        self.free_pd = res.pd_slots
        self.free_pb = res.pb_slots
        self.admitted = 0
        self.pushed_back = 0

    def submit(self, req_id: int, cost: RequestCost) -> List[Tuple[int, str]]:
        p = Pending(req_id, cost, cost.pa(self.res))
        if self.pa_aware:
            # keep the queue sorted descending by PA
            lo, hi = 0, len(self.queue)
            while lo < hi:
                mid = (lo + hi) // 2
                if self.queue[mid].pa >= p.pa:
                    lo = mid + 1
                else:
                    hi = mid
            self.queue.insert(lo, p)
        else:
            self.queue.append(p)
        return self.drain()

    def release(self, path: str) -> List[Tuple[int, str]]:
        if path == PUSHDOWN:
            self.free_pd = min(self.res.pd_slots, self.free_pd + 1)
        else:
            self.free_pb = min(self.res.pb_slots, self.free_pb + 1)
        return self.drain()

    def _pd_tripped(self) -> bool:
        """Consult the breaker for one new pushdown admission. Called only
        with a pushdown slot free: each call is one routing decision, so
        denials (not the clock) advance the breaker to its probe."""
        return (self.breaker is not None
                and self.breaker.route(self.node_id, PUSHDOWN) == ROUTE_DENY)

    def _try(self, path: str) -> bool:
        if path == PUSHDOWN and self.free_pd > 0:
            self.free_pd -= 1
            self.admitted += 1
            return True
        if path == PUSHBACK and self.free_pb > 0:
            self.free_pb -= 1
            self.pushed_back += 1
            return True
        return False

    def _emit(self, assigned: List[Tuple[int, str]]) -> List[Tuple[int, str]]:
        if assigned:
            tr = obs_trace.get_tracer()
            if tr.enabled:
                # the load the batch was decided under: one channel entry
                tr.decisions.record_batch(
                    assigned, kind="arbitrate",
                    queue_depth=len(self.queue),
                    free_pd=self.free_pd, free_pb=self.free_pb,
                    pa_aware=self.pa_aware, forced=self.forced_path)
        if self.on_decide is not None:
            for rid, path in assigned:
                self.on_decide(rid, path)
        return assigned

    def drain(self) -> List[Tuple[int, str]]:
        """Assign queued requests to slots; returns [(req_id, path), ...]."""
        out: List[Tuple[int, str]] = []
        if self.measured is not None:
            self.measured.refresh()  # one snapshot per drain
        if self.forced_path is not None:
            while self.queue and self._try(self.forced_path):
                out.append((self.queue.pop(0).req_id, self.forced_path))
            return self._emit(out)
        if self.pa_aware:
            return self._emit(self._drain_pa(out))
        while self.queue:
            if self.free_pd > 0 and self._pd_tripped():
                # an open circuit sends this decision to pushback
                if self._try(PUSHBACK):
                    out.append((self.queue.pop(0).req_id, PUSHBACK))
                    continue
                break  # the transfer pool is full too: wait for a release
            p = self.queue[0]
            t_pd = p.cost.t_pd(self.res, include_scan=False)
            t_pb = p.cost.t_pb(self.res, include_scan=False)
            first, second = ((PUSHDOWN, PUSHBACK) if t_pd < t_pb
                             else (PUSHBACK, PUSHDOWN))
            if self._try(first):
                out.append((self.queue.pop(0).req_id, first))
            elif self._spill_ok(t_pd, t_pb, first) and self._try(second):
                out.append((self.queue.pop(0).req_id, second))
            else:
                break  # both pools saturated (Algorithm 1 line 14)
        return self._emit(out)

    def _spill_ok(self, t_pd: float, t_pb: float, fast: str) -> bool:
        slots = self.res.pd_slots if fast == PUSHDOWN else self.res.pb_slots
        t_fast, t_slow = (t_pd, t_pb) if fast == PUSHDOWN else (t_pb, t_pd)
        depth = (self.measured.queue_depth(self.node_id, fast)
                 if self.measured is not None else None)
        if depth is None:
            depth = len(self.queue)  # the fluid fallback
        backlog = depth / max(1, slots) * t_fast
        return t_slow <= backlog

    def _drain_pa(self, out: List[Tuple[int, str]]) -> List[Tuple[int, str]]:
        """§3.4: pushdown takes the highest-PA request, pushback the lowest."""
        while self.queue:
            # a tripped pushdown circuit takes the execution pool out of
            # this round (a granted probe re-enables it)
            pd_free = self.free_pd > 0 and not self._pd_tripped()
            head_hi = self.queue[0]
            if pd_free and (head_hi.pa >= 0 or self.free_pb == 0):
                self._try(PUSHDOWN)
                out.append((self.queue.pop(0).req_id, PUSHDOWN))
            elif self.free_pb > 0:
                self._try(PUSHBACK)
                out.append((self.queue.pop().req_id, PUSHBACK))
            elif pd_free:
                self._try(PUSHDOWN)
                out.append((self.queue.pop(0).req_id, PUSHDOWN))
            else:
                break
        return out
