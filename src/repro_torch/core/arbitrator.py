"""Adaptive Pushdown Arbitrator — the paper's Algorithm 1 (+ §3.4 PA-aware).

Port of ``repro.core.arbitrator`` without the circuit breaker, the
measured-load port and tracing. Runs at each storage node: a wait queue
and two finite slot pools (pushdown execution / pushback transfer).

FIFO mode (Algorithm 1): head-of-queue only; the faster path by the cost
model is tried first, then the slower one while the faster pool's backlog
would take at least as long (the backlog guard); if neither fits,
arbitration stops. PA-aware mode (§3.4): the queue is sorted by
PA = t_pb - t_pd; pushdown slots take from the high-PA end, pushback
slots from the low-PA end.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.cost import RequestCost, StorageResources

PUSHDOWN, PUSHBACK = "pushdown", "pushback"


@dataclasses.dataclass
class Pending:
    req_id: int
    cost: RequestCost
    pa: float


class Arbitrator:
    def __init__(self, res: StorageResources, pa_aware: bool = False,
                 forced_path: Optional[str] = None):
        self.res = res
        self.pa_aware = pa_aware
        self.forced_path = forced_path  # the baselines force one path
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

    def drain(self) -> List[Tuple[int, str]]:
        """Assign queued requests to slots; returns [(req_id, path), ...]."""
        out: List[Tuple[int, str]] = []
        if self.forced_path is not None:
            while self.queue and self._try(self.forced_path):
                out.append((self.queue.pop(0).req_id, self.forced_path))
            return out
        if self.pa_aware:
            return self._drain_pa(out)
        while self.queue:
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
        return out

    def _spill_ok(self, t_pd: float, t_pb: float, fast: str) -> bool:
        slots = self.res.pd_slots if fast == PUSHDOWN else self.res.pb_slots
        t_fast, t_slow = (t_pd, t_pb) if fast == PUSHDOWN else (t_pb, t_pd)
        backlog = len(self.queue) / max(1, slots) * t_fast
        return t_slow <= backlog

    def _drain_pa(self, out: List[Tuple[int, str]]) -> List[Tuple[int, str]]:
        """§3.4: pushdown takes the highest-PA request, pushback the lowest."""
        while self.queue:
            head_hi = self.queue[0]
            if self.free_pd > 0 and (head_hi.pa >= 0 or self.free_pb == 0):
                self._try(PUSHDOWN)
                out.append((self.queue.pop(0).req_id, PUSHDOWN))
            elif self.free_pb > 0:
                self._try(PUSHBACK)
                out.append((self.queue.pop().req_id, PUSHBACK))
            elif self.free_pd > 0:
                self._try(PUSHDOWN)
                out.append((self.queue.pop(0).req_id, PUSHDOWN))
            else:
                break
        return out
