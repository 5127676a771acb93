"""Theoretical optimum of adaptive pushdown (§3.1, Eq. 1-7).

Port of ``repro.core.optimum``, host only. Closed form (uniform requests):
with k = T_npd / T_pd,

    n_opt  = k/(k+1) * N                                  (Eq. 6)
    T_opt  = k/(k+1) * T_pd = 1/(k+1) * T_npd             (Eq. 7)

plus the *discrete* optimum over integer admit counts for heterogeneous
request sets: the oracle the paper compares its heuristic against in
Fig. 7, built with a global view of all requests ahead of execution.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN
from repro_torch.core.cost import RequestCost, StorageResources
from repro_torch.core.simulator import simulate

# points of simulated_optimum's first, coarse pass over the admit counts
COARSE_GRID = 16

def n_opt_uniform(N: int, k: float) -> float:
    """Eq. 6 (real-valued; the paper rounds to integers in practice)."""
    return k / (k + 1.0) * N


def t_opt_uniform(t_pd: float, k: float) -> float:
    """Eq. 7."""
    return k / (k + 1.0) * t_pd


def k_of(t_npd: float, t_pd: float) -> float:
    return t_npd / t_pd if t_pd > 0 else 0.0


@dataclasses.dataclass
class Split:
    n_pushdown: int
    time: float
    t_pd_part: float
    t_pb_part: float


def _time_of_split(costs: Sequence[RequestCost], admit: Sequence[bool],
                   res: StorageResources) -> Tuple[float, float, float]:
    """Makespan of an admit/pushback split under the §3.1 fluid model:
    admitted work shares the pushdown slots, pushback work the network
    streams, and the two proceed in parallel (Eq. 1-3)."""
    cpu_work = sum(c.compute_in for c, a in zip(costs, admit) if a)
    pd_net = sum(c.s_out for c, a in zip(costs, admit) if a)
    pb_net = sum(c.s_in for c, a in zip(costs, admit) if not a)
    scan = sum(c.s_in for c in costs)
    t_pd_part = cpu_work / (res.eff_core_bw * res.pd_slots)
    # pushdown results and pushbacks share the storage<->compute pipe
    t_pb_part = (pd_net + pb_net) / res.net_bw
    t_scan = scan / res.disk_bw
    return max(t_pd_part, t_pb_part) + t_scan, t_pd_part, t_pb_part


def discrete_optimum(costs: Sequence[RequestCost], res: StorageResources
                     ) -> Split:
    """Best integer split: admit the n most pushdown-amenable requests
    (sorted by PA, §3.4; an exchange argument reorders any optimal split
    into a PA-prefix split without raising either term)."""
    order = sorted(range(len(costs)), key=lambda i: -costs[i].pa(res))
    best = None
    for n in range(len(costs) + 1):
        admit = [False] * len(costs)
        for i in order[:n]:
            admit[i] = True
        t, tpd, tpb = _time_of_split(costs, admit, res)
        if best is None or t < best.time:
            best = Split(n, t, tpd, tpb)
    return best


def simulated_optimum(sim_reqs, res: StorageResources) -> Split:
    """The oracle under the heuristic's own dynamics: the PA-ordered
    prefix split that minimizes the *simulated* makespan. A coarse grid,
    then a local refinement (the makespan is about unimodal in n)."""
    N = len(sim_reqs)
    order = sorted(range(N), key=lambda i: -sim_reqs[i].cost.pa(res))

    def evaluate(n: int) -> float:
        admit = set(order[:n])
        dec = {r.req_id: PUSHDOWN if i in admit else PUSHBACK
               for i, r in enumerate(sim_reqs)}
        return simulate(sim_reqs, res, decisions=dec).makespan

    grid = sorted({0, N} | {round(i * N / COARSE_GRID)
                            for i in range(COARSE_GRID + 1)})
    times = {n: evaluate(n) for n in grid}
    n0 = min(times, key=times.get)
    lo = max(0, n0 - max(1, N // COARSE_GRID))
    hi = min(N, n0 + max(1, N // COARSE_GRID))
    for n in range(lo, hi + 1):
        if n not in times:
            times[n] = evaluate(n)
    best = min(times, key=times.get)
    return Split(best, times[best], 0.0, 0.0)


def uniform_prediction(costs: Sequence[RequestCost], res: StorageResources
                       ) -> Split:
    """Closed-form Eq. 6-7 applied to the mean request (the paper's
    model)."""
    N = len(costs)
    if N == 0:
        return Split(0, 0.0, 0.0, 0.0)
    mean = RequestCost(
        s_in=sum(c.s_in for c in costs) // N,
        s_out=sum(c.s_out for c in costs) // N,
        compute_in=sum(c.compute_in for c in costs) // N)
    # T_pd and T_npd of the whole pushable portion (Eq. 4) without the
    # scan, which both share
    t_pd = N * mean.compute_in / (res.eff_core_bw * res.pd_slots) \
        + N * mean.s_out / res.net_bw
    t_npd = N * mean.s_in / res.net_bw
    k = k_of(t_npd, t_pd)
    n = round(n_opt_uniform(N, k))
    return Split(n, t_opt_uniform(t_pd, k), 0.0, 0.0)
