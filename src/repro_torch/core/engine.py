"""End-to-end query engine over the device-resident storage layer.

Port of ``repro.core.engine`` (``run_query`` and what it needs). For one
query the engine:

1. plans one request per partition of every scanned table and costs it
   from the partition's column stats,
2. runs the Arbitrator + fluid simulator for the pushdown/pushback
   decision vector,
3. executes that split on the device (``core.runtime``),
4. runs the query's residual over the merged tables.

Modes: no_pushdown / eager / adaptive / adaptive_pa (§6.2 baselines).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import runtime
from repro_torch.core.cost import RequestCost, StorageResources
from repro_torch.core.executor import compile_push_plan
from repro_torch.core.plan import PushPlan
from repro_torch.core.simulator import (MODE_ADAPTIVE, MODES, SimRequest,
                                        SimResult, simulate)
from repro_torch.device import resolve_device
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import Catalog, Partition

__all__ = ["MODES", "EngineConfig", "PlannedRequest", "QueryRun",
           "plan_requests", "run_query", "results_equal"]


@dataclasses.dataclass
class EngineConfig:
    res: StorageResources = StorageResources()
    mode: str = MODE_ADAPTIVE
    compute_bw: float = 2.4e9   # compute-node operator bandwidth (16 vCPU)
    num_compute_nodes: int = 1
    device: Optional[str] = None  # None = cuda; "cpu" = plain versions


@dataclasses.dataclass
class PlannedRequest:
    req_id: int
    query_id: str
    table: str
    part: Partition
    plan: PushPlan
    cost: RequestCost


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

    @property
    def t_total(self) -> float:
        return self.t_pushable + self.t_nonpushable


def plan_requests(query, catalog: Catalog, start_id: int = 0
                  ) -> List[PlannedRequest]:
    out: List[PlannedRequest] = []
    rid = start_id
    for table, plan in query.plans.items():
        cplan = compile_push_plan(plan)
        for part in catalog.partitions_of(table):
            out.append(PlannedRequest(rid, query.qid, table, part, plan,
                                      cplan.estimate_cost(part)))
            rid += 1
    return out


def nonpushable_time(merged: Dict[str, ColumnTable], cfg: EngineConfig
                     ) -> float:
    """Joins/final aggregation at the compute layer: input bytes over the
    compute-node operator bandwidth."""
    b = sum(t.nbytes(stored=False) for t in merged.values())
    return b / (cfg.compute_bw * cfg.num_compute_nodes)


def run_query(query, catalog: Catalog, cfg: EngineConfig) -> QueryRun:
    """Plan, arbitrate, execute and finish one query on ``cfg.device``
    (the GPU unless it says ``"cpu"``), which must hold the catalog."""
    dev = resolve_device(cfg.device)
    if catalog.device != dev:
        raise ValueError(f"catalog lives on {catalog.device}, the engine is "
                         f"configured for {dev}")
    reqs = plan_requests(query, catalog)
    sim = simulate([SimRequest(r.req_id, r.part.node_id, query.qid, r.cost)
                    for r in reqs], cfg.res, cfg.mode)
    split = runtime.execute_split(reqs, sim.decisions())
    if split.n_pushdown != sim.admitted(query.qid):
        raise RuntimeError(f"{query.qid}: executed {split.n_pushdown} "
                           f"pushdowns, arbitrated {sim.admitted(query.qid)}")
    result = runtime.run_residual(query, split.merged)
    return QueryRun(
        qid=query.qid, result=result, sim=sim, t_pushable=sim.makespan,
        t_nonpushable=nonpushable_time(split.merged, cfg), requests=reqs,
        net_bytes=sim.net_bytes, n_admitted=sim.admitted(query.qid),
        n_pushed_back=sim.pushed_back_by_query.get(query.qid, 0),
        real_net_bytes=split.real_net_bytes,
        net_bytes_recon=runtime.reconcile_net_bytes(sim, reqs, split),
        outcomes=split.outcomes)


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
