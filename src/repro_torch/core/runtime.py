"""Decision-faithful runtime: the Arbitrator's decisions route real work.

Port of the fault-free, in-process path of ``repro.core.runtime``:

- pushdown requests run storage-side through the batched executor and
  ship only their results;
- pushback requests ship the raw accessed-column projection (a device
  copy) and the compute side replays the same compiled plan over it,
  through the same kernels.

Per-partition results merge in original request order, so the merged
tables are the same for any decision vector. Real bytes ride along:
pushdown requests are charged their result bytes, pushback requests the
stored bytes of their accessed columns (the simulator's ``s_in``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN
from repro_torch.core.executor import CompiledPushPlan, compile_push_plan
from repro_torch.queryproc.table import ColumnTable


def run_residual(query, merged: Dict[str, ColumnTable]) -> ColumnTable:
    """The query's ``compute`` residual over the merged per-table results
    (the interpreter branch of the reference's ``run_residual``)."""
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


@dataclasses.dataclass
class SplitExecution:
    """Merged tables + real-traffic accounting of one decision vector."""
    merged: Dict[str, ColumnTable]
    outcomes: List[RequestOutcome]   # original request order
    n_pushdown: int
    n_pushback: int
    pushdown_bytes: int
    pushback_bytes: int

    @property
    def real_net_bytes(self) -> int:
        return self.pushdown_bytes + self.pushback_bytes


def result_bytes(result: ColumnTable) -> int:
    """Bytes a pushdown result ships (64-byte floor for an empty one)."""
    return result.nbytes(stored=False) if len(result) else 64


def pushback_bytes(cplan: CompiledPushPlan, data: ColumnTable) -> int:
    """Stored bytes of the raw accessed-column projection (exactly ``s_in``)."""
    return int(data.nbytes([c for c in cplan.accessed if c in data.cols],
                           stored=True))


def execute_split(reqs, decisions: Dict[int, str]) -> SplitExecution:
    """Route every request down its decided path and merge.

    ``reqs`` are ``engine.PlannedRequest``s; ``decisions`` maps
    ``req_id -> PUSHDOWN | PUSHBACK`` (missing ids default to pushdown).
    Requests sharing a (table, plan, path) run as one fused batch."""
    per_req: Dict[int, ColumnTable] = {}
    out_by_id: Dict[int, RequestOutcome] = {}
    n_pd = n_pb = pd_bytes = pb_bytes = 0
    groups: Dict[Tuple, List] = {}
    for r in reqs:
        groups.setdefault((r.table, id(r.plan)), []).append(r)
    for rs in groups.values():
        cplan = compile_push_plan(rs[0].plan)
        for path in (PUSHDOWN, PUSHBACK):
            sub = [r for r in rs
                   if decisions.get(r.req_id, PUSHDOWN) == path]
            if not sub:
                continue
            if path == PUSHDOWN:
                tabs = [r.part.data for r in sub]
            else:  # ship the raw projection, replay compute-side
                tabs = [cplan.raw_projection(r.part.data) for r in sub]
            for r, res in zip(sub, cplan.execute_batch_parts(tabs)):
                per_req[r.req_id] = res
                if path == PUSHDOWN:
                    b = result_bytes(res)
                    pd_bytes += b
                    n_pd += 1
                else:
                    b = pushback_bytes(cplan, r.part.data)
                    pb_bytes += b
                    n_pb += 1
                out_by_id[r.req_id] = RequestOutcome(
                    r.req_id, r.table, path, len(res), b,
                    replayed=(path == PUSHBACK))
    by_table: Dict[str, List[ColumnTable]] = {}
    for r in reqs:
        by_table.setdefault(r.table, []).append(per_req[r.req_id])
    merged = {t: ColumnTable.concat(parts) for t, parts in by_table.items()}
    outs = [out_by_id[r.req_id] for r in reqs]
    return SplitExecution(merged, outs, n_pd, n_pb, pd_bytes, pb_bytes)


def reconcile_net_bytes(sim, reqs, split: SplitExecution) -> Dict:
    """Line real shipped bytes up against the simulator's ``net_bytes``:
    the pushback component matches exactly, the pushdown one differs by
    the cost model's ``s_out`` estimation error."""
    decisions = sim.decisions()
    sim_pd = sum(r.cost.s_out for r in reqs
                 if decisions.get(r.req_id, PUSHDOWN) == PUSHDOWN)
    sim_pb = sum(r.cost.s_in for r in reqs
                 if decisions.get(r.req_id, PUSHDOWN) == PUSHBACK)
    return {
        "sim_net_bytes": sim_pd + sim_pb,
        "real_net_bytes": split.real_net_bytes,
        "sim_pushdown_bytes": sim_pd,
        "real_pushdown_bytes": split.pushdown_bytes,
        "sim_pushback_bytes": sim_pb,
        "real_pushback_bytes": split.pushback_bytes,
        "s_out_estimate_ratio": (sim_pd / split.pushdown_bytes
                                 if split.pushdown_bytes else None),
    }
