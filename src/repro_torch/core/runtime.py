"""Decision-faithful runtime: the Arbitrator's decisions route real work.

Port of the fault-free, in-process path of ``repro.core.runtime``:

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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN
from repro_torch.core.cost import CardinalityCorrector
from repro_torch.core.executor import CompiledPushPlan, compile_push_plan
from repro_torch.core.plan import plan_signature
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


def execute_split(reqs, decisions: Dict[int, str],
                  bitmaps: Optional[Dict[int, torch.Tensor]] = None
                  ) -> SplitExecution:
    """Route every request down its decided path and merge.

    ``reqs`` are ``engine.PlannedRequest``s; ``decisions`` maps
    ``req_id -> PUSHDOWN | PUSHBACK`` (missing ids default to pushdown);
    ``bitmaps`` maps ``req_id`` to the packed words an ``apply_bitmap``
    plan filters its partition with. Requests sharing a (table, plan,
    path) run as one fused batch."""
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
            bms = [bitmaps[r.req_id] for r in sub] if bitmaps else None
            parts, aux = cplan.execute_batch_parts(tabs, bms)
            for r, res, a in zip(sub, parts, aux):
                per_req[r.req_id] = res
                if path == PUSHDOWN:
                    b = result_bytes(res, a)
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
