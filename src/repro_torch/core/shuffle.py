"""Distributed-data-shuffle pushdown (paper §4.2, Fig 5 / Fig 15) on the
device.

Port of ``repro.core.shuffle`` (the batched executor branch). Baseline
(shuffle at compute): storage runs filter/project pushdown, results land
round-robin on the n compute nodes, which then hash-redistribute on the
join key, so (n-1)/n of the bytes cross the compute interconnect.

Shuffle pushdown: the storage node runs the partition function itself
(the executor's ``shuffle`` aux: ``fused_scan_shuffle`` or
``hash_partition`` on the card) and routes each partition's slice to its
target compute node, so the compute-side redistribution disappears. A
position vector (log2 n bits a row) lets the compute cluster route its
cached columns without re-reading the keys.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.cluster import COMPUTE_NET_BW, PARTITION_BW
from repro_torch.core.engine import EngineConfig, PlannedRequest, plan_requests
from repro_torch.core.executor import compile_push_plan
from repro_torch.core.plan import PushPlan
from repro_torch.core.simulator import SimRequest, simulate
from repro_torch.obs import trace as obs_trace
from repro_torch.queryproc import operators as ops
from repro_torch.queryproc.queries import Query
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import Catalog


@dataclasses.dataclass
class ShuffleConfig:
    num_compute_nodes: int = 4
    compute_net_bw: float = COMPUTE_NET_BW  # 10 Gbps NICs (r5.4xlarge)
    partition_bw: float = PARTITION_BW      # compute-node partition rate
    buffer_bytes: int = 256 << 20   # bounded pull buffer at storage (§4.2)
    position_vector: bool = True    # cached-column interop variant


@dataclasses.dataclass
class ShuffleRun:
    qid: str
    t_total: float
    cross_compute_bytes: float      # redistribution traffic inside compute
    storage_net_bytes: float        # storage -> compute traffic
    position_vector_bytes: float


def _exec_table_bytes(reqs: List[PlannedRequest]
                      ) -> Dict[str, List[Tuple[int, int]]]:
    """Run each request's plan, one fused pass per (table, plan), and
    record (node, result bytes) per request, each pass under a
    ``storage_execute`` span."""
    tr = obs_trace.get_tracer()
    groups: Dict[Tuple[str, int], List[PlannedRequest]] = {}
    for r in reqs:
        groups.setdefault((r.table, id(r.plan)), []).append(r)
    by_table: Dict[str, List[Tuple[int, int]]] = {}
    for (table, _), rs in groups.items():
        with tr.span("storage_execute", cat="shuffle", table=table,
                     n_parts=len(rs)) as sp:
            parts, _aux = compile_push_plan(rs[0].plan).execute_batch_parts(
                [r.part.data for r in rs])
            total = 0
            for r, res in zip(rs, parts):
                b = res.nbytes(stored=False) if len(res) else 0
                total += b
                by_table.setdefault(table, []).append((r.part.node_id, b))
            if tr.enabled:
                sp.set(shipped_bytes=int(total))
    return by_table


def run_shuffle(query: Query, catalog: Catalog, cfg: EngineConfig,
                scfg: ShuffleConfig, pushdown: bool) -> ShuffleRun:
    """End-to-end time of the pushable portion plus the redistribution,
    under baseline pushdown (shuffle at compute) or shuffle pushdown."""
    reqs = plan_requests(query, catalog)
    sim_reqs = []
    for r in reqs:
        cost = r.cost
        if pushdown and r.table in query.shuffle_keys:
            cost = cost.shuffled()
        sim_reqs.append(SimRequest(r.req_id, r.part.node_id, query.qid, cost))
    sim = simulate(sim_reqs, cfg.res, "eager")

    out_bytes = _exec_table_bytes(reqs)
    cross = 0.0
    part_bytes = 0.0
    pv_bytes = 0.0
    storage_net = sim.net_bytes
    n = scfg.num_compute_nodes
    for table, parts in out_bytes.items():
        total = float(sum(b for _, b in parts))
        if table not in query.shuffle_keys:
            continue
        if pushdown:
            # storage routes directly; the position vector for the cached
            # columns costs log2 n bits a row
            if scfg.position_vector:
                rows = sum(len(r.part.data) for r in reqs if r.table == table)
                pv_bytes += rows * max(1, int(np.ceil(np.log2(n)))) / 8
        else:
            # round-robin landing, then every landed byte is hashed and
            # serialized by the compute partitioner; (n-1)/n crosses
            part_bytes += total
            cross += total * (n - 1) / n
    t_shuffle = (part_bytes / (scfg.partition_bw * n)
                 + cross / (scfg.compute_net_bw * n))
    # bounded-buffer throttle: past buffer_bytes per storage node the net
    # stage drains at the link rate
    if pushdown:
        overflow = max(0.0, storage_net - scfg.buffer_bytes * len(
            {r.part.node_id for r in reqs}))
        t_shuffle += overflow / cfg.res.net_bw
        storage_net += pv_bytes
    t_np = sum(float(b) for parts in out_bytes.values()
               for _, b in parts) / (cfg.compute_bw * n)
    return ShuffleRun(query.qid, sim.makespan + t_shuffle + t_np,
                      cross, storage_net, pv_bytes)


# ------------------------------------------------------------ real shuffle
def shuffle_at_storage(catalog: Catalog, table: str, key: str, n: int
                       ) -> List[ColumnTable]:
    """Every partition of ``table`` split by ``key`` at its storage node,
    the per-target slices concatenated, with the plain operators: the
    oracle of ``shuffle_at_storage_batched``."""
    targets: List[List[ColumnTable]] = [[] for _ in range(n)]
    for part in catalog.partitions_of(table):
        for t, piece in enumerate(ops.shuffle_partition(part.data, key, n)):
            targets[t].append(piece)
    return [ColumnTable.concat(ps) for ps in targets]


def shuffle_at_storage_batched(catalog: Catalog, table: str, key: str, n: int
                               ) -> List[ColumnTable]:
    """The same per-target tables from the executor's shuffle aux: one
    hash launch and one stable sort over all partitions."""
    parts = [p.data for p in catalog.partitions_of(table)]
    plan = PushPlan(table, tuple(parts[0].columns), shuffle=(key, n))
    _tables, aux = compile_push_plan(plan).execute_batch_parts(parts)
    targets: List[List[ColumnTable]] = [[] for _ in range(n)]
    for a in aux:
        for t, piece in enumerate(a["shuffle_parts"]):
            targets[t].append(piece)
    return [ColumnTable.concat(ps) for ps in targets]


def apply_position_vector(t: ColumnTable, pv: torch.Tensor, n: int
                          ) -> List[ColumnTable]:
    """Route a compute-cached table's rows with a storage-shipped position
    vector: no key column re-read, no re-hash. Equals
    ``ops.shuffle_partition(t, key, n)`` when ``pv`` is the position
    vector the storage node computed over ``key``."""
    return [t.filter(pv == i) for i in range(n)]


def shuffle_at_compute(catalog: Catalog, table: str, key: str, n: int
                       ) -> List[ColumnTable]:
    """Baseline: round-robin landing, then redistribution at compute; the
    same final placement as ``shuffle_at_storage``."""
    landed: List[List[ColumnTable]] = [[] for _ in range(n)]
    for i, part in enumerate(catalog.partitions_of(table)):
        landed[i % n].append(part.data)
    out: List[List[ColumnTable]] = [[] for _ in range(n)]
    for node_tables in landed:
        if not node_tables:
            continue
        merged = ColumnTable.concat(node_tables)
        for t, piece in enumerate(ops.shuffle_partition(merged, key, n)):
            out[t].append(piece)
    return [ColumnTable.concat(ps) for ps in out]
