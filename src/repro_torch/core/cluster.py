"""The compute cluster a query's residual runs on (§4.2, Fig 15): ``n``
compute nodes over the storage nodes, simulated on one device as the
storage nodes are.

``EngineConfig.shuffle`` says where the tables that a query's joins need
split by key (``Query.shuffle_keys``, the compiler's ``Shuffle`` markers)
are routed to their compute node:

- ``"none"``: no routing; each table is merged whole, the single-node path.
- ``"storage"``: shuffle pushdown. Each such table's frontier plan carries
  the partition function (``PushPlan.shuffle``; ``shuffle_plan`` states
  which plans can), so a pushed-down request hashes its key while it
  scans and ships each slice straight to its node
  (``aux["shuffle_parts"]``). A pushed-back partition reaches the compute
  layer raw: partition ``i`` lands on node ``i mod n``, is replayed there
  without the partition function and routed with ``hash_partition``.
- ``"compute"``: the Fig-15 baseline. No plan carries the partition
  function; every result lands round-robin and is routed at compute.

Either way node ``t`` ends up with the rows whose key hashes to ``t``
(``kernels.ref.hash_partition_ids``), in request order, so the answer does
not depend on the mode. The residual interpreter runs per node over such
``Partitioned`` values (``compiler.interpreter``).

The compute fabric's traffic (``Exchange``) is counted apart from the
storage-to-compute bytes (``real_net_bytes``): rows routed off their
landing node, whole sides broadcast to the ``n - 1`` other nodes, and
slices gathered to node 0, the coordinator. Each query adds it to the
``shuffle.*`` counters, traced or not.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.executor import slices_by_target
from repro_torch.core.plan import PushPlan
from repro_torch.kernels import hash_partition as hpk
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_metrics
from repro_torch.queryproc.table import ColumnTable

SHUFFLE_NONE = "none"
SHUFFLE_STORAGE = "storage"
SHUFFLE_COMPUTE = "compute"
SHUFFLE_MODES = (SHUFFLE_NONE, SHUFFLE_STORAGE, SHUFFLE_COMPUTE)

COMPUTE_NET_BW = 1.25e9  # compute node NICs: 10 Gbps (the paper's r5.4xlarge)
PARTITION_BW = 2.4e9     # a compute node's hash/serialize rate

COUNTERS = ("shuffle.routed_rows", "shuffle.redistributed_bytes",
            "shuffle.broadcast_bytes", "shuffle.gather_bytes")


@dataclasses.dataclass
class Exchange:
    """One query's traffic inside the compute cluster."""
    routed_rows: int = 0          # rows hashed and routed at compute
    routed_bytes: int = 0         # their bytes
    redistributed_bytes: int = 0  # of them, the bytes off their landing node
    broadcast_bytes: int = 0      # whole sides sent to the n - 1 other nodes
    gather_bytes: int = 0         # slices sent to node 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def publish(self) -> None:
        """Add this query's traffic to the ``shuffle.*`` counters."""
        m = get_metrics()
        for name in COUNTERS:
            m.counter(name).inc(getattr(self, name.split(".", 1)[1]))

    def redistribution_time(self, n: int) -> float:
        """Seconds the cluster spends redistributing, as
        ``core.shuffle.run_shuffle`` reckons them: every routed byte
        hashed at ``PARTITION_BW``, every byte off its node over the NICs,
        ``n`` nodes at once."""
        return (self.routed_bytes / (PARTITION_BW * n)
                + self.redistributed_bytes / (COMPUTE_NET_BW * n))


def _raw(t: ColumnTable) -> int:
    return t.nbytes(stored=False)


@dataclasses.dataclass
class Partitioned:
    """A table split over the compute nodes: node ``i`` holds
    ``slices[i]``. ``key`` names the column whose hash placed every row
    (None where no column says it any more)."""
    slices: List[ColumnTable]
    key: Optional[str]

    @property
    def n(self) -> int:
        return len(self.slices)

    def __len__(self) -> int:
        return sum(len(s) for s in self.slices)

    def nbytes(self) -> int:
        return sum(_raw(s) for s in self.slices)

    def gather(self, exchange: Exchange) -> ColumnTable:
        """The whole table on node 0: the slices in node order."""
        tr = obs_trace.get_tracer()
        moved = sum(_raw(s) for s in self.slices[1:])
        with tr.span("gather", cat="shuffle", nodes=self.n, rows=len(self),
                     bytes=moved):
            out = ColumnTable.concat(self.slices)
        exchange.gather_bytes += moved
        return out


def table_bytes(v) -> int:
    """Raw bytes of a whole or partitioned table."""
    return v.nbytes() if isinstance(v, Partitioned) else _raw(v)


@dataclasses.dataclass(frozen=True)
class Routing:
    """Which tables of one query are split over ``n`` compute nodes, on
    which key, and whether their plans hash at storage."""
    n: int
    keys: Dict[str, str]
    at_storage: bool


def shuffle_plan(plan: PushPlan, key: str, n: int, at_storage: bool
                 ) -> Optional[PushPlan]:
    """``plan`` made routable on ``key``, or None where it cannot be: a
    plan that aggregates (or keeps a top-k) is split only on one of its
    group keys; any other keeps ``key`` among its output columns. With
    ``at_storage`` the plan carries the partition function."""
    if plan.agg is not None or plan.top_k is not None:
        if key not in (plan.agg[0] if plan.agg else ()):
            return None
        cols = plan.columns
    else:
        cols = (plan.columns if key in plan.columns
                else tuple(plan.columns) + (key,))
    return dataclasses.replace(plan, columns=cols,
                               shuffle=(key, n) if at_storage else None)


def route_query(query, shuffle: str, n: int):
    """``(query, routing)``: the query with each table of its
    ``shuffle_keys`` that can be split made routable, and the routing; the
    query itself and None under ``"none"``."""
    if shuffle not in SHUFFLE_MODES:
        raise ValueError(f"unknown shuffle {shuffle!r}; expected one of "
                         f"{SHUFFLE_MODES}")
    if shuffle == SHUFFLE_NONE:
        return query, None
    hpk.check_targets(n)
    at_storage = shuffle == SHUFFLE_STORAGE
    plans = dict(query.plans)
    keys: Dict[str, str] = {}
    for table, key in query.shuffle_keys.items():
        p = shuffle_plan(plans[table], key, n, at_storage) \
            if table in plans else None
        if p is not None:
            plans[table] = p
            keys[table] = key
    return (dataclasses.replace(query, plans=plans),
            Routing(n, keys, at_storage))


def assemble(table: str, key: str, n: int,
             results: Sequence[Tuple[int, ColumnTable, Dict]],
             exchange: Exchange) -> Partitioned:
    """Each node's table of one routed table from its requests' results,
    in request order: ``(partition index, result, aux)``. A result whose
    aux holds ``shuffle_parts`` was split storage-side; every other lands
    on node ``index mod n`` and is routed here, all of them with one
    ``hash_partition`` launch, under a ``route`` span."""
    tr = obs_trace.get_tracer()
    with tr.span("route", cat="shuffle", table=table, nodes=n) as sp:
        pieces: List[Optional[List[ColumnTable]]] = [
            aux.get("shuffle_parts") for _, _, aux in results]
        here = [j for j, p in enumerate(pieces) if p is None]
        if here:
            tabs = [results[j][1] for j in here]
            lens = [len(t) for t in tabs]
            bounds = [0]
            for m in lens:
                bounds.append(bounds[-1] + m)
            whole = ColumnTable.concat(tabs)
            pids, _ = hpk.hash_partition(whole.cols[key], n)
            for j, split in zip(here, slices_by_target(whole, bounds, pids,
                                                       n)):
                pieces[j] = split
                landed = results[j][0] % n
                exchange.redistributed_bytes += sum(
                    _raw(s) for t, s in enumerate(split) if t != landed)
            exchange.routed_rows += sum(lens)
            exchange.routed_bytes += sum(_raw(t) for t in tabs)
        out = Partitioned([ColumnTable.concat([p[t] for p in pieces])
                           for t in range(n)], key)
        if tr.enabled:
            sp.set(rows_routed=sum(len(results[j][1]) for j in here),
                   rows=len(out))
    return out
