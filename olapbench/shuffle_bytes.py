"""The bytes of the shuffle pass's roofline (``shuffle_roofline``), worked
out from the benchmark's own tables and the Arbitrator's decisions, never
from the program's counters.

For each completed query, and each table its plan splits over the compute
nodes:

- a partition pushed down is read once, every accessed column of every
  row (the storage pass filters it, hashes the key and cuts the slices);
- a partition pushed back costs the key column of the rows its plan keeps
  (the compute layer hashes them to route them).

``SHUFFLED`` states, for each query of the join mix, the tables split,
their key and the rows each plan keeps: the compiled plans' predicates,
every row where a plan has none, and one row a key a partition where it
aggregates by the key (Q18's lineitem).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np

from olapbench import compare, devtrace
from olapbench.gen import date

GROUPS = "groups"   # the plan aggregates by the key: one row a key
SHUFFLE_KERNELS = ("fused_scan_shuffle", "hash_partition")


def _col(table: str, name: str):
    return lambda T: T[table][name]


def _between(table: str, name: str, lo: int, hi: int):
    """``lo <= v < hi``, as ``Col.between`` compiles."""
    return lambda T: (T[table][name] >= lo) & (T[table][name] < hi)


_D3, _D5, _D10 = date(1995, 3, 15), date(1994, 1, 1), date(1993, 10, 1)
_Y0, _Y1 = date(1995, 1, 1), date(1996, 12, 31) + 1

Rule = Optional[object]   # None: every row; GROUPS; or a mask of T
SHUFFLED: Dict[str, Dict[str, Tuple[str, Rule]]] = {
    "Q3": {"lineitem": ("l_orderkey",
                        lambda T: _col("lineitem", "l_shipdate")(T) > _D3),
           "orders": ("o_orderkey",
                      lambda T: _col("orders", "o_orderdate")(T) < _D3)},
    "Q5": {"lineitem": ("l_orderkey", None),
           "orders": ("o_orderkey", _between("orders", "o_orderdate",
                                             _D5, _D5 + 365))},
    "Q7": {"lineitem": ("l_orderkey", _between("lineitem", "l_shipdate",
                                               _Y0, _Y1)),
           "orders": ("o_orderkey", None)},
    "Q8": {"lineitem": ("l_orderkey", None),
           "orders": ("o_orderkey", _between("orders", "o_orderdate",
                                             _Y0, _Y1))},
    "Q10": {"lineitem": ("l_orderkey",
                         lambda T: _col("lineitem", "l_returnflag")(T) == 2),
            "orders": ("o_orderkey", _between("orders", "o_orderdate",
                                              _D10, _D10 + 92))},
    "Q18": {"lineitem": ("l_orderkey", GROUPS),
            "orders": ("o_orderkey", None)},
}


class ShuffleBytes:
    """The roofline's bytes of completed queries over one configuration's
    tables, each (query, table)'s kept rows a partition worked out once."""

    def __init__(self, tables: Dict, config: Dict, device="cpu"):
        self.tables = tables
        self.layout = compare.Layout(tables, config, device)
        self._kept: Dict[Tuple[str, str], List[int]] = {}

    def _parts(self, table: str) -> Tuple[List[int], Optional[np.ndarray]]:
        """(partition bounds, the row order they cut: None for the
        table's own), as the storage layer partitions the table."""
        L = self.layout
        L.n_partitions(table)
        order = L._order[table]
        return (L._bounds[table],
                None if order is None else order.cpu().numpy())

    def kept(self, qid: str, table: str) -> List[int]:
        """Rows each partition of ``table`` keeps under ``qid``'s plan."""
        k = (qid, table)
        if k in self._kept:
            return self._kept[k]
        key, rule = SHUFFLED[qid][table]
        bounds, order = self._parts(table)
        if rule is None:
            out = np.diff(bounds).tolist()
        elif rule is GROUPS:
            v = self.tables[table][key]
            v = v if order is None else v[order]
            out = [int(np.unique(v[a:b]).size)
                   for a, b in zip(bounds, bounds[1:])]
        else:
            mask = np.asarray(rule(self.tables))
            mask = mask if order is None else mask[order]
            csum = np.concatenate([[0], np.cumsum(mask, dtype=np.int64)])
            out = (csum[bounds[1:]] - csum[bounds[:-1]]).tolist()
        self._kept[k] = out
        return out

    def of(self, done, accessed: Dict[str, List[str]]) -> int:
        """One completed query's bytes: its split tables' pushed-down
        partitions read whole, its pushed-back ones' kept keys."""
        total = 0
        for table, (key, _) in SHUFFLED.get(done.qid, {}).items():
            back = {i for t, i, _ in done.pushback if t == table}
            bounds, _ = self._parts(table)
            cols = self.tables[table]
            width = sum(cols[c].itemsize for c in accessed[table])
            kept = self.kept(done.qid, table) if back else None
            for i, (a, b) in enumerate(zip(bounds, bounds[1:])):
                total += (kept[i] * cols[key].itemsize if i in back
                          else (b - a) * width)
        return total


def shuffle_intervals(trace: devtrace.DeviceTrace, spans
                      ) -> List[Tuple[int, int]]:
    """The host intervals of the shuffle pass: every ``route`` span, and
    every ``storage_execute`` span inside which a shuffle kernel
    (``fused_scan_shuffle``, ``hash_partition``) was launched."""
    kernel = {c for _, _, name, c in trace.work
              if any(k in name for k in SHUFFLE_KERNELS)}
    times = [t for t, c in trace.launches if c in kernel]
    out = []
    for a, b, name, _, _ in spans:
        if name == "route":
            out.append((a, b))
        elif name == "storage_execute":
            i = bisect.bisect_left(times, a)
            if i < len(times) and times[i] < b:
                out.append((a, b))
    return sorted(out)


def shuffle_roofline(run) -> Optional[float]:
    """The least time in which the card could read the shuffle pass's bytes
    (``ShuffleBytes``) at the HBM rate of ``peaks``, over the device time
    of the work launched inside the shuffle pass's spans, in percent."""
    if run.device is None or not run.hbm_bytes_per_s or not run.done:
        return None
    busy = devtrace.work_launched_in(run.device,
                                     shuffle_intervals(run.device, run.spans))
    if busy <= 0:
        return None
    sb = ShuffleBytes(run.tables, run.config, "cuda")
    nbytes = sum(sb.of(d, run.mix["accessed"][d.qid]) for d in run.done)
    return nbytes / run.hbm_bytes_per_s / busy * 100.0

