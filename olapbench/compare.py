"""The comparison that decides ``correct``, and the bytes the reference
counts for itself.

Three numbers are compared, each beside its limit (``LIMITS``):

- ``result_rel_err``: the widest relative gap between a float of a
  completed query's result and the reference's, over every query the
  window completed. The program adds float64 sums in an order of its own
  (atomics), so a gap at rounding is no fault; float32 arithmetic, the
  control (``control.py``), reads far above the limit.
- ``result_mismatches``: completed queries whose result differs from the
  reference's in anything else: its columns, its row count, or a key or
  other integer value. Exact: limit 0.
- ``bytes_mismatches``: completed queries whose shipped bytes do not
  reconcile. Every request a query pushed back ships the stored bytes
  (the storage layer's compression model) of the columns the mix file
  lists for that query and table, of that partition, which the reference
  counts itself; every pushed-down request ships a whole number of rows
  of one width a table (64 bytes when empty); and the query's
  ``real_net_bytes`` is the sum of its requests'. Exact: limit 0.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

LIMITS = {"result_rel_err": 1e-9, "result_mismatches": 0,
          "bytes_mismatches": 0}


# ------------------------------------------------------------- results
def _canonical(t: Dict[str, np.ndarray], exact: Sequence[str]
               ) -> Dict[str, np.ndarray]:
    """Rows ordered by the exact columns (last one primary), so that two
    tables with the same keys line up whatever order each came in."""
    n = len(next(iter(t.values()))) if t else 0
    if not exact or n <= 1:
        return t
    order = np.lexsort(tuple(t[c] for c in reversed(list(exact))))
    return {c: v[order] for c, v in t.items()}


def compare_result(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
                   ) -> Tuple[Optional[str], float]:
    """(what differs beyond rounding, or None; the widest relative gap of a
    float). A column is exact where the reference's is an integer."""
    if set(got) != set(want):
        return f"columns {sorted(got)} against {sorted(want)}", 0.0
    ng = len(next(iter(got.values()))) if got else 0
    nw = len(next(iter(want.values()))) if want else 0
    if ng != nw:
        return f"{ng} rows against {nw}", 0.0
    exact = [c for c, v in want.items() if v.dtype.kind in "biu"]
    try:
        g = _canonical({c: (np.asarray(v).astype(np.int64) if c in exact
                            else np.asarray(v, np.float64))
                        for c, v in got.items()}, exact)
    except (TypeError, ValueError) as e:
        return f"unreadable result: {e}", 0.0
    w = _canonical({c: (v.astype(np.int64) if c in exact
                        else v.astype(np.float64)) for c, v in want.items()},
                   exact)
    for c in exact:
        if not np.array_equal(g[c], w[c]):
            return f"column {c} differs", 0.0
    worst = 0.0
    for c in want:
        if c in exact or not nw:
            continue
        a, b = g[c], w[c]
        if np.isnan(a).any() or np.isnan(b).any():
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                return f"column {c}: NaN where the reference has none", 0.0
            a, b = a[~np.isnan(a)], b[~np.isnan(b)]
        scale = np.maximum(np.abs(a), np.abs(b))
        gap = np.abs(a - b)
        rel = np.where(scale > 0, gap / np.where(scale > 0, scale, 1), 0.0)
        worst = max(worst, float(rel.max()) if rel.size else 0.0)
    return None, worst


# --------------------------------------------------------------- bytes
def _stored(n: int, itemsize: int, sample: np.ndarray) -> int:
    """A column's stored bytes under the storage layer's compression model
    (low-cardinality columns dictionary-encode well), from the strided
    sample of about 4,096 of its ``n`` values: the distinct count scaled
    by the stride, and ``int(raw * (0.08 + 0.92 * min(1, 8 * distinct /
    rows)))``."""
    step = max(1, n // 4096)
    if sample.dtype.kind == "f":
        sample = sample + 0.0  # -0.0 counts as 0.0
    ndv = min(np.unique(sample).size * step, n)
    comp = 0.08 + 0.92 * min(1.0, ndv / max(1, n) * 8)
    return int(n * itemsize * comp)


class Layout:
    """The configuration's partitions of each table, worked out from its
    file: ``lineitem_rows_per_partition`` rows of lineitem (clustered
    tables sorted stably by their key first, on ``device``, each boundary
    pushed to the end of its key's run), every other table in
    ``objects_per_table`` objects."""

    def __init__(self, tables: Dict[str, Dict[str, np.ndarray]],
                 config: Dict, device="cpu"):
        self.tables = tables
        self.config = config
        self.device = torch.device(device)
        self._order: Dict[str, Optional[torch.Tensor]] = {}
        self._bounds: Dict[str, List[int]] = {}
        self._stored: Dict[Tuple[str, int, str], int] = {}

    def _table(self, table: str):
        if table in self._bounds:
            return
        cols = self.tables[table]
        n = len(next(iter(cols.values())))
        key = self.config["cluster"].get(table)
        rpp = (self.config["lineitem_rows_per_partition"]
               if table == "lineitem"
               else max(n // self.config["objects_per_table"], 1))
        if key is None:
            self._order[table] = None
            bounds = [min(n, i * rpp)
                      for i in range(max(1, -(-n // rpp)) + 1)]
        else:
            k = torch.from_numpy(cols[key].astype(np.int64)).to(self.device)
            sk, order = torch.sort(k, stable=True)
            self._order[table] = order
            bounds = [0]
            while bounds[-1] < n:
                j = min(n, bounds[-1] + rpp)
                if j < n:
                    j = int(torch.searchsorted(sk, sk[j - 1:j], right=True))
                bounds.append(j)
        self._bounds[table] = bounds

    def n_partitions(self, table: str) -> int:
        self._table(table)
        return len(self._bounds[table]) - 1

    def stored(self, table: str, index: int, columns: Sequence[str]) -> int:
        """The stored bytes of ``columns`` of one partition."""
        self._table(table)
        lo, hi = self._bounds[table][index:index + 2]
        step = max(1, (hi - lo) // 4096)
        order = self._order[table]
        rows = (np.arange(lo, hi, step) if order is None
                else order[lo:hi:step].cpu().numpy())
        total = 0
        for c in columns:
            k = (table, index, c)
            if k not in self._stored:
                v = self.tables[table][c]
                self._stored[k] = _stored(hi - lo, v.itemsize, v[rows])
            total += self._stored[k]
        return total


def scanned_bytes(tables: Dict[str, Dict[str, np.ndarray]],
                  accessed: Dict[str, Sequence[str]]) -> int:
    """Bytes one query's pushdown plans read from the device: every row of
    each scanned table, each accessed column at its stored width, once.
    Every partition's plan runs once, on storage or replayed after
    pushback, so this is the byte side of the plan pass's roofline."""
    return sum(tables[t][c].nbytes for t, cols in accessed.items()
               for c in cols)


def bytes_fault(done, accessed: Dict[str, Sequence[str]], layout: Layout
                ) -> Optional[str]:
    """Why one completed query's shipped bytes do not reconcile, or None.
    ``done.pushback`` lists (table, partition, shipped bytes),
    ``done.pushdown`` (table, rows out, shipped bytes)."""
    total = 0
    for table, index, shipped in done.pushback:
        if table not in accessed:
            return f"pushed back a partition of {table}, which it never reads"
        want = layout.stored(table, index, accessed[table])
        if shipped != want:
            return (f"{table} partition {index} pushed back {shipped} bytes, "
                    f"its accessed columns store {want}")
        total += shipped
    widths: Dict[str, int] = {}
    for table, rows, shipped in done.pushdown:
        if rows == 0:
            if shipped != 64:
                return f"an empty {table} result shipped {shipped} bytes"
        elif shipped % rows:
            return f"{table}: {shipped} bytes for {rows} rows"
        else:
            width = widths.setdefault(table, shipped // rows)
            if shipped != rows * width:
                return f"{table}: rows of {shipped // rows} and {width} bytes"
        total += shipped
    if total != done.real_net_bytes:
        return (f"real_net_bytes {done.real_net_bytes} against {total} over "
                f"its requests")
    return None
