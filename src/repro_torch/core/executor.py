"""Fused batched storage executor on the device.

Port of ``repro.core.executor``: a ``PushPlan`` compiles once per query,
and all partitions of a table that share it run in one device pass.

- Filter-only plans: the ``predicate_bitmap`` kernel evaluates the
  predicate over the concatenated predicate columns; the words unpack to a
  row mask, each output column is gathered once, derived columns are
  computed over the survivors, and the projection is returned.
- Aggregating plans: derived columns are computed over every row, rows
  get dense group ids ``(partition, keys...)`` in lexicographic order —
  the order the reference's ``(pid, keys...)`` lexsort gives — and one
  ``fused_scan_agg`` launch per summed column applies the predicate and
  adds the kept rows into their groups in f64. Groups no row kept are
  dropped. Keyless plans group by partition alone and keep the
  reference's one row per partition with its ``[0.]`` placeholder for a
  partition with no rows.

Output dtypes follow the reference (int32 keys, f64 sums, int64 counts),
so the bytes a pushdown ships are the reference's. Plans with ``top_k``,
``having``, ``shuffle``, ``bitmap_only`` or ``apply_bitmap`` and pushed
min/max aggregates are not in this slice and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cost import RequestCost
from repro_torch.core.plan import PushPlan, estimate_cost
from repro_torch.kernels import fused_scan_agg as fsa
from repro_torch.kernels import predicate_bitmap as pbk
from repro_torch.kernels.program import Program, compile_program
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc import operators as qops
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import Partition


@dataclasses.dataclass
class CompiledPushPlan:
    """A PushPlan lowered once, with its plan-level invariants."""
    plan: PushPlan
    accessed: Tuple[str, ...]          # plan.accessed_columns()
    pred_cols: Tuple[str, ...]         # columns the predicate reads
    sel_fn: Optional[Callable]         # compiled selectivity estimator
    agg_spec: Dict[str, Tuple[str, str]]  # out -> (fn, col); {} if no agg
    # the predicate's kernel program per tuple of predicate-column dtypes
    programs: Dict[tuple, Program] = dataclasses.field(default_factory=dict,
                                                       repr=False)

    def program(self, cols: Dict[str, torch.Tensor]) -> Optional[Program]:
        """The predicate's postfix program for these columns, compiled at
        the first batch whose columns have their dtypes."""
        if self.plan.predicate is None:
            return None
        key = tuple(cols[c].dtype for c in self.pred_cols)
        if key not in self.programs:
            self.programs[key] = compile_program(
                self.plan.predicate, dict(zip(self.pred_cols, key)))
        return self.programs[key]

    def raw_projection(self, data: ColumnTable) -> ColumnTable:
        """The pushback payload: the raw accessed-column projection of one
        partition (the paper's ``S_in``), a copy as if shipped. Replaying
        the plan over it equals running it over the partition."""
        return ColumnTable({c: data.cols[c].clone() for c in self.accessed
                            if c in data.cols})

    def estimate_cost(self, part: Partition) -> RequestCost:
        return estimate_cost(self.plan, part, self.sel_fn)

    def execute_batch_parts(self, tables: Sequence[ColumnTable]
                            ) -> List[ColumnTable]:
        """Per-partition results of one fused pass over ``tables``."""
        out, bounds = self._run_batch(tables)
        return [ColumnTable({c: v[bounds[p]:bounds[p + 1]]
                             for c, v in out.cols.items()})
                for p in range(len(tables))]

    def _run_batch(self, tables: Sequence[ColumnTable]
                   ) -> Tuple[ColumnTable, List[int]]:
        """The fused pass: (merged output, per-partition row bounds)."""
        plan = self.plan
        lens = [len(t) for t in tables]
        present = [c for c in self.accessed if c in tables[0].cols]

        def concat(column: str) -> torch.Tensor:
            if len(tables) == 1:
                return tables[0].cols[column]
            return torch.cat([t.cols[column] for t in tables])

        if plan.agg is not None:
            return self._agg_batch(tables, lens, {c: concat(c)
                                                  for c in present})
        cols: Dict[str, torch.Tensor] = {}
        if plan.predicate is not None:
            pcols = {c: concat(c) for c in self.pred_cols}
            prog = self.program(pcols)
            words = pbk.predicate_bitmap(prog, [pcols[c] for c in prog.columns])
            keep = torch.nonzero(qops.unpack_bitmap(words, sum(lens))).flatten()
            # survivors before each partition's end -> output bounds
            ends = torch.as_tensor(np.cumsum(lens), device=keep.device)
            bounds = [0] + torch.searchsorted(keep, ends).tolist()
            for c in present:
                cols[c] = (pcols[c] if c in pcols else concat(c))[keep]
        else:
            bounds = [0] + np.cumsum(lens).tolist()
            cols = {c: concat(c) for c in present}
        for name, incols, fn in plan.derive:
            cols[name] = fn(*[cols[c] for c in incols])
        return (ColumnTable({c: cols[c] for c in plan.columns if c in cols}),
                bounds)

    def _agg_batch(self, tables: Sequence[ColumnTable], lens: List[int],
                   cols: Dict[str, torch.Tensor]
                   ) -> Tuple[ColumnTable, List[int]]:
        plan = self.plan
        keys = plan.agg[0]
        n_parts = len(tables)
        dev = next(iter(cols.values())).device
        for name, incols, fn in plan.derive:
            cols[name] = fn(*[cols[c] for c in incols])
        seg = torch.repeat_interleave(
            torch.arange(n_parts, device=dev),
            torch.as_tensor(lens, device=dev))
        ids, G, decode = qops.group_ids([cols[k] for k in keys], lead=seg,
                                        lead_size=n_parts)
        prog = self.program(cols)
        pcols = [cols[c] for c in prog.columns] if prog is not None else []
        sums: Dict[str, torch.Tensor] = {}
        counts = None
        for name, (fn, col) in self.agg_spec.items():
            if fn in ("sum", "mean"):
                sums[name], counts = fsa.fused_scan_agg(
                    prog, pcols, ids, cols[col].to(torch.float64), G)
        if counts is None:
            _, counts = fsa.fused_scan_agg(prog, pcols, ids, None, G)
        if not keys:
            return self._keyless(sums, counts), list(range(n_parts + 1))
        nz = torch.nonzero(counts).flatten()
        part_of, key_vals = decode(nz)
        out = dict(zip(keys, key_vals))
        cnt = counts[nz]
        for name, (fn, _col) in self.agg_spec.items():
            out[name] = (cnt if fn == "count" else sums[name][nz] if fn == "sum"
                         else sums[name][nz] / torch.clamp(cnt, min=1))
        bounds = torch.searchsorted(
            part_of, torch.arange(n_parts + 1, device=dev)).tolist()
        return ColumnTable(out), bounds

    def _keyless(self, sums: Dict[str, torch.Tensor], counts: torch.Tensor
                 ) -> ColumnTable:
        """One row per partition; a partition with no kept rows gets the
        reference's float64 ``0.`` placeholder in every column (which makes
        a count column float64, as numpy's concatenation does)."""
        empty = counts == 0
        any_empty = bool(empty.any())
        out = {}
        for name, (fn, _col) in self.agg_spec.items():
            if fn == "count":
                v = counts.to(torch.float64) if any_empty else counts
            elif fn == "sum":
                v = sums[name]
            else:
                v = sums[name] / torch.clamp(counts, min=1)
            out[name] = torch.where(empty, torch.zeros((), dtype=v.dtype,
                                                       device=v.device), v)
        return ColumnTable(out)


_UNSUPPORTED = ("top_k", "having", "shuffle", "bitmap_only", "apply_bitmap")


def compile_push_plan(plan: PushPlan) -> CompiledPushPlan:
    """Lower a PushPlan once per (query, table)."""
    used = [f for f in _UNSUPPORTED if getattr(plan, f) not in (None, False)]
    if used:
        raise NotImplementedError(f"PushPlan {', '.join(used)} is not in "
                                  f"this slice of the port")
    if not plan.columns and plan.agg is None:
        raise ValueError("plans must declare output columns")
    agg_spec = ({o: (f, c) for o, f, c in plan.agg[1]}
                if plan.agg is not None else {})
    if any(f not in ("sum", "count", "mean") for f, _ in agg_spec.values()):
        raise NotImplementedError("pushed min/max aggregates are not in this "
                                  "slice of the port")
    return CompiledPushPlan(
        plan=plan, accessed=plan.accessed_columns(),
        pred_cols=(tuple(sorted(ex.columns_of(plan.predicate)))
                   if plan.predicate is not None else ()),
        sel_fn=(ex.compile_selectivity(plan.predicate)
                if plan.predicate is not None else None),
        agg_spec=agg_spec)
