"""Pushable sub-plans and their per-partition request cost.

Port of ``repro.core.plan`` (``PushPlan``, ``accessed_columns``,
``plan_signature``, ``batchable_stages``, ``execute_push_plan``,
``estimate_cost``). A
``PushPlan`` is the paper's pushdown-amenable operator set for one table:
projection, selection, derived columns, partial grouped/scalar
aggregation, HAVING over it, top-k, and the §4.2 shuffle and selection
bitmaps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.cost import RequestCost
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc import operators as ops
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import Partition


@dataclasses.dataclass(frozen=True)
class PushPlan:
    """What a single pushdown request executes at the storage node."""
    table: str
    columns: Tuple[str, ...]                       # projection (output cols)
    predicate: Optional[ex.Expr] = None            # selection
    derive: Tuple = ()                             # ((name, (in_cols), fn), ...)
    agg: Optional[Tuple[Tuple[str, ...], Tuple[Tuple[str, str, str], ...]]] = None
    #     ^ partial grouped agg: (keys, ((out, fn, col), ...))
    top_k: Optional[Tuple[str, int, bool]] = None  # (col, k, ascending)
    shuffle: Optional[Tuple[str, int]] = None      # (partition key, n_targets)
    bitmap_only: bool = False                      # return the selection bitmap
    apply_bitmap: bool = False                     # filter with a compute bitmap
    having: Optional[ex.Expr] = None               # post-agg filter

    def accessed_columns(self) -> Tuple[str, ...]:
        derived = {name for name, _, _ in self.derive}
        cols = set(self.columns) - derived
        if self.predicate is not None and not self.apply_bitmap:
            cols |= ex.columns_of(self.predicate)
        for _, incols, _ in self.derive:
            cols |= set(incols)
        if self.agg:
            keys, aggs = self.agg
            cols |= (set(keys) | {c for _, _, c in aggs if c}) - derived
            if self.having is not None:
                agg_out = {o for o, _, _ in aggs}
                cols |= (ex.columns_of(self.having) - agg_out
                         - set(keys) - derived)
        if self.top_k:
            cols.add(self.top_k[0])
        if self.shuffle:
            cols.add(self.shuffle[0])
        return tuple(sorted(cols))


def plan_signature(plan: PushPlan, shuffle_key: Optional[str] = None) -> str:
    """Stage signature of one pushed frontier, e.g. ``scan+filter+agg``."""
    stages = ["scan"]
    if plan.predicate is not None:
        stages.append("filter")
    if plan.bitmap_only:
        stages.append("bitmap")
    if plan.derive:
        stages.append("derive")
    if plan.agg is not None:
        stages.append("agg")
        if plan.having is not None:
            stages.append("having")
    if plan.top_k is not None:
        stages.append("topk")
    if plan.shuffle is not None or shuffle_key is not None:
        stages.append("shuffle")
    return "+".join(stages)


def batchable_stages(plan: PushPlan, shuffle_key: Optional[str] = None
                     ) -> Tuple[str, ...]:
    """The stages of this frontier the batch executor (``core.executor``)
    runs in its one device pass, the §4.2 by-products (bitmap emission,
    shuffle partitioning) included."""
    stages: List[str] = []
    if plan.apply_bitmap:
        stages.append("apply_bitmap")
    elif plan.predicate is not None:
        stages.append("filter")
        if plan.bitmap_only:
            stages.append("bitmap")
    if plan.derive:
        stages.append("derive")
    if plan.agg is not None:
        stages.append("agg")
        if plan.having is not None:
            stages.append("having")
    if plan.top_k is not None:
        stages.append("topk")
    if plan.shuffle is not None or shuffle_key is not None:
        stages.append("shuffle")
    return tuple(stages)


def execute_push_plan(plan: PushPlan, data: ColumnTable,
                      bitmap: Optional[torch.Tensor] = None
                      ) -> Tuple[ColumnTable, Dict]:
    """Run the pushable sub-plan on one partition, operator by operator:
    the per-partition oracle of the batch executor (``EngineConfig(
    executor="reference")``). Returns ``(result, aux)``, aux carrying the
    bitmap and shuffle by-products. CPU tensors only: on the card the
    batched executor's kernels run the plan."""
    if any(v.is_cuda for v in data.cols.values()):
        raise ValueError("execute_push_plan is the CPU oracle; run the "
                         "batched executor on the card")
    t = data
    aux: Dict[str, object] = {}
    if plan.apply_bitmap:
        if bitmap is None:
            raise ValueError("an apply_bitmap plan needs the compute "
                             "layer's bitmap")
        t = ops.apply_bitmap(t, bitmap)
    elif plan.predicate is not None:
        if plan.bitmap_only:
            words = ops.selection_bitmap(t, plan.predicate)
            aux["bitmap"] = words
            t = ops.apply_bitmap(t, words)
        else:
            t = ops.filter_table(t, plan.predicate)
    if plan.derive:
        cols = dict(t.cols)
        for name, incols, fn in plan.derive:
            cols[name] = fn(*[cols[c] for c in incols])
        t = ColumnTable(cols)
    if plan.agg is not None:
        keys, aggs = plan.agg
        t = ops.grouped_agg(t, list(keys), {o: (f, c) for o, f, c in aggs})
        if plan.having is not None:
            t = ops.filter_table(t, plan.having)
    elif plan.columns:
        t = t.select([c for c in plan.columns if c in t.cols])
    if plan.top_k is not None:
        col, k, asc = plan.top_k
        t = ops.top_k(t, col, k, asc)
    if plan.shuffle is not None:
        key, n = plan.shuffle
        aux["shuffle_parts"] = ops.shuffle_partition(t, key, n)
        aux["position_vector"] = ops.position_vector(t, key, n)
    return t, aux


_AGG_OUT_ROWS = 4096  # conservative group-count cap for partial aggs


def estimate_cost(plan: PushPlan, part: Partition,
                  sel_fn: Optional[Callable] = None,
                  having_sel_fn: Optional[Callable] = None) -> RequestCost:
    """Static byte estimates for the §3.3 cost model (cardinality
    estimation from per-column stats — the paper's S_out source).
    ``sel_fn`` and ``having_sel_fn`` are the predicate's and the HAVING
    filter's ``compile_selectivity`` closures, when the caller compiled
    them once for all partitions."""
    data = part.data
    stats = data.stats()
    acc_cols = [c for c in plan.accessed_columns() if c in data.cols]
    s_in = data.nbytes(acc_cols, stored=True)
    raw_in = data.nbytes(acc_cols, stored=False)
    sel = 1.0
    if sel_fn is not None:
        sel = sel_fn(stats)
    elif plan.predicate is not None:
        sel = ex.estimate_selectivity(plan.predicate, stats)
    derived = {n for n, _, _ in plan.derive}
    n_derived_out = len(derived & set(plan.columns))
    if plan.bitmap_only:
        out_cols = [c for c in plan.columns if c in data.cols]
        s_out = ((data.nbytes(out_cols, stored=False)
                  + 8 * n_derived_out * len(data)) * sel + len(data) / 8)
    elif plan.agg is not None:
        keys, aggs = plan.agg
        groups = 1
        for k in keys:
            # derived group keys have no stored stats: assume the cap
            groups *= max(1, stats[k].ndv if k in stats else _AGG_OUT_ROWS)
        groups = min(groups, _AGG_OUT_ROWS, len(data))
        s_out = groups * 8 * (len(keys) + len(aggs))
        if having_sel_fn is not None:
            s_out *= having_sel_fn(stats)
        elif plan.having is not None:
            s_out *= ex.estimate_selectivity(plan.having, stats)
    else:
        out_cols = [c for c in plan.columns if c in data.cols]
        s_out = (data.nbytes(out_cols, stored=False)
                 + 8 * n_derived_out * len(data)) * sel
    if plan.top_k is not None:
        s_out = min(s_out, plan.top_k[1] * 8 * max(1, len(plan.columns)))
    return RequestCost(s_in=int(s_in), s_out=int(max(64, s_out)),
                       compute_in=int(raw_in))
