"""Selection-bitmap pushdown (paper §4.2, Figs 3/4/13/14) on the device.

Port of ``repro.core.bitmap``. Late materialisation across the
storage/compute boundary:

- storage-side bitmap (Fig 3): the output columns are cached at compute.
  The storage node evaluates the predicate and ships the packed words plus
  the uncached output columns (``storage_side_bitmap_batched``, the
  executor's ``bitmap_only`` aux); the compute layer applies the words to
  its cached columns with the ``bitmap_apply`` kernel
  (``apply_bitmap_to_cache``).
- compute-side bitmap (Fig 4): the predicate columns are cached at
  compute. The compute node ships words built from them; the storage node
  applies them and never scans the predicate columns
  (``compute_side_apply_batched``, an ``apply_bitmap`` plan through
  ``runtime.execute_split``).
- the fine-grained AND split: conjuncts go to the side that caches their
  columns, and the two sides' words combine bitwise.

Bitmap pushdown is a variant of filtering, so its requests go through the
same Arbitrator and simulator; ``rewrite_request`` only recosts them, with
the reference's integer byte accounting. Words are int32 tensors holding
uint32 bits, one ``(ceil(rows/32),)`` tensor per partition.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.core import runtime
from repro_torch.core.arbitrator import PUSHDOWN
from repro_torch.core.cost import RequestCost
from repro_torch.core.engine import PlannedRequest
from repro_torch.core.executor import compile_push_plan, unpack_parts
from repro_torch.core.plan import PushPlan
from repro_torch.kernels import bitmap_apply as bak
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc import operators as ops
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import Partition


@dataclasses.dataclass
class CacheState:
    """Which columns of which table the compute layer holds locally."""
    cached: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)

    def has(self, table: str, col: str) -> bool:
        return col in self.cached.get(table, set())

    def cache_columns(self, table: str, cols) -> None:
        self.cached.setdefault(table, set()).update(cols)


def split_predicate(expr: ex.Expr, cached: Set[str]
                    ) -> Tuple[Optional[ex.Expr], Optional[ex.Expr]]:
    """(compute_side, storage_side) for a fine-grained AND split: a
    conjunct goes to the compute layer iff all its columns are cached.
    OR nodes are atomic (both branches must co-locate)."""
    if isinstance(expr, ex.And):
        lc, ls = split_predicate(expr.left, cached)
        rc, rs = split_predicate(expr.right, cached)
        comp = lc if rc is None else (rc if lc is None else ex.And(lc, rc))
        stor = ls if rs is None else (rs if ls is None else ex.And(ls, rs))
        return comp, stor
    if ex.columns_of(expr) <= cached:
        return expr, None
    return None, expr


@dataclasses.dataclass
class BitmapRewrite:
    """Byte-accounting deltas of bitmap pushdown for one request."""
    cost: RequestCost
    bitmap_bytes: int
    disk_bytes_saved: int
    columns_skipped: int
    direction: str  # "storage" | "compute" | "mixed" | "none"


def rewrite_request(req: PlannedRequest, cache: CacheState) -> BitmapRewrite:
    """Recost one fact-table request under bitmap pushdown given the cache.
    The baseline (no bitmaps) scans predicate and output columns and ships
    the filtered output columns (sel * raw bytes)."""
    plan, part = req.plan, req.part
    data = part.data
    stats = data.stats()
    rows = len(data)
    if plan.predicate is None:
        return BitmapRewrite(req.cost, 0, 0, 0, "none")
    pred_cols = ex.columns_of(plan.predicate)
    out_cols = [c for c in plan.columns if c in data.cols]
    sel = ex.estimate_selectivity(plan.predicate, stats)
    bitmap_bytes = -(-rows // 32) * 4

    cached = cache.cached.get(req.table, set())
    comp_pred, stor_pred = split_predicate(plan.predicate, cached)
    cached_out = [c for c in out_cols if c in cached]
    uncached_out = [c for c in out_cols if c not in cached]

    if comp_pred is not None and stor_pred is None:
        # Fig 4: compute side evaluates everything; storage just applies
        s_in = data.nbytes(uncached_out, stored=True)  # pred cols unscanned
        disk_saved = req.cost.s_in - s_in
        s_out = int(data.nbytes(uncached_out, stored=False) * sel) + 64
        cost = RequestCost(s_in=int(s_in), s_out=s_out,
                           compute_in=int(data.nbytes(uncached_out, False)))
        return BitmapRewrite(cost, bitmap_bytes, int(disk_saved),
                             len(set(pred_cols) - set(uncached_out)),
                             "compute")
    if comp_pred is None and cached_out:
        # Fig 3: storage builds the bitmap; cached outputs filtered locally
        scan_cols = [c for c in sorted(set(pred_cols) | set(uncached_out))
                     if c in data.cols]
        s_in = data.nbytes(scan_cols, True)
        s_out = (int(data.nbytes(uncached_out, False) * sel)
                 + bitmap_bytes + 64)
        cost = RequestCost(s_in=int(s_in), s_out=s_out,
                           compute_in=int(data.nbytes(scan_cols, False)))
        return BitmapRewrite(cost, bitmap_bytes, 0, 0, "storage")
    if comp_pred is not None and stor_pred is not None:
        # mixed: exchange bitmaps; storage scans only its sub-predicate's
        # columns + uncached outputs
        stor_cols = sorted((ex.columns_of(stor_pred) | set(uncached_out))
                           & set(data.cols))
        s_in = data.nbytes(stor_cols, True)
        disk_saved = req.cost.s_in - s_in
        s_out = (int(data.nbytes(uncached_out, False) * sel)
                 + bitmap_bytes + 64)
        cost = RequestCost(s_in=int(s_in), s_out=s_out + bitmap_bytes,
                           compute_in=int(data.nbytes(stor_cols, False)))
        return BitmapRewrite(cost, 2 * bitmap_bytes, int(disk_saved),
                             len(set(pred_cols) - set(stor_cols)), "mixed")
    return BitmapRewrite(req.cost, 0, 0, 0, "none")


def rewrite_all(reqs: List[PlannedRequest], cache: CacheState,
                table: str = "lineitem") -> Tuple[List[PlannedRequest], Dict]:
    """Apply bitmap rewriting to every request of ``table``; other tables
    pass through. Returns (new requests, metrics)."""
    out: List[PlannedRequest] = []
    metrics = {"bitmap_bytes": 0, "disk_saved": 0, "cols_skipped": 0,
               "net_baseline": 0, "net_bitmap": 0}
    for r in reqs:
        if r.table != table:
            out.append(r)
            continue
        rw = rewrite_request(r, cache)
        metrics["bitmap_bytes"] += rw.bitmap_bytes
        metrics["disk_saved"] += rw.disk_bytes_saved
        metrics["cols_skipped"] += rw.columns_skipped
        metrics["net_baseline"] += r.cost.s_out
        metrics["net_bitmap"] += rw.cost.s_out
        out.append(dataclasses.replace(r, cost=rw.cost))
    return out, metrics


# --------------------------------------------------- real bitmap execution
def storage_side_bitmap(part_data: ColumnTable, predicate: ex.Expr,
                        out_cols_uncached: Sequence[str]
                        ) -> Tuple[torch.Tensor, ColumnTable]:
    """(packed words, filtered uncached columns) of one partition with the
    plain operators: the oracle of the batched form below."""
    words = ops.selection_bitmap(part_data, predicate)
    filtered = ops.apply_bitmap(part_data.select(
        [c for c in out_cols_uncached if c in part_data.cols]), words)
    return words, filtered


def storage_side_bitmap_batched(parts: Sequence[ColumnTable],
                                predicate: ex.Expr,
                                out_cols_uncached: Sequence[str],
                                table: str = "lineitem"
                                ) -> Tuple[List[torch.Tensor],
                                           List[ColumnTable]]:
    """The Fig-3 storage side over all partitions in one fused pass (a
    ``bitmap_only`` plan): each partition's packed words and filtered
    uncached columns."""
    cols = tuple(c for c in out_cols_uncached if c in parts[0].cols)
    plan = PushPlan(table, cols, predicate=predicate, bitmap_only=True)
    tabs, aux = compile_push_plan(plan).execute_batch_parts(parts)
    return [a["bitmap"] for a in aux], tabs


def apply_bitmap_to_cache(cached: Sequence[ColumnTable],
                          bitmaps: Sequence[torch.Tensor]
                          ) -> Tuple[List[ColumnTable], torch.Tensor]:
    """The Fig-3 compute side: each partition's shipped words applied to
    the columns the compute layer caches, one ``bitmap_apply`` launch per
    partition and column. Late materialisation: every column keeps its
    shape with the dropped rows zeroed. Returns the masked tables and each
    partition's selected rows (an int64 tensor)."""
    tabs, counts = [], []
    for t, words in zip(cached, bitmaps):
        if not t.cols:
            raise ValueError("apply_bitmap_to_cache needs a cached column "
                             "per partition")
        masked = {}
        for c, v in t.cols.items():
            masked[c], count = bak.bitmap_apply(words, v)
        tabs.append(ColumnTable(masked))
        counts.append(count)
    return tabs, torch.stack(counts) if counts else torch.zeros(
        0, dtype=torch.int64)


def compute_side_apply_batched(parts: Sequence[ColumnTable],
                               bitmaps: Sequence[torch.Tensor],
                               out_cols: Sequence[str],
                               table: str = "lineitem") -> List[ColumnTable]:
    """The Fig-4 storage side over all partitions: the compute layer's
    words filter each partition's output columns, the predicate columns
    never scanned. Each partition is a pushdown request carrying its words
    through ``runtime.execute_split``, so it runs in the same fused batch
    and byte accounting as every other storage request."""
    cols = tuple(c for c in out_cols if c in parts[0].cols)
    plan = PushPlan(table, cols, apply_bitmap=True)
    cplan = compile_push_plan(plan)
    reqs: List[PlannedRequest] = []
    bms: Dict[int, torch.Tensor] = {}
    for i, (p, words) in enumerate(zip(parts, bitmaps)):
        part = Partition(table, i, 0, p)
        reqs.append(PlannedRequest(i, "BITMAP", table, part, plan,
                                   cplan.estimate_cost(part)))
        bms[i] = words
    split = runtime.execute_split(reqs, {i: PUSHDOWN for i in bms},
                                  bitmaps=bms)
    merged = split.merged[table]
    out: List[ColumnTable] = []
    off = 0
    for o in split.outcomes:
        out.append(ColumnTable({c: v[off:off + o.rows_out]
                                for c, v in merged.cols.items()}))
        off += o.rows_out
    return out


def combine_bitmaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bitwise AND of exchanged words (§4.2), the shorter zero-padded."""
    n = max(a.shape[0], b.shape[0])
    pad = torch.nn.functional.pad
    return pad(a, (0, n - a.shape[0])) & pad(b, (0, n - b.shape[0]))


def merged_verdicts(bitmaps: Sequence[torch.Tensor],
                    part_rows: Sequence[int]) -> torch.Tensor:
    """Per-partition verdict words unpacked into one boolean vector over
    the merged pre-filter row order: the compute layer's view of an
    exchanged sub-predicate."""
    return unpack_parts(bitmaps, [int(n) for n in part_rows])
