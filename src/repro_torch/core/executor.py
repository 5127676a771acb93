"""Fused batched storage executor on the device.

Port of ``repro.core.executor``: a ``PushPlan`` compiles once per query,
and all partitions of a table that share it run in one device pass, which
returns each partition's result and its §4.2 by-products (``aux``).

- Filter-only plans: the ``predicate_bitmap`` kernel evaluates the
  predicate over the concatenated predicate columns; the words unpack to a
  row mask, each output column is gathered once, derived columns are
  computed over the survivors, and the projection is returned.
  ``apply_bitmap`` plans take the mask from the words the compute layer
  shipped per partition instead, and never read the predicate columns.
- A predicate too large for one kernel program (``program.SplitProgram``)
  takes a route of its own: ``predicate_bitmap`` runs once per part and
  the words combine with ``&``/``|`` on the device; the kept rows are
  then gathered, so an aggregate runs ``fused_scan_agg`` with no program
  and a shuffle hashes the kept keys with ``hash_partition``.
- Aggregating plans: derived columns are computed over every row, rows
  get dense group ids ``(partition, keys...)`` in lexicographic order —
  the order the reference's ``(pid, keys...)`` lexsort gives — and one
  ``fused_scan_agg`` launch for all the summed columns (up to its
  ``MAX_VALUES``; a counts-only plan takes one launch with none) applies
  the predicate and adds the kept rows into their groups in f64. Groups
  no row kept are dropped. Pushed ``min``/``max`` reduce the kept rows
  with ``scatter_reduce`` over the same ids; their predicate runs once,
  through ``predicate_bitmap``, and the kernel then sums the kept rows
  with no program. Keyless plans group by partition alone and keep the
  reference's one row per partition with its ``[0.]`` placeholder for a
  partition with no rows.
- ``having`` plans filter the partial aggregate: the HAVING predicate
  compiles to a program over the output's dtypes (int32 keys, f64 sums,
  int64 counts) and ``predicate_bitmap`` evaluates it over the output
  columns; the kept groups narrow each partition's output bounds.
- ``top_k`` plans keep each partition's k best output rows: one stable
  sort by value, one stable sort by partition, then each partition's first
  k rows, best first and ties in row order, as ``operators.top_k`` gives
  per partition.
- ``bitmap_only`` plans add each partition's packed predicate words
  (``aux["bitmap"]``), cut from the batch's words (``partition_words``).
- ``shuffle`` plans add each partition's per-target slices
  (``aux["shuffle_parts"]``) and the output rows' targets
  (``aux["position_vector"]``). A filter-only plan with a predicate and a
  stored key runs ``fused_scan_shuffle`` in place of ``predicate_bitmap``:
  its words are the filter and the survivors' pids the targets. Any other
  plan hashes its output key column with ``hash_partition``. One stable
  sort by ``(partition, target)`` makes each slice exactly the rows
  ``pid == target`` selects per partition, in the reference's row order.

Filter decisions: the reference's filter stage picks between gathering
survivors per partition and concatenating whole columns and masking once,
by the estimated selectivity against a threshold calibrated at import.
The port has one filter route, the words and then one gather over the
concatenated columns, which is the reference's ``"concat"`` branch; so it
has no ``filter_gather_threshold`` and no calibration, and it records
every batch the reference would record (a filtered batch that gathers
columns the predicate does not read) as ``"concat"``, with the
reference's ``est_selectivity``, ``n_parts`` and ``rows``, in
``obs.trace.filter_decision_channel()``.

Output dtypes follow the reference (int32 keys, f64 sums, int64 counts,
min/max in the column's type), so the bytes a pushdown ships are the
reference's.

With a result cache (``core.result_cache.ResultCache``) and the catalog
partitions, ``execute_batch_parts`` serves the cached partitions, runs the
misses as one smaller batch, fills the cache from their per-partition
results and returns everything in partition order: a partition's result
does not depend on which others share its batch. A containment serve
re-filters a cached superset with ``refilter``, the filter stage's
``predicate_bitmap`` words and gather.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cost import RequestCost
from repro_torch.core.plan import PushPlan, estimate_cost
from repro_torch.kernels import fused_scan_agg as fsa
from repro_torch.kernels import fused_scan_shuffle as fss
from repro_torch.kernels import hash_partition as hpk
from repro_torch.kernels import predicate_bitmap as pbk
from repro_torch.kernels.program import (Program, SplitProgram,
                                         compile_predicate)
from repro_torch.kernels.ref import words_from_uint32
from repro_torch.obs import trace as obs_trace
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc import operators as qops
from repro_torch.queryproc.table import ColumnTable, as_float64, gather
from repro_torch.storage.catalog import Partition


EXECUTOR_BATCHED = "batched"      # one fused device pass per (table, plan)
EXECUTOR_REFERENCE = "reference"  # plan.execute_push_plan per partition


def reset_filter_decisions() -> None:
    obs_trace.filter_decision_channel().clear()


def filter_decision_counts() -> Dict[str, int]:
    counts = obs_trace.filter_decision_channel().counts("branch")
    return {"gather": counts.get("gather", 0),
            "concat": counts.get("concat", 0)}


def _word_counts(lens: Sequence[int]) -> List[int]:
    return [-(-n // 32) for n in lens]


def partition_words(words: torch.Tensor, lens: Sequence[int]
                    ) -> List[torch.Tensor]:
    """Each partition's own packed words, cut from the words of the
    partitions' concatenation: bit for bit what packing the partition's
    mask alone gives. A partition that starts on a 32-row boundary is a
    slice of the words; the others are shifted across word boundaries
    (a funnel shift in int64) and their tail bits masked."""
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    n_words = _word_counts(lens)
    if all(s % 32 == 0 for s in starts):
        return [words[s // 32:s // 32 + nw] for s, nw in zip(starts, n_words)]
    dev = words.device
    w64 = torch.cat([words.to(torch.int64) & 0xFFFFFFFF,
                     torch.zeros(1, dtype=torch.int64, device=dev)])
    seg = torch.repeat_interleave(torch.arange(len(lens), device=dev),
                                  torch.as_tensor(n_words, device=dev))
    woff = torch.as_tensor(np.cumsum([0] + n_words[:-1]), device=dev)
    i = torch.arange(seg.shape[0], device=dev) - woff[seg]
    bit = torch.as_tensor(starts, device=dev)[seg] + 32 * i
    q, r = bit >> 5, bit & 31
    w = ((w64[q] >> r) | (w64[q + 1] << (32 - r))) & 0xFFFFFFFF
    valid = torch.clamp(torch.as_tensor(lens, device=dev)[seg] - 32 * i,
                        max=32)
    w &= (torch.ones_like(valid) << valid) - 1
    return list(torch.split(words_from_uint32(w), n_words))


def unpack_parts(words: Sequence[torch.Tensor], lens: Sequence[int]
                 ) -> torch.Tensor:
    """The row mask over the partitions' concatenation from each
    partition's own (ceil(n/32),) words: the inverse of
    ``partition_words``."""
    n_words = _word_counts(lens)
    for p, (w, nw) in enumerate(zip(words, n_words)):
        if w.dim() != 1 or w.shape[0] != nw:
            raise ValueError(f"partition {p}: {tuple(w.shape)} words for "
                             f"{lens[p]} rows, expected {nw}")
    total = int(sum(lens))
    allw = words[0] if len(words) == 1 else torch.cat(list(words))
    bits = qops.unpack_bitmap(allw, 32 * allw.shape[0])
    if all(n % 32 == 0 for n in lens[:-1]):
        return bits[:total]
    dev = bits.device
    seg = torch.repeat_interleave(torch.arange(len(lens), device=dev),
                                  torch.as_tensor(lens, device=dev))
    shift = torch.as_tensor(32 * np.cumsum([0] + n_words[:-1])
                            - np.cumsum([0] + list(lens[:-1])), device=dev)
    return bits[torch.arange(total, device=dev) + shift[seg]]


@dataclasses.dataclass
class CompiledPushPlan:
    """A PushPlan lowered once, with its plan-level invariants."""
    plan: PushPlan
    accessed: Tuple[str, ...]          # plan.accessed_columns()
    pred_cols: Tuple[str, ...]         # columns the predicate reads ((),
    #                                    when apply_bitmap replaces it)
    sel_fn: Optional[Callable]         # compiled selectivity estimator
    agg_spec: Dict[str, Tuple[str, str]]  # out -> (fn, col); {} if no agg
    having_sel_fn: Optional[Callable] = None  # the HAVING's estimator
    # kernel programs of the predicate and the HAVING filter, per tuple of
    # their columns' dtypes
    programs: Dict[tuple, Union[Program, SplitProgram]] = \
        dataclasses.field(default_factory=dict, repr=False)

    @property
    def minmax(self) -> bool:
        """The plan pushes a min or max aggregate."""
        return any(f in ("min", "max") for f, _ in self.agg_spec.values())

    def program(self, cols: Dict[str, torch.Tensor]
                ) -> Optional[Union[Program, SplitProgram]]:
        """The predicate's postfix program for these columns, compiled at
        the first batch whose columns have their dtypes (None when the
        plan evaluates no predicate)."""
        if not self.pred_cols:
            return None
        return self._program("predicate", self.plan.predicate,
                             self.pred_cols, cols)

    def having_program(self, cols: Dict[str, torch.Tensor]
                       ) -> Union[Program, SplitProgram]:
        """The HAVING filter's program over the partial aggregate's
        output columns."""
        names = tuple(sorted(ex.columns_of(self.plan.having)))
        return self._program("having", self.plan.having, names, cols)

    def _program(self, which: str, expr: ex.Expr, names: Tuple[str, ...],
                 cols: Dict[str, torch.Tensor]
                 ) -> Union[Program, SplitProgram]:
        dtypes = tuple(cols[c].dtype for c in names)
        key = (which,) + dtypes
        if key not in self.programs:
            self.programs[key] = compile_predicate(expr,
                                                   dict(zip(names, dtypes)))
        return self.programs[key]

    def raw_projection(self, data: ColumnTable) -> ColumnTable:
        """The pushback payload: the raw accessed-column projection of one
        partition (the paper's ``S_in``), a copy as if shipped, with the
        partition's column stats. Replaying the plan over it equals
        running it over the partition."""
        proj = data.select([c for c in self.accessed if c in data.cols])
        return ColumnTable({c: v.clone() for c, v in proj.cols.items()},
                           stats=proj._stats)

    def estimate_cost(self, part: Partition) -> RequestCost:
        return estimate_cost(self.plan, part, self.sel_fn, self.having_sel_fn)

    def execute(self, data: ColumnTable,
                bitmap: Optional[torch.Tensor] = None
                ) -> Tuple[ColumnTable, Dict]:
        """One partition's ``(result, aux)`` through the batch pass."""
        parts, aux = self.execute_batch_parts(
            [data], None if bitmap is None else [bitmap])
        return parts[0], aux[0]

    def execute_batch_parts(self, tables: Sequence[ColumnTable],
                            bitmaps: Optional[Sequence[torch.Tensor]] = None,
                            cache=None, parts: Optional[Sequence] = None
                            ) -> Tuple[List[ColumnTable], List[Dict]]:
        """(per-partition results, per-partition aux dicts) of one fused
        pass over ``tables``. ``bitmaps`` are the partitions' packed words
        for an ``apply_bitmap`` plan. An aux dict holds ``bitmap`` (int32
        words) for ``bitmap_only`` plans and ``shuffle_parts`` plus
        ``position_vector`` (int32) for ``shuffle`` plans. With ``cache``
        and ``parts`` (each table's catalog ``Partition``), cached
        partitions are served (their aux dict marked ``"cache"``) and only
        the misses run; ``apply_bitmap`` plans are never cached."""
        if cache is not None and parts is not None \
                and not self.plan.apply_bitmap:
            return self._run_batch_cached(tables, cache, parts)
        out, bounds, aux = self._run_batch(tables, bitmaps)
        return [ColumnTable({c: v[bounds[p]:bounds[p + 1]]
                             for c, v in out.cols.items()})
                for p in range(len(tables))], aux

    def _run_batch_cached(self, tables: Sequence[ColumnTable], cache,
                          parts: Sequence
                          ) -> Tuple[List[ColumnTable], List[Dict]]:
        """Serve the cached partitions, run the misses as one batch, fill
        the cache from their results; partition order is kept."""
        if len(parts) != len(tables):
            raise ValueError("one catalog partition per table")
        res: List[Optional[ColumnTable]] = [None] * len(tables)
        auxs: List[Dict] = [{} for _ in tables]
        miss: List[int] = []
        for i, part in enumerate(parts):
            hit = cache.serve(self, part)
            if hit is None:
                miss.append(i)
            else:
                res[i], auxs[i] = hit[0], hit[1]
        if miss:
            got, aux = self.execute_batch_parts([tables[i] for i in miss])
            for j, i in enumerate(miss):
                res[i], auxs[i] = got[j], aux[j]
                cache.put(self, parts[i], got[j], aux[j])
        return res, auxs

    def refilter(self, t: ColumnTable) -> ColumnTable:
        """The rows of ``t`` that pass this plan's predicate, in order: the
        filter stage (``predicate_bitmap`` words, then one gather) over a
        table that holds the predicate's columns, such as a cached
        looser-predicate result of the same partition."""
        words = pbk.predicate_words(self.program(t.cols), t.cols)
        return t.take(torch.nonzero(
            qops.unpack_bitmap(words, len(t))).flatten())

    def _record_filter(self, tables: Sequence[ColumnTable],
                       present: List[str], keep: Optional[torch.Tensor]
                       ) -> None:
        """The reference's filter decision for this batch, as ``"concat"``:
        recorded where a filtered batch gathers columns its predicate
        does not read. An ``apply_bitmap`` batch's selectivity is its
        words' exact share of kept rows."""
        plan = self.plan
        filtered = plan.apply_bitmap or plan.predicate is not None
        if not filtered or all(c in self.pred_cols for c in present):
            return
        rows = sum(len(t) for t in tables)
        if plan.apply_bitmap:
            est = float(keep.sum()) / rows if rows else 0.0
        else:
            est = float(self.sel_fn(tables[0].stats()))
        obs_trace.record_filter_decision(plan.table, est, "concat",
                                         len(tables), rows)

    def _run_batch(self, tables: Sequence[ColumnTable],
                   bitmaps: Optional[Sequence[torch.Tensor]]
                   ) -> Tuple[ColumnTable, List[int], List[Dict]]:
        """The fused pass: (merged output, per-partition row bounds,
        per-partition aux dicts)."""
        plan = self.plan
        lens = [len(t) for t in tables]
        n_parts = len(tables)
        present = [c for c in self.accessed if c in tables[0].cols]
        concatenated: Dict[str, torch.Tensor] = {}

        def concat(column: str) -> torch.Tensor:
            if column not in concatenated:
                concatenated[column] = (
                    tables[0].cols[column] if n_parts == 1
                    else torch.cat([t.cols[column] for t in tables]))
            return concatenated[column]

        # selection: words of the predicate, or the compute layer's
        words = pids = keep = None
        prog = self.program({c: tables[0].cols[c] for c in self.pred_cols})
        split = isinstance(prog, SplitProgram)
        if plan.apply_bitmap:
            if bitmaps is None or len(bitmaps) != n_parts:
                raise ValueError("an apply_bitmap plan needs one bitmap per "
                                 "partition")
            keep = unpack_parts(bitmaps, lens)
        elif prog is not None and (plan.agg is None or plan.bitmap_only
                                   or self.minmax or split):
            key = plan.shuffle[0] if plan.shuffle is not None else None
            if (plan.agg is None and key is not None and not split
                    and key in tables[0].cols):
                words, pids, _ = fss.fused_scan_shuffle(
                    prog, [concat(c) for c in prog.columns], concat(key),
                    plan.shuffle[1])
            else:
                words = pbk.predicate_words(
                    prog, {c: concat(c) for c in prog.columns})
            if plan.agg is None or self.minmax or split:
                keep = qops.unpack_bitmap(words, sum(lens))
        self._record_filter(tables, present, keep)

        part_of = None  # each output row's partition, where not contiguous
        if plan.agg is not None:
            out, part_of = self._agg_batch(
                lens, {c: concat(c) for c in present},
                None if keep is not None else prog, keep)
            if plan.having is not None:
                kept = qops.unpack_bitmap(pbk.predicate_words(
                    self.having_program(out.cols), out.cols), len(out))
                idx = torch.nonzero(kept).flatten()
                out, part_of = out.take(idx), part_of[idx]
        else:
            cols: Dict[str, torch.Tensor] = {}
            if keep is not None:
                idx = torch.nonzero(keep).flatten()
                # survivors before each partition's end -> output bounds
                ends = torch.as_tensor(np.cumsum(lens), device=idx.device)
                bounds = [0] + torch.searchsorted(idx, ends).tolist()
                cols = {c: gather(concat(c), idx) for c in present}
                if pids is not None:
                    pids = pids[idx]
            else:
                bounds = [0] + np.cumsum(lens).tolist()
                cols = {c: concat(c) for c in present}
            for name, incols, fn in plan.derive:
                cols[name] = fn(*[cols[c] for c in incols])
            out = ColumnTable({c: cols[c] for c in plan.columns if c in cols})

        if plan.top_k is not None:
            if part_of is None:
                part_of = _segments(bounds, out.device)
            idx = self._top_k_rows(out.cols[plan.top_k[0]], part_of, n_parts)
            out, part_of = out.take(idx), part_of[idx]
            if pids is not None:
                pids = pids[idx]
        if part_of is not None:
            bounds = torch.searchsorted(
                part_of, torch.arange(n_parts + 1,
                                      device=part_of.device)).tolist()

        aux: List[Dict] = [{} for _ in tables]
        if plan.bitmap_only and words is not None:
            for a, w in zip(aux, partition_words(words, lens)):
                a["bitmap"] = w
        if plan.shuffle is not None:
            self._shuffle_aux(out, bounds, pids, aux)
        return out, bounds, aux

    def _shuffle_aux(self, out: ColumnTable, bounds: List[int],
                     pids: Optional[torch.Tensor], aux: List[Dict]) -> None:
        """Per-partition target slices and position vectors of ``out``;
        ``pids`` are the output rows' targets when the filter computed
        them, else the output key column is hashed here."""
        key, n_t = self.plan.shuffle
        if pids is None:
            pids, _ = hpk.hash_partition(out.cols[key], n_t)
        for p, (a, pieces) in enumerate(zip(aux, slices_by_target(
                out, bounds, pids, n_t))):
            a["shuffle_parts"] = pieces
            a["position_vector"] = pids[bounds[p]:bounds[p + 1]]

    def _top_k_rows(self, v: torch.Tensor, part_of: torch.Tensor,
                    n_parts: int) -> torch.Tensor:
        """Indices of each partition's k best rows by ``v``, partition by
        partition, best first (``qops.rank_key``: NaN last), ties in row
        order."""
        _col, k, ascending = self.plan.top_k
        order = torch.sort(qops.rank_key(v, ascending), stable=True).indices
        order = order[torch.sort(part_of[order], stable=True).indices]
        seg = part_of[order]
        starts = torch.searchsorted(
            seg, torch.arange(n_parts + 1, device=seg.device))
        rank = torch.arange(seg.shape[0], device=seg.device) - starts[seg]
        return order[rank < k]

    def _agg_batch(self, lens: List[int], cols: Dict[str, torch.Tensor],
                   prog: Optional[Program], keep: Optional[torch.Tensor]
                   ) -> Tuple[ColumnTable, torch.Tensor]:
        """Partial aggregates per partition and each output row's
        partition. The kernel applies ``prog``; rows a ``keep`` mask drops
        (an ``apply_bitmap`` plan's, or the predicate's when min/max are
        pushed) are gathered out first."""
        plan = self.plan
        keys = plan.agg[0]
        n_parts = len(lens)
        dev = next(iter(cols.values())).device
        seg = _segments(np.cumsum([0] + lens), dev)
        if keep is not None:
            idx = torch.nonzero(keep).flatten()
            cols = {c: gather(v, idx) for c, v in cols.items()}
            seg = seg[idx]
        for name, incols, fn in plan.derive:
            cols[name] = fn(*[cols[c] for c in incols])
        ids, G, decode = qops.group_ids([cols[k] for k in keys], lead=seg,
                                        lead_size=n_parts)
        pcols = [cols[c] for c in prog.columns] if prog is not None else []
        # each summed column once, read at its stored width; all of them
        # (Q1's four) in one launch
        summed = list(dict.fromkeys(col for fn, col in self.agg_spec.values()
                                    if fn in ("sum", "mean")))
        vals = [cols[c] for c in summed]
        rows: List[torch.Tensor] = []
        for i in range(0, max(len(vals), 1), fsa.MAX_VALUES):
            s, counts = fsa.fused_scan_agg(prog, pcols, ids,
                                           vals[i:i + fsa.MAX_VALUES], G)
            rows += list(s)
        by_col = dict(zip(summed, rows))
        red = {}  # out -> per-group sum, min or max
        for name, (fn, col) in self.agg_spec.items():
            if fn in ("sum", "mean"):
                red[name] = by_col[col]
            elif fn in ("min", "max"):
                red[name] = qops.reduce_min_max(cols[col], fn, ids, G)
        if not keys:
            return (self._keyless(red, counts, cols),
                    torch.arange(n_parts, device=dev))
        nz = torch.nonzero(counts).flatten()
        part_of, key_vals = decode(nz)
        out = dict(zip(keys, key_vals))
        cnt = counts[nz]
        for name, (fn, _col) in self.agg_spec.items():
            out[name] = (cnt if fn == "count"
                         else red[name][nz] / torch.clamp(cnt, min=1)
                         if fn == "mean" else gather(red[name], nz))
        return ColumnTable(out), part_of

    def _keyless(self, red: Dict[str, torch.Tensor], counts: torch.Tensor,
                 cols: Dict[str, torch.Tensor]) -> ColumnTable:
        """One row per partition, in the dtypes of ``np.sum`` and
        ``np.mean``: a float column's sum and mean in its own dtype, a sum
        of a bool or integer column as int64 (uint64 for an unsigned one;
        the kernel's f64 sum, so exact while a partition's sum stays below
        2**53).
        A partition with no kept rows gets the reference's float64 ``0.``
        placeholder in every column, which makes every column float64, as
        numpy's concatenation of the partitions' results does."""
        empty = counts == 0
        any_empty = bool(empty.any())
        out = {}
        for name, (fn, col) in self.agg_spec.items():
            v = (counts if fn == "count"
                 else red[name] / torch.clamp(counts, min=1) if fn == "mean"
                 else red[name])
            if fn in ("sum", "mean") and cols[col].is_floating_point():
                v = v.to(cols[col].dtype)  # np.sum and np.mean keep it
            elif fn == "sum":
                v = v.to(torch.int64)
                if cols[col].dtype in qops.UNSIGNED:
                    v = v.view(torch.uint64)
            if any_empty:
                v = torch.where(empty, torch.zeros((), dtype=torch.float64,
                                                   device=v.device),
                                as_float64(v))
            out[name] = v
        return ColumnTable(out)


def slices_by_target(out: ColumnTable, bounds: Sequence[int],
                     pids: torch.Tensor, n_t: int) -> List[List[ColumnTable]]:
    """Each segment of ``out`` (rows cut at ``bounds``) split into its
    ``n_t`` per-target slices: one stable sort by ``(segment, target)``,
    so each slice is exactly the rows ``pids == target`` selects in the
    segment, in row order."""
    n_parts = len(bounds) - 1
    dev = pids.device
    seg = _segments(bounds, dev)
    code, order = torch.sort(seg * n_t + pids, stable=True)
    sorted_cols = {c: gather(v, order) for c, v in out.cols.items()}
    cuts = torch.searchsorted(
        code, torch.arange(n_parts * n_t + 1, device=dev)).tolist()
    return [[ColumnTable({c: v[cuts[p * n_t + i]:cuts[p * n_t + i + 1]]
                          for c, v in sorted_cols.items()})
             for i in range(n_t)] for p in range(n_parts)]


def _segments(bounds: Sequence[int], device) -> torch.Tensor:
    """Each row's segment, for rows cut at ``bounds`` (n + 1 offsets)."""
    sizes = torch.as_tensor(np.diff(bounds), device=device)
    return torch.repeat_interleave(
        torch.arange(sizes.shape[0], device=device), sizes)


AGG_FNS = ("sum", "count", "mean", "min", "max")


def compile_push_plan(plan: PushPlan) -> CompiledPushPlan:
    """Lower a PushPlan once per (query, table)."""
    if not plan.columns and plan.agg is None:
        raise ValueError("plans must declare output columns")
    agg_spec = ({o: (f, c) for o, f, c in plan.agg[1]}
                if plan.agg is not None else {})
    bad = sorted({f for f, _ in agg_spec.values() if f not in AGG_FNS})
    if bad:
        raise ValueError(f"unknown aggregate functions {bad}")
    return CompiledPushPlan(
        plan=plan, accessed=plan.accessed_columns(),
        pred_cols=(tuple(sorted(ex.columns_of(plan.predicate)))
                   if plan.predicate is not None and not plan.apply_bitmap
                   else ()),
        sel_fn=(ex.compile_selectivity(plan.predicate)
                if plan.predicate is not None else None),
        agg_spec=agg_spec,
        having_sel_fn=(ex.compile_selectivity(plan.having)
                       if plan.having is not None else None))
