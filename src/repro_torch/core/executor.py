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
- Aggregating plans: derived columns are computed over every row, rows
  get dense group ids ``(partition, keys...)`` in lexicographic order —
  the order the reference's ``(pid, keys...)`` lexsort gives — and one
  ``fused_scan_agg`` launch for all the summed columns (up to its
  ``MAX_VALUES``; a counts-only plan takes one launch with none) applies
  the predicate and adds the kept rows into their groups in f64. Groups
  no row kept are dropped. Keyless plans group by partition alone and keep the
  reference's one row per partition with its ``[0.]`` placeholder for a
  partition with no rows.
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

Output dtypes follow the reference (int32 keys, f64 sums, int64 counts),
so the bytes a pushdown ships are the reference's. Plans with ``top_k``
or ``having`` and pushed min/max aggregates are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cost import RequestCost
from repro_torch.core.plan import PushPlan, estimate_cost
from repro_torch.kernels import fused_scan_agg as fsa
from repro_torch.kernels import fused_scan_shuffle as fss
from repro_torch.kernels import hash_partition as hpk
from repro_torch.kernels import predicate_bitmap as pbk
from repro_torch.kernels.program import Program, compile_program
from repro_torch.kernels.ref import words_from_uint32
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc import operators as qops
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import Partition


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
    # the predicate's kernel program per tuple of predicate-column dtypes
    programs: Dict[tuple, Program] = dataclasses.field(default_factory=dict,
                                                       repr=False)

    def program(self, cols: Dict[str, torch.Tensor]) -> Optional[Program]:
        """The predicate's postfix program for these columns, compiled at
        the first batch whose columns have their dtypes (None when the
        plan evaluates no predicate)."""
        if not self.pred_cols:
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

    def execute_batch_parts(self, tables: Sequence[ColumnTable],
                            bitmaps: Optional[Sequence[torch.Tensor]] = None
                            ) -> Tuple[List[ColumnTable], List[Dict]]:
        """(per-partition results, per-partition aux dicts) of one fused
        pass over ``tables``. ``bitmaps`` are the partitions' packed words
        for an ``apply_bitmap`` plan. An aux dict holds ``bitmap`` (int32
        words) for ``bitmap_only`` plans and ``shuffle_parts`` plus
        ``position_vector`` (int32) for ``shuffle`` plans."""
        out, bounds, aux = self._run_batch(tables, bitmaps)
        return [ColumnTable({c: v[bounds[p]:bounds[p + 1]]
                             for c, v in out.cols.items()})
                for p in range(len(tables))], aux

    def _run_batch(self, tables: Sequence[ColumnTable],
                   bitmaps: Optional[Sequence[torch.Tensor]]
                   ) -> Tuple[ColumnTable, List[int], List[Dict]]:
        """The fused pass: (merged output, per-partition row bounds,
        per-partition aux dicts)."""
        plan = self.plan
        lens = [len(t) for t in tables]
        present = [c for c in self.accessed if c in tables[0].cols]
        concatenated: Dict[str, torch.Tensor] = {}

        def concat(column: str) -> torch.Tensor:
            if column not in concatenated:
                concatenated[column] = (
                    tables[0].cols[column] if len(tables) == 1
                    else torch.cat([t.cols[column] for t in tables]))
            return concatenated[column]

        # selection: words of the predicate, or the compute layer's
        words = pids = keep = None
        prog = self.program({c: tables[0].cols[c] for c in self.pred_cols})
        if plan.apply_bitmap:
            if bitmaps is None or len(bitmaps) != len(tables):
                raise ValueError("an apply_bitmap plan needs one bitmap per "
                                 "partition")
            keep = unpack_parts(bitmaps, lens)
        elif prog is not None and (plan.agg is None or plan.bitmap_only):
            pcols = [concat(c) for c in prog.columns]
            key = plan.shuffle[0] if plan.shuffle is not None else None
            if (plan.agg is None and key is not None
                    and key in tables[0].cols):
                words, pids, _ = fss.fused_scan_shuffle(
                    prog, pcols, concat(key), plan.shuffle[1])
            else:
                words = pbk.predicate_bitmap(prog, pcols)
            if plan.agg is None:
                keep = qops.unpack_bitmap(words, sum(lens))

        if plan.agg is not None:
            out, bounds = self._agg_batch(lens, {c: concat(c) for c in present},
                                          prog, keep)
        else:
            cols: Dict[str, torch.Tensor] = {}
            if keep is not None:
                idx = torch.nonzero(keep).flatten()
                # survivors before each partition's end -> output bounds
                ends = torch.as_tensor(np.cumsum(lens), device=idx.device)
                bounds = [0] + torch.searchsorted(idx, ends).tolist()
                cols = {c: concat(c)[idx] for c in present}
                if pids is not None:
                    pids = pids[idx]
            else:
                bounds = [0] + np.cumsum(lens).tolist()
                cols = {c: concat(c) for c in present}
            for name, incols, fn in plan.derive:
                cols[name] = fn(*[cols[c] for c in incols])
            out = ColumnTable({c: cols[c] for c in plan.columns if c in cols})

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
        n_parts = len(aux)
        dev = pids.device
        seg = torch.repeat_interleave(torch.arange(n_parts, device=dev),
                                      torch.as_tensor(np.diff(bounds),
                                                      device=dev))
        code, order = torch.sort(seg * n_t + pids, stable=True)
        sorted_cols = {c: v[order] for c, v in out.cols.items()}
        cuts = torch.searchsorted(
            code, torch.arange(n_parts * n_t + 1, device=dev)).tolist()
        for p, a in enumerate(aux):
            a["shuffle_parts"] = [
                ColumnTable({c: v[cuts[p * n_t + i]:cuts[p * n_t + i + 1]]
                             for c, v in sorted_cols.items()})
                for i in range(n_t)]
            a["position_vector"] = pids[bounds[p]:bounds[p + 1]]

    def _agg_batch(self, lens: List[int], cols: Dict[str, torch.Tensor],
                   prog: Optional[Program], keep: Optional[torch.Tensor]
                   ) -> Tuple[ColumnTable, List[int]]:
        """Partial aggregates per partition. The kernel applies ``prog``;
        rows an ``apply_bitmap`` plan's ``keep`` drops are gathered out
        first."""
        plan = self.plan
        keys = plan.agg[0]
        n_parts = len(lens)
        dev = next(iter(cols.values())).device
        seg = torch.repeat_interleave(
            torch.arange(n_parts, device=dev),
            torch.as_tensor(lens, device=dev))
        if keep is not None:
            idx = torch.nonzero(keep).flatten()
            cols = {c: v[idx] for c, v in cols.items()}
            seg = seg[idx]
        for name, incols, fn in plan.derive:
            cols[name] = fn(*[cols[c] for c in incols])
        ids, G, decode = qops.group_ids([cols[k] for k in keys], lead=seg,
                                        lead_size=n_parts)
        pcols = [cols[c] for c in prog.columns] if prog is not None else []
        # each summed column once; all of them (Q1's four) in one launch
        summed = list(dict.fromkeys(col for fn, col in self.agg_spec.values()
                                    if fn in ("sum", "mean")))
        vals = [v if v.dtype in fsa.VALUE_DTYPES else v.to(torch.float64)
                for v in (cols[c] for c in summed)]
        rows: List[torch.Tensor] = []
        for i in range(0, max(len(vals), 1), fsa.MAX_VALUES):
            s, counts = fsa.fused_scan_agg(prog, pcols, ids,
                                           vals[i:i + fsa.MAX_VALUES], G)
            rows += list(s)
        by_col = dict(zip(summed, rows))
        sums = {name: by_col[col] for name, (fn, col) in self.agg_spec.items()
                if fn in ("sum", "mean")}
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


_UNSUPPORTED = ("top_k", "having")


def compile_push_plan(plan: PushPlan) -> CompiledPushPlan:
    """Lower a PushPlan once per (query, table)."""
    used = [f for f in _UNSUPPORTED if getattr(plan, f) not in (None, False)]
    if used:
        raise NotImplementedError(f"PushPlan {', '.join(used)} is not "
                                  f"ported yet")
    if not plan.columns and plan.agg is None:
        raise ValueError("plans must declare output columns")
    agg_spec = ({o: (f, c) for o, f, c in plan.agg[1]}
                if plan.agg is not None else {})
    if any(f not in ("sum", "count", "mean") for f, _ in agg_spec.values()):
        raise NotImplementedError("pushed min/max aggregates are not "
                                  "ported yet")
    return CompiledPushPlan(
        plan=plan, accessed=plan.accessed_columns(),
        pred_cols=(tuple(sorted(ex.columns_of(plan.predicate)))
                   if plan.predicate is not None and not plan.apply_bitmap
                   else ()),
        sel_fn=(ex.compile_selectivity(plan.predicate)
                if plan.predicate is not None else None),
        agg_spec=agg_spec)
