"""Relational operators over device ``ColumnTable``s.

Port of ``repro.queryproc.operators``, trimmed to what the port runs.
Grouped sums, counts and means go through the ``grouped_agg`` kernel;
min/max use ``scatter_reduce`` (the JAX package has no kernel for them).
Of the §4.2 operators, ``selection_bitmap`` runs the ``predicate_bitmap``
kernel (the compute layer builds Fig 4's words with it); the hash
partition, ``shuffle_partition`` and the position vector are plain torch,
the oracles the executor's shuffle kernels are held to.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import grouped_agg as gak
from repro_torch.kernels import predicate_bitmap as pbk
from repro_torch.kernels.program import program_for
from repro_torch.kernels.ref import (hash_partition_ids, pack_bitmap,  # noqa: F401
                                     unpack_bitmap)
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc.table import ColumnTable

# group codes above this many groups are compressed with a sort (unique)
# instead of being used as dense ids directly
DENSE_GROUP_LIMIT = 1 << 22


def filter_table(t: ColumnTable, pred: ex.Expr) -> ColumnTable:
    return t.filter(ex.compile_expr(pred)(t.cols))


def selection_bitmap(t: ColumnTable, pred: ex.Expr) -> torch.Tensor:
    """Packed selection bitmap: int32 words holding uint32 bits, least
    significant bit first."""
    return pbk.predicate_words(program_for(pred, t.cols), t.cols)


def apply_bitmap(t: ColumnTable, words: torch.Tensor) -> ColumnTable:
    return t.filter(unpack_bitmap(words, len(t)))


def shuffle_partition(t: ColumnTable, key: str, n_parts: int
                      ) -> List[ColumnTable]:
    pid = hash_partition_ids(t.cols[key], n_parts)
    return [t.filter(pid == i) for i in range(n_parts)]


def position_vector(t: ColumnTable, key: str, n_parts: int) -> torch.Tensor:
    """Per-row destination (§4.2 cached-data interop): log2(n) bits a row
    would do; int32 here, as in the JAX package."""
    return hash_partition_ids(t.cols[key], n_parts)


def group_ids(key_arrs: Sequence[torch.Tensor],
              lead: Optional[torch.Tensor] = None, lead_size: int = 1
              ) -> Tuple[torch.Tensor, int, Callable]:
    """Dense group ids of the rows, ordered lexicographically by
    ``(lead, keys...)`` — the order of numpy's ``np.unique`` over a record
    array and of the batch executor's ``(partition, keys...)`` lexsort.

    Returns ``(ids (R,) int32, G, decode)``; ``decode(g)`` maps group ids
    to ``(lead values, [key values...])``. Integer keys are coded by their
    value range (no sort); float keys by a sorted ``unique``. Ids may name
    groups no row has (the caller drops zero-count groups); when the code
    space exceeds ``DENSE_GROUP_LIMIT`` it is compressed with one sort.
    Before a key would take the running code to 2**62, the code is
    compressed to the ranks of its distinct values (``unique`` keeps their
    order), and a key whose own range is that wide is coded by ``unique``
    as a float key is; ``decode`` undoes every step.
    """
    n = key_arrs[0].shape[0] if key_arrs else lead.shape[0]
    dev = key_arrs[0].device if key_arrs else lead.device
    code = (lead.to(torch.int64) if lead is not None
            else torch.zeros(n, dtype=torch.int64, device=dev))
    # coding steps: (span, lo or uniques, dtype) per key, or a tensor of
    # the code's distinct values where the code was compressed
    steps: List = []
    total = lead_size
    for a in key_arrs:
        if not a.is_floating_point():
            lo, hi = (int(v) for v in torch.aminmax(a)) if n else (0, 0)
            span, base = hi - lo + 1, lo
        if a.is_floating_point() or span >= 2 ** 62 // max(1, n):
            u, inv = torch.unique(a, sorted=True, return_inverse=True)
            span, base = max(1, u.numel()), u
        else:
            inv = a.to(torch.int64) - lo
        if total * span >= 2 ** 62:
            uniq, code = torch.unique(code, sorted=True, return_inverse=True)
            steps.append(uniq)
            total = max(1, uniq.numel())
        total *= span
        code = code * span + inv
        steps.append((span, base, a.dtype))
    uniq = None
    if total > DENSE_GROUP_LIMIT:
        uniq, code = torch.unique(code, sorted=True, return_inverse=True)
    G = total if uniq is None else uniq.numel()
    if G >= 2 ** 31:
        raise NotImplementedError("more than 2**31 groups")

    def decode(g: torch.Tensor):
        c = g.to(torch.int64) if uniq is None else uniq[g]
        keys = []
        for step in reversed(steps):
            if isinstance(step, torch.Tensor):
                c = step[c]
                continue
            span, base, dtype = step
            k = c % span
            c = c // span
            keys.append(base[k] if isinstance(base, torch.Tensor)
                        else (k + base).to(dtype))
        return c, keys[::-1]

    return code.to(torch.int32), G, decode


def _keyless(fn: str, arr: torch.Tensor) -> torch.Tensor:
    if fn == "sum":
        return arr.sum()
    if fn == "count":
        return torch.tensor(arr.shape[0], dtype=torch.int64, device=arr.device)
    if fn == "mean":
        return (arr if arr.is_floating_point() else arr.to(torch.float64)).mean()
    return arr.amin() if fn == "min" else arr.amax()


def grouped_agg(t: ColumnTable, keys: Sequence[str],
                aggs: Dict[str, Tuple[str, str]]) -> ColumnTable:
    """aggs: out_name -> (func, col). func 'count' ignores col."""
    if not keys:
        out = {}
        for name, (fn, col) in aggs.items():
            arr = t.cols[col] if col else next(iter(t.cols.values()))
            out[name] = (_keyless(fn, arr).reshape(1) if len(t) else
                         torch.zeros(1, dtype=torch.float64, device=arr.device))
        return ColumnTable(out)
    ids, G, decode = group_ids([t.cols[k] for k in keys])
    sums: Dict[str, torch.Tensor] = {}
    counts = None
    for name, (fn, col) in aggs.items():
        if fn in ("sum", "mean"):
            sums[name], counts = gak.grouped_agg(
                ids, t.cols[col].to(torch.float64), G)
    if counts is None:
        _, counts = gak.grouped_agg(ids, None, G)
    nz = torch.nonzero(counts).flatten()  # the groups some row has
    counts = counts[nz]
    _, key_vals = decode(nz)
    out = dict(zip(keys, key_vals))
    for name, (fn, col) in aggs.items():
        if fn == "count":
            out[name] = counts
        elif fn == "sum":
            # numpy's bincount of no rows is int64 even with weights, so
            # the reference's keyed sum over an empty table is int64
            out[name] = sums[name][nz] if len(t) else \
                sums[name][nz].to(torch.int64)
        elif fn == "mean":
            out[name] = sums[name][nz] / torch.clamp(counts, min=1)
        else:
            v = t.cols[col]
            red = torch.empty(G, dtype=v.dtype, device=v.device).scatter_reduce_(
                0, ids.to(torch.int64), v, "amin" if fn == "min" else "amax",
                include_self=False)
            out[name] = red[nz]
    return ColumnTable(out)


def top_k(t: ColumnTable, col: str, k: int, ascending: bool = False
          ) -> ColumnTable:
    """The k best rows by ``col``, best first; ties keep row order."""
    v = t.cols[col]
    k = min(k, len(v))
    order = torch.sort(v, descending=not ascending, stable=True).indices[:k]
    return t.take(order)


def sort_table(t: ColumnTable, cols: Sequence[str], ascending: bool = True
               ) -> ColumnTable:
    """Lexicographic sort by ``cols`` (first column primary), as
    ``np.lexsort``: one stable sort per column, last column first."""
    order = torch.arange(len(t), device=t.device)
    for c in reversed(list(cols)):
        order = order[torch.sort(t.cols[c][order], stable=True).indices]
    return t.take(order if ascending else order.flip(0))


def hash_join(left: ColumnTable, right: ColumnTable, lkey: str, rkey: str
              ) -> ColumnTable:
    """Inner equi-join: stable argsort of the right keys + searchsorted,
    left rows in order, each with its matches in right-row order."""
    lv, rv = left.cols[lkey], right.cols[rkey]
    dt = torch.promote_types(lv.dtype, rv.dtype)
    rv_sorted, r_order = torch.sort(rv.to(dt), stable=True)
    lv = lv.to(dt)
    lo = torch.searchsorted(rv_sorted, lv)
    counts = torch.searchsorted(rv_sorted, lv, right=True) - lo
    l_idx = torch.repeat_interleave(
        torch.arange(len(lv), device=lv.device), counts)
    offs = torch.cumsum(counts, 0) - counts
    r_idx = r_order[torch.arange(len(l_idx), device=lv.device)
                    - torch.repeat_interleave(offs - lo, counts)]
    out = {k: v[l_idx] for k, v in left.cols.items()}
    for k, v in right.cols.items():
        if k != rkey or lkey != rkey:
            out[k if k not in out else f"r_{k}"] = v[r_idx]
    return ColumnTable(out)

