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

import numpy as np
import torch

from repro_torch.kernels import grouped_agg as gak
from repro_torch.kernels import join_expand as jek
from repro_torch.kernels import predicate_bitmap as pbk
from repro_torch.kernels.program import program_for
from repro_torch.kernels.ref import (hash_partition_ids, pack_bitmap,  # noqa: F401
                                     unpack_bitmap)
from repro_torch.obs.metrics import get_metrics
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc.table import (NP_OF, ColumnTable, as_float64,
                                         as_int64, float_key, from_key,
                                         gather, sort_key)

UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
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
    to ``(lead values, [key values...])``, each key in its stored dtype.
    Bool and integer keys are coded by the range of their ``sort_key``
    (no sort); float keys by a sorted ``unique``. Ids may name groups no
    row has (the caller drops zero-count groups); when the code space
    exceeds ``DENSE_GROUP_LIMIT`` it is compressed with one sort.
    Before a key would take the running code to 2**62, the code is
    compressed to the ranks of its distinct values (``unique`` keeps their
    order), and a key whose own range is that wide (a uint64 or int64 one)
    is coded by ``unique`` as a float key is; ``decode`` undoes every step.
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
        k = a if a.is_floating_point() else sort_key(a)
        if not a.is_floating_point():
            lo, hi = (int(v) for v in torch.aminmax(k)) if n else (0, 0)
            span, base = hi - lo + 1, lo
        if a.is_floating_point() or span >= 2 ** 62 // max(1, n):
            u, inv = torch.unique(k, sorted=True, return_inverse=True)
            span, base = max(1, u.numel()), u
        else:
            inv = k - lo
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
            k = base[k] if isinstance(base, torch.Tensor) else k + base
            keys.append(k if dtype.is_floating_point else from_key(k, dtype))
        return c, keys[::-1]

    return code.to(torch.int32), G, decode


def keyless_sum(arr: torch.Tensor) -> torch.Tensor:
    """``np.sum``: a float column in its own dtype, an unsigned one into
    uint64, bool and signed ones into int64 (both wrap modulo 2**64)."""
    if arr.is_floating_point():
        return arr.sum()
    if arr.dtype == torch.uint64:
        return arr.view(torch.int64).sum().view(torch.uint64)
    s = as_int64(arr).sum()
    return s.view(torch.uint64) if arr.dtype in UNSIGNED else s


def reduce_min_max(v: torch.Tensor, fn: str, ids: Optional[torch.Tensor]
                   = None, G: int = 1) -> torch.Tensor:
    """The min or max of ``v`` (``fn``), per group of ``ids`` in [0, G)
    (every group must have a row) or of all rows. Floats reduce as they
    are (NaN wins, as in numpy's ``minimum``); bool and integer columns
    through their ``sort_key``, which torch reduces on every device."""
    k = v if v.is_floating_point() else sort_key(v)
    red = "amin" if fn == "min" else "amax"
    if ids is None:
        out = k.amin() if fn == "min" else k.amax()
    else:
        out = torch.empty(G, dtype=k.dtype, device=k.device).scatter_reduce_(
            0, ids.to(torch.int64), k, red, include_self=False)
    return out if v.is_floating_point() else from_key(out, v.dtype)


def _keyless(fn: str, arr: torch.Tensor) -> torch.Tensor:
    if fn == "sum":
        return keyless_sum(arr)
    if fn == "count":
        return torch.tensor(arr.shape[0], dtype=torch.int64, device=arr.device)
    if fn == "mean":
        return (arr if arr.is_floating_point() else as_float64(arr)).mean()
    return reduce_min_max(arr, fn)


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
            sums[name], counts = gak.grouped_agg(ids, t.cols[col], G)
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
            out[name] = gather(reduce_min_max(t.cols[col], fn, ids, G), nz)
    return ColumnTable(out)


def rank_key(v: torch.Tensor, ascending: bool) -> torch.Tensor:
    """int64 keys whose ascending order is the reference's ``top_k`` order:
    ``v``, or numpy's ``-v`` for descending (which wraps an unsigned
    column, and keeps NaN last either way)."""
    if ascending:
        return sort_key(v)
    if v.dtype == torch.bool:
        raise TypeError("numpy has no negative of a bool column")
    if v.is_floating_point():
        return sort_key(-v)
    if v.dtype == torch.uint64:
        return (-v.view(torch.int64)) ^ -2 ** 63
    bits = v.element_size() * 8
    neg = (-as_int64(v)) & ((1 << bits) - 1) if bits < 64 else -v
    if v.dtype in UNSIGNED or bits == 64:
        return neg
    return torch.where(neg >= 1 << (bits - 1), neg - (1 << bits), neg)


def top_k(t: ColumnTable, col: str, k: int, ascending: bool = False
          ) -> ColumnTable:
    """The k best rows by ``col``, best first, NaN last; ties keep row
    order."""
    key = rank_key(t.cols[col], ascending)
    k = min(k, len(key))
    return t.take(torch.sort(key, stable=True).indices[:k])


def sort_table(t: ColumnTable, cols: Sequence[str], ascending: bool = True
               ) -> ColumnTable:
    """Lexicographic sort by ``cols`` (first column primary), as
    ``np.lexsort``: one stable sort per column, last column first, NaN
    last."""
    order = torch.arange(len(t), device=t.device)
    for c in reversed(list(cols)):
        order = order[torch.sort(sort_key(t.cols[c])[order],
                                 stable=True).indices]
    return t.take(order if ascending else order.flip(0))


def key_in(v: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """``sort_key`` of ``v`` cast to a common numpy dtype: keys of two
    columns in the same dtype compare as numpy compares their values."""
    if dtype.kind == "f":
        return float_key(as_float64(v))
    if dtype == np.uint64:
        return (v.view(torch.int64) if v.dtype == torch.uint64
                else as_int64(v)) ^ -2 ** 63
    return as_int64(v)


def hash_join(left: ColumnTable, right: ColumnTable, lkey: str, rkey: str
              ) -> ColumnTable:
    """Inner equi-join as numpy's: a stable argsort of the right keys, then
    each left key's matches among them in the two keys' common dtype (int32
    against uint64 meets in float64), NaN matching NaN; left rows in order,
    each with its matches in right-key order. The pairs come from
    ``kernels.join_expand.join_pairs`` (one host wait); the counters
    ``join.probe_rows`` and ``join.out_rows`` add the left rows and the
    pairs."""
    lv, rv = left.cols[lkey], right.cols[rkey]
    common = np.result_type(NP_OF[lv.dtype], NP_OF[rv.dtype])
    r_order = torch.sort(sort_key(rv), stable=True).indices
    rv_sorted = key_in(gather(rv, r_order), common)
    l_idx, r_idx = jek.join_pairs(rv_sorted.contiguous(), r_order,
                                  key_in(lv, common).contiguous())
    m = get_metrics()
    m.counter("join.probe_rows").inc(len(lv))
    m.counter("join.out_rows").inc(len(l_idx))
    out = {k: gather(v, l_idx) for k, v in left.cols.items()}
    for k, v in right.cols.items():
        if k != rkey or lkey != rkey:
            out[k if k not in out else f"r_{k}"] = gather(v, r_idx)
    return ColumnTable(out)


def isin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.isin(a, b)`` of two columns: exact membership for two integer
    columns (whatever their signedness), equality in the common dtype
    otherwise."""
    na, nb = np.dtype(NP_OF[a.dtype]), np.dtype(NP_OF[b.dtype])
    if na.kind in "biu" and nb.kind in "biu" and np.uint64 in (na, nb) \
            and "i" in (na.kind, nb.kind):
        # a signed value below 0 equals no uint64 one
        keep_a = (a >= 0) if na.kind == "i" else None
        b = gather(b, b >= 0) if nb.kind == "i" else b
        hit = torch.isin(key_in(a, np.dtype(np.uint64)),
                         key_in(b, np.dtype(np.uint64)))
        return hit & keep_a if keep_a is not None else hit
    common = np.result_type(na, nb)
    return torch.isin(key_in(a, common), key_in(b, common))
