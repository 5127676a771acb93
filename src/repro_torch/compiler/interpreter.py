"""Generic residual interpreter over ``queryproc/operators.py``.

Port of ``repro.compiler.interpreter``: the splitter's residual IR is
evaluated bottom-up against the merged pushdown results
(``Dict[table, ColumnTable]`` of device tensors), each node dispatching to
the port's operator (grouped aggregates through the ``grouped_agg``
kernel). One interpreter, fifteen queries.

Residual Filter predicates are lowered once per node (the engine evaluates
the same residual for every execution mode and repeat), and shared
subtrees run once per evaluation (Q17 joins its own join output back).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Tuple

from repro_torch.compiler import ir
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc import operators as ops
from repro_torch.queryproc.table import ColumnTable

_PRED_CACHE: "OrderedDict[int, Tuple[ir.Filter, Callable]]" = OrderedDict()
_PRED_CACHE_CAP = 4096   # bounded: a query has a handful of these


def _compiled_pred(node: ir.Filter) -> Callable:
    """Compile-once cache for residual Filter predicates, keyed by node
    identity (the node itself is retained, so its id cannot be reused);
    at capacity the least recently used entry is evicted."""
    hit = _PRED_CACHE.get(id(node))
    if hit is not None and hit[0] is node:
        _PRED_CACHE.move_to_end(id(node))
        return hit[1]
    fn = ex.compile_expr(node.predicate)
    _PRED_CACHE[id(node)] = (node, fn)
    _PRED_CACHE.move_to_end(id(node))
    while len(_PRED_CACHE) > _PRED_CACHE_CAP:
        _PRED_CACHE.popitem(last=False)
    return fn


def run(node: ir.Node, merged: Dict[str, ColumnTable]) -> ColumnTable:
    """Evaluate a residual plan against the merged pushdown results.
    Shared subtrees (DAGs) are evaluated once via an id-keyed memo."""
    return _run(node, merged, {})


def _run(node: ir.Node, merged: Dict[str, ColumnTable],
         memo: Dict[int, ColumnTable]) -> ColumnTable:
    if id(node) in memo:
        return memo[id(node)]
    out = _eval(node, merged, memo)
    memo[id(node)] = out
    return out


def _eval(node: ir.Node, merged: Dict[str, ColumnTable],
          memo: Dict[int, ColumnTable]) -> ColumnTable:
    def run(n):  # noqa: A001 — keep the recursive body readable
        return _run(n, merged, memo)

    if isinstance(node, (ir.Merged, ir.Scan)):
        return merged[node.table]
    if isinstance(node, ir.Filter):
        t = run(node.child)
        return t.filter(_compiled_pred(node)(t.cols))
    if isinstance(node, ir.Project):
        t = run(node.child)
        return t.select([c for c in node.columns if c in t.cols])
    if isinstance(node, ir.Map):
        t = run(node.child)
        cols = dict(t.cols)
        for name, incols, fn in node.derives:
            cols[name] = fn(*[cols[c] for c in incols])
        return ColumnTable(cols)
    if isinstance(node, ir.Aggregate):
        return ops.grouped_agg(run(node.child), list(node.keys),
                               {out: (fn, col) for out, fn, col in node.aggs})
    if isinstance(node, ir.Join):
        return ops.hash_join(run(node.left), run(node.right), node.lkey,
                             node.rkey)
    if isinstance(node, ir.SemiJoin):
        left, right = run(node.left), run(node.right)
        mask = ops.isin(left.cols[node.lkey], right.cols[node.rkey])
        return left.filter(~mask if node.anti else mask)
    if isinstance(node, ir.TopK):
        return ops.top_k(run(node.child), node.col, node.k, node.ascending)
    if isinstance(node, ir.Sort):
        return ops.sort_table(run(node.child), list(node.columns),
                              ascending=node.ascending)
    if isinstance(node, ir.Shuffle):  # redistribution marker: row-preserving
        return run(node.child)
    if isinstance(node, ir.PyOp):
        return node.fn(*[run(c) for c in node.children])
    raise TypeError(f"unknown IR node: {node!r}")
