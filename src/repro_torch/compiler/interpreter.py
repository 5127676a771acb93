"""Generic residual interpreter over ``queryproc/operators.py``.

Port of ``repro.compiler.interpreter``: the splitter's residual IR is
evaluated bottom-up against the merged pushdown results
(``Dict[table, ColumnTable]`` of device tensors), each node dispatching to
the port's operator (grouped aggregates through the ``grouped_agg``
kernel). One interpreter, fifteen queries.

Residual Filter predicates are lowered once per node (the engine evaluates
the same residual for every execution mode and repeat), and shared
subtrees run once per evaluation (Q17 joins its own join output back).
Traced, each operator that does work (filter, map, aggregate, join,
semi-join, top-k, sort) runs under its own ``op.<kind>`` span (cat
``residual``, ``rows_in``/``rows_out`` from the shapes, no sync) after
its inputs are evaluated.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Tuple

from repro_torch.compiler import ir
from repro_torch.obs import trace as obs_trace
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


# the operators that do the residual's work, each traced as one span
_OP_SPANS = ((ir.Filter, "op.filter"), (ir.Map, "op.map"),
             (ir.Aggregate, "op.aggregate"), (ir.Join, "op.join"),
             (ir.SemiJoin, "op.semijoin"), (ir.TopK, "op.topk"),
             (ir.Sort, "op.sort"))


def _eval(node: ir.Node, merged: Dict[str, ColumnTable],
          memo: Dict[int, ColumnTable]) -> ColumnTable:
    def run(n):  # noqa: A001 — keep the recursive body readable
        return _run(n, merged, memo)

    if isinstance(node, (ir.Merged, ir.Scan)):
        return merged[node.table]
    if isinstance(node, ir.Project):
        t = run(node.child)
        return t.select([c for c in node.columns if c in t.cols])
    if isinstance(node, ir.Shuffle):  # redistribution marker: row-preserving
        return run(node.child)
    if isinstance(node, ir.PyOp):
        return node.fn(*[run(c) for c in node.children])
    name = next((n for cls, n in _OP_SPANS if isinstance(node, cls)), None)
    if name is None:
        raise TypeError(f"unknown IR node: {node!r}")
    # the inputs first, so that an operator's span holds its own work only
    # and sibling spans never overlap
    ins = [run(c) for c in node.inputs()]
    tr = obs_trace.get_tracer()
    with tr.span(name, cat="residual") as sp:
        out = _apply(node, ins)
        if tr.enabled:
            sp.set(rows_in=sum(len(t) for t in ins), rows_out=len(out))
    return out


def _apply(node: ir.Node, ins) -> ColumnTable:
    """One operator over its evaluated inputs."""
    if isinstance(node, ir.Filter):
        (t,) = ins
        return t.filter(_compiled_pred(node)(t.cols))
    if isinstance(node, ir.Map):
        cols = dict(ins[0].cols)
        for name, incols, fn in node.derives:
            cols[name] = fn(*[cols[c] for c in incols])
        return ColumnTable(cols)
    if isinstance(node, ir.Aggregate):
        return ops.grouped_agg(ins[0], list(node.keys),
                               {out: (fn, col) for out, fn, col in node.aggs})
    if isinstance(node, ir.Join):
        return ops.hash_join(ins[0], ins[1], node.lkey, node.rkey)
    if isinstance(node, ir.SemiJoin):
        left, right = ins
        mask = ops.isin(left.cols[node.lkey], right.cols[node.rkey])
        return left.filter(~mask if node.anti else mask)
    if isinstance(node, ir.TopK):
        return ops.top_k(ins[0], node.col, node.k, node.ascending)
    return ops.sort_table(ins[0], list(node.columns),
                          ascending=node.ascending)
