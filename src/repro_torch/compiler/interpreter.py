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

Over a compute cluster (``core.cluster``) a merged table may be
``Partitioned``: one slice a compute node, placed by the hash of a key
column. Filter, Map, Project and the Shuffle marker keep the slices. A
join or semi-join whose inputs are both split on its keys runs once a
node; a split input against a whole one runs once a node against the
whole side, which is broadcast to the other nodes. Every other operator,
a join of inputs split on other keys and the plan's root gather the
slices to node 0 first, in node order. Per-node operators run under
``op.<kind>`` spans that carry their ``node``; the broadcast and gathered
bytes are counted into the ``Exchange``. The answer is the whole
evaluation's; only the order in which floats are added changes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from repro_torch.compiler import ir
from repro_torch.core.cluster import Exchange, Partitioned, table_bytes
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


def run(node: ir.Node, merged: Dict[str, ColumnTable],
        exchange: Optional[Exchange] = None) -> ColumnTable:
    """Evaluate a residual plan against the merged pushdown results.
    Shared subtrees (DAGs) are evaluated once via an id-keyed memo. A
    ``Partitioned`` merged table runs per node, its traffic counted into
    ``exchange``."""
    exchange = exchange if exchange is not None else Exchange()
    return _whole(_run(node, merged, {}, exchange), exchange)


def _run(node: ir.Node, merged: Dict[str, ColumnTable],
         memo: Dict[int, ColumnTable],
         exchange: Optional[Exchange] = None) -> ColumnTable:
    if id(node) in memo:
        return memo[id(node)]
    out = _eval(node, merged, memo,
                exchange if exchange is not None else Exchange())
    memo[id(node)] = out
    return out


def _whole(t, exchange: Exchange) -> ColumnTable:
    return t.gather(exchange) if isinstance(t, Partitioned) else t


# the operators that do the residual's work, each traced as one span
_OP_SPANS = ((ir.Filter, "op.filter"), (ir.Map, "op.map"),
             (ir.Aggregate, "op.aggregate"), (ir.Join, "op.join"),
             (ir.SemiJoin, "op.semijoin"), (ir.TopK, "op.topk"),
             (ir.Sort, "op.sort"))


def _eval(node: ir.Node, merged: Dict[str, ColumnTable],
          memo: Dict[int, ColumnTable], exchange: Exchange) -> ColumnTable:
    def run(n):  # noqa: A001 — keep the recursive body readable
        return _run(n, merged, memo, exchange)

    if isinstance(node, (ir.Merged, ir.Scan)):
        return merged[node.table]
    if isinstance(node, ir.Project):
        t = run(node.child)
        if isinstance(t, Partitioned):
            return Partitioned([s.select([c for c in node.columns
                                          if c in s.cols])
                                for s in t.slices], t.key)
        return t.select([c for c in node.columns if c in t.cols])
    if isinstance(node, ir.Shuffle):  # redistribution marker: row-preserving
        return run(node.child)
    if isinstance(node, ir.PyOp):
        return node.fn(*[_whole(run(c), exchange) for c in node.children])
    name = next((n for cls, n in _OP_SPANS if isinstance(node, cls)), None)
    if name is None:
        raise TypeError(f"unknown IR node: {node!r}")
    # the inputs first, so that an operator's span holds its own work only
    # and sibling spans never overlap
    ins = [run(c) for c in node.inputs()]
    if any(isinstance(t, Partitioned) for t in ins):
        return _eval_split(node, name, ins, exchange)
    return _traced(node, name, ins)


def _traced(op: ir.Node, name: str, ins, **attrs) -> ColumnTable:
    """One operator over its evaluated inputs, under its span."""
    tr = obs_trace.get_tracer()
    with tr.span(name, cat="residual", **attrs) as sp:
        out = _apply(op, ins)
        if tr.enabled:
            sp.set(rows_in=sum(len(t) for t in ins), rows_out=len(out))
    return out


def _per_node(node: ir.Node, name: str, ins) -> list:
    """The operator once a node, over each node's inputs (a whole input is
    the same on every node)."""
    n = next(t.n for t in ins if isinstance(t, Partitioned))
    return [_traced(node, name, [t.slices[i] if isinstance(t, Partitioned)
                                 else t for t in ins], node=i)
            for i in range(n)]


def _eval_split(node: ir.Node, name: str, ins, exchange: Exchange):
    """One operator with at least one input split over compute nodes."""
    if isinstance(node, (ir.Filter, ir.Map)):
        return Partitioned(_per_node(node, name, ins), ins[0].key)
    if isinstance(node, (ir.Join, ir.SemiJoin)):
        left, right = ins
        lp, rp = isinstance(left, Partitioned), isinstance(right, Partitioned)
        if lp and rp and left.key == node.lkey and right.key == node.rkey:
            return Partitioned(_per_node(node, name, ins), left.key)
        if lp and not rp:  # the whole right side to every node
            exchange.broadcast_bytes += table_bytes(right) * (left.n - 1)
            return Partitioned(_per_node(node, name, ins), left.key)
        if rp and not lp and isinstance(node, ir.Join):
            exchange.broadcast_bytes += table_bytes(left) * (right.n - 1)
            # rows sit where their right key sent them: the left key holds
            # the same values when that key is the join's
            return Partitioned(_per_node(node, name, ins),
                               node.lkey if right.key == node.rkey else None)
    return _traced(node, name, [_whole(t, exchange) for t in ins])


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
