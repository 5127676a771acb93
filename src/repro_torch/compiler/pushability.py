"""Shared filter-pushability rule.

Port of ``repro.compiler.pushability``. The splitter's absorption loop and
``compile.substitute_fact_predicate``'s drop-walk ask the same question —
"is this Filter a pushable storage-side filter, or residual?" — and both
call :func:`filter_absorbable`, the single source of truth:

A ``Filter`` on a unary chain over a ``Scan`` is pushable iff

1. no ``Aggregate``/``TopK`` sits below it on the chain — the PushPlan
   stage order evaluates predicates *before* (partial) aggregation, so a
   filter above an absorbed aggregate is residual by construction (it
   filters merged partials, e.g. Q18's HAVING); and
2. its predicate touches only base columns — columns produced below it on
   the chain (Map derives, Aggregate outputs: Q4's ``_late``, Q12's
   ``_ontime``) do not exist at the storage scan's predicate stage.

``Shuffle`` markers are row-preserving and produce no columns, so the walks
skip through them.
"""
from __future__ import annotations

from typing import Optional, Set

from repro_torch.compiler import ir
from repro_torch.queryproc import expressions as ex


def chain_scan_table(node: ir.Node) -> Optional[str]:
    """The base table when ``node`` sits on a pure unary chain over a Scan;
    None when the chain bottoms out at a join/PyOp leaf."""
    cur = node
    while isinstance(cur, ir.UNARY_TYPES):
        cur = cur.child
    return cur.table if isinstance(cur, ir.Scan) else None


def blocking_op_below(node: ir.Node) -> bool:
    """True when an Aggregate/TopK sits strictly below ``node`` on its
    unary chain (condition 1 above)."""
    cur = node.child if isinstance(node, ir.UNARY_TYPES) else node
    while isinstance(cur, ir.UNARY_TYPES):
        if isinstance(cur, (ir.Aggregate, ir.TopK)):
            return True
        cur = cur.child
    return False


def derived_names_below(node: ir.Node) -> Set[str]:
    """Columns that only exist above some producer strictly below ``node``
    on its unary chain — Map derives AND Aggregate outputs (condition 2)."""
    names: Set[str] = set()
    cur = node.child if isinstance(node, ir.UNARY_TYPES) else node
    while isinstance(cur, ir.UNARY_TYPES):
        if isinstance(cur, ir.Map):
            names |= {n for n, _, _ in cur.derives}
        elif isinstance(cur, ir.Aggregate):
            names |= {out for out, _, _ in cur.aggs}
        cur = cur.child
    return names


def filter_absorbable(node: ir.Filter) -> bool:
    """THE shared predicate: may this Filter be absorbed into the storage
    frontier (splitter), equivalently dropped as a pushable fact filter by
    the fact-selectivity substitution (compile)?"""
    return (not blocking_op_below(node)
            and not (ex.columns_of(node.predicate) & derived_names_below(node)))
