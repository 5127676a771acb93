"""Compiler entry points: IR -> amenability split -> engine-ready Query.

Port of ``repro.compiler.compile`` (the maximal-frontier front door).
``compile_query(qid)`` builds the query's logical-plan IR, runs the
splitter, and packages the storage frontier (``PushPlan`` per table) plus
the residual interpreter as the ``Query`` the engine executes. It always
pushes the **maximal** amenable frontier.

``fact_selectivity`` reproduces the evaluation knob of the bitmap figures
at the IR level: the fact table's pushable filters are replaced by
``l_quantity <= ceil(50*sel)`` before splitting, leaving derives,
aggregates and the residual untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.compiler import (analyzer, interpreter, ir, pushability,
                                  splitter, tpch_ir)
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc.expressions import Col
from repro_torch.queryproc.queries import Query

QUERY_IDS: List[str] = list(tpch_ir.QUERY_IDS)


@dataclasses.dataclass
class CompiledQuery:
    """A compiled query plus everything the compilation derived."""
    qid: str
    root: ir.Node                       # logical plan as authored
    residual: ir.Node                   # compute-side remainder
    query: Query                        # engine-ready (plans + compute)
    amenability: List                   # [(node, Amenability)] for root
    # per-table stages the fused batch executor runs in one pass
    batchable: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    @property
    def plans(self):
        return self.query.plans

    def frontier_signature(self, with_shuffle: bool = False) -> Dict[str, str]:
        return splitter.frontier_signature(
            self.query.plans,
            self.query.shuffle_keys if with_shuffle else None)

    def frontier_size(self) -> int:
        return splitter.frontier_size(self.query.plans)


def compile_ir(root: ir.Node, qid: str = "Q?",
               cuts: Optional[Dict[str, int]] = None,
               bitmap_tables: Optional[frozenset] = None,
               clustered: Optional[Dict[str, str]] = None) -> CompiledQuery:
    """Compile an arbitrary logical plan (not just the TPC-H registry).
    ``cuts``/``bitmap_tables`` force a specific frontier cut per table
    (see ``splitter.split``). ``clustered`` (table -> cluster key, from
    ``Catalog.clustered``) unlocks post-agg HAVING absorption."""
    sp = splitter.split(root, cuts=cuts, bitmap_tables=bitmap_tables,
                        clustered=clustered)
    residual = sp.residual
    q = Query(qid=qid.upper(), plans=sp.plans,
              compute=lambda merged: interpreter.run(residual, merged),
              shuffle_keys=sp.shuffle_keys, residual=residual)
    return CompiledQuery(qid.upper(), root, residual, q,
                         analyzer.analyze(root), batchable=sp.batchable)


def compile_query_detailed(qid: str,
                           fact_selectivity: Optional[float] = None
                           ) -> CompiledQuery:
    root = tpch_ir.build_ir(qid)
    if fact_selectivity is not None and "lineitem" in ir.base_tables(root):
        thresh = float(np.ceil(50 * fact_selectivity))
        root = substitute_fact_predicate(root, Col("l_quantity") <= thresh)
    return compile_ir(root, qid)


def compile_query(qid: str, fact_selectivity: Optional[float] = None) -> Query:
    """IR -> split -> engine-ready Query (the main entry point)."""
    return compile_query_detailed(qid, fact_selectivity).query


def substitute_fact_predicate(root: ir.Node, pred: ex.Expr,
                              table: str = "lineitem") -> ir.Node:
    """Replace the fact table's *pushable* filters (base-column predicates
    on the unary chain above its Scan) with ``pred``; residual filters on
    derived columns (Q4's _late, Q12's _ontime) are preserved."""

    def rec(node: ir.Node, memo: Dict[int, ir.Node]) -> ir.Node:
        if id(node) in memo:
            return memo[id(node)]
        if isinstance(node, ir.Scan):
            out: ir.Node = ir.Filter(node, pred) if node.table == table \
                else node
        elif isinstance(node, ir.UNARY_TYPES):
            child = rec(node.child, memo)
            # the splitter's own absorption rule decides what counts as a
            # pushable fact filter, so substitution and splitting agree
            if (isinstance(node, ir.Filter)
                    and pushability.chain_scan_table(node) == table
                    and pushability.filter_absorbable(node)):
                out = child  # original pushable fact filter: dropped
            else:
                out = ir.rebuild_unary(node, child)
        elif isinstance(node, (ir.Join, ir.SemiJoin)):
            out = dataclasses.replace(node, left=rec(node.left, memo),
                                      right=rec(node.right, memo))
        elif isinstance(node, ir.PyOp):
            out = dataclasses.replace(node, children=tuple(
                rec(c, memo) for c in node.children))
        else:
            out = node
        memo[id(node)] = out
        return out

    return rec(root, {})
