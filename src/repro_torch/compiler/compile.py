"""Compiler entry points: IR -> amenability split -> engine-ready Query.

Port of ``repro.compiler.compile``. ``compile_query(qid)`` builds the
query's logical-plan IR, runs the splitter, and packages the storage
frontier (``PushPlan`` per table) plus the residual interpreter as the
``Query`` the engine executes. It always pushes the **maximal** amenable
frontier.

``compile_query_costed(qid, catalog, ...)`` is the cost-based front door:
it scores every candidate cut along each table's absorbable chain with
the §3.3 cost model over the catalog's partitions (``core.cost.cut_score``:
storage CPU plus result-ship time; the k=0 candidate is the raw
projection), lowers sound multi-table predicates onto their tables
(``compiler.multitable``: a conjunct, or the §4.2 bitmap exchange), and
takes the cheapest cut per table. A ``CardinalityCorrector`` rescales each
candidate's ``s_out`` by measured ratios. Every choice gives the maximal
frontier's result.

``fact_selectivity`` reproduces the evaluation knob of the bitmap figures
at the IR level: the fact table's pushable filters are replaced by
``l_quantity <= ceil(50*sel)`` before splitting, leaving derives,
aggregates and the residual untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.compiler import (analyzer, interpreter, ir, multitable,
                                  pushability, splitter, tpch_ir)
from repro_torch.core.cost import (CardinalityCorrector, StorageResources,
                                   cut_score)
from repro_torch.core.plan import PushPlan, plan_signature
from repro_torch.obs import trace as obs_trace
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc.expressions import Col
from repro_torch.queryproc.queries import Query

QUERY_IDS: List[str] = list(tpch_ir.QUERY_IDS)


@dataclasses.dataclass
class CutChoice:
    """How the cost-based chooser cut one table's chain."""
    table: str
    chosen: int                      # absorbed-prefix length picked
    maximal: int                     # the maximal frontier's prefix length
    scores: Tuple[float, ...]        # per candidate k = 0..maximal
    signatures: Tuple[str, ...]      # per candidate frontier signature
    bitmap: bool = False             # §4.2 exchange lowered onto this table
    lowered: Optional[str] = None    # repr of the implied predicate, if any


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
    # the split itself (candidate cuts, chosen and maximal cuts)
    split: Optional[splitter.SplitResult] = None
    # cost-based compilation only: the chooser's report per table
    cut_report: Optional[List[CutChoice]] = None

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
                         analyzer.analyze(root), batchable=sp.batchable,
                         split=sp)


def compile_query_detailed(qid: str,
                           fact_selectivity: Optional[float] = None
                           ) -> CompiledQuery:
    root = tpch_ir.build_ir(qid)
    if fact_selectivity is not None and "lineitem" in ir.base_tables(root):
        thresh = float(np.ceil(50 * fact_selectivity))
        root = substitute_fact_predicate(root, Col("l_quantity") <= thresh)
    return compile_ir(root, qid)


def compile_query(qid: str, fact_selectivity: Optional[float] = None) -> Query:
    """IR -> split -> engine-ready Query (the main entry point). Traced, it
    is one ``compile`` span, as the costed path's, with ``costed=False``."""
    with obs_trace.get_tracer().span("compile", cat="compiler",
                                     qid=qid.upper(), costed=False):
        return compile_query_detailed(qid, fact_selectivity).query


def _candidate_score(plan: PushPlan, table: str, catalog,
                     res: StorageResources,
                     corrector: Optional[CardinalityCorrector],
                     qid: str) -> float:
    """Predicted cost of pushing this candidate frontier: ``cut_score``
    summed over the table's partitions, with the corrector's ratio for
    exactly this signature applied."""
    from repro_torch.core.executor import compile_push_plan  # a cycle
    cplan = compile_push_plan(plan)
    sig = plan_signature(plan)
    has_work = bool(plan.predicate is not None or plan.derive
                    or plan.agg is not None or plan.top_k is not None)
    total = 0.0
    for part in catalog.partitions_of(table):
        cost = cplan.estimate_cost(part)
        if corrector is not None:
            # candidates of different signatures compete, so a ratio
            # measured under one must not leak onto another
            cost = corrector.correct(qid, table, sig, cost, exact=True)
        total += cut_score(cost, res, has_work)
    return total


def compile_query_costed(qid: str, catalog,
                         res: Optional[StorageResources] = None,
                         corrector: Optional[CardinalityCorrector] = None,
                         fact_selectivity: Optional[float] = None,
                         compute_bw: float = multitable.DEFAULT_COMPUTE_BW
                         ) -> CompiledQuery:
    """Cost-based frontier selection: lower the sound multi-table
    predicates, score every candidate cut against the catalog, and take
    the cheapest per table (ties to the deeper cut, so equal costs keep
    the maximal frontier). Results equal ``compile_query``'s for every
    choice: the residual replays whatever is not pushed. Traced, it is one
    ``compile`` span with a ``cut_scoring`` event per table."""
    tr = obs_trace.get_tracer()
    with tr.span("compile", cat="compiler", qid=qid.upper(),
                 costed=True) as sp:
        cq = _compile_query_costed(qid, catalog, res, corrector,
                                   fact_selectivity, compute_bw)
        if tr.enabled:
            for ch in cq.cut_report:
                tr.event("cut_scoring", cat="compiler", table=ch.table,
                         chosen=ch.chosen, maximal=ch.maximal,
                         scores=list(ch.scores),
                         signatures=list(ch.signatures),
                         bitmap=ch.bitmap, lowered=ch.lowered)
            sp.set(n_tables=len(cq.cut_report),
                   frontier=cq.frontier_signature())
    return cq


def _compile_query_costed(qid: str, catalog,
                          res: Optional[StorageResources],
                          corrector: Optional[CardinalityCorrector],
                          fact_selectivity: Optional[float],
                          compute_bw: float) -> CompiledQuery:
    res = res if res is not None else StorageResources()
    root = tpch_ir.build_ir(qid)
    if fact_selectivity is not None and "lineitem" in ir.base_tables(root):
        thresh = float(np.ceil(50 * fact_selectivity))
        root = substitute_fact_predicate(root, Col("l_quantity") <= thresh)
    root, lowerings = multitable.lower(root, catalog, res, compute_bw)
    lowered_by_table = {lw.table: lw for lw in lowerings}
    bitmap_tables = frozenset(t for t, lw in lowered_by_table.items()
                              if lw.bitmap)
    # a clustered table's group locality adds post-agg HAVING candidates
    clustered = dict(getattr(catalog, "clustered", {}) or {})
    probe = splitter.split(root, clustered=clustered)  # the maximal split
    cuts: Dict[str, int] = {}
    report: List[CutChoice] = []
    for table in sorted(probe.candidates):
        cands = probe.candidates[table]
        scored = []
        for plan in cands:
            if (table in bitmap_tables and plan.predicate is not None
                    and plan.agg is None and plan.top_k is None):
                plan = dataclasses.replace(plan, bitmap_only=True)
            scored.append((plan, _candidate_score(plan, table, catalog, res,
                                                  corrector, qid)))
        best = min(range(len(scored)), key=lambda j: (scored[j][1], -j))
        cuts[table] = best
        lw = lowered_by_table.get(table)
        report.append(CutChoice(
            table=table, chosen=best, maximal=len(cands) - 1,
            scores=tuple(sc for _, sc in scored),
            signatures=tuple(plan_signature(p) for p, _ in scored),
            bitmap=table in bitmap_tables,
            lowered=repr(lw.predicate) if lw is not None else None))
    cq = compile_ir(root, qid, cuts=cuts, bitmap_tables=bitmap_tables,
                    clustered=clustered)
    cq.cut_report = report
    return cq


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
