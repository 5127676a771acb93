"""Multi-table predicate lowering: implied per-table predicates + the
§4.2 selection-bitmap exchange.

Port of ``repro.compiler.multitable``, host-side planning over the
catalog: the value domains of small restricted dimension chains are
evaluated on the catalog's device (the port's ``compile_expr`` and
``torch.unique``) and come back as the same sorted Python values, so every
lowered ``In`` prints as the reference's.

A residual ``Filter`` sitting above the joins whose predicate spans
several base tables (Q7's two-nation OR, Q19's brand/container/quantity
OR-of-ANDs) cannot be pushed as-is — it is not partition-parallel over any
single table. But each table's *implied* predicate can: the strongest
single-table consequence of the original predicate (``And`` keeps the
owned side, ``Or`` requires both branches to imply something). Rows a
table drops under its implied predicate could never survive the original
filter, and inner equi-joins / row-preserving operators keep the
surviving rows' relative order — so inserting the implied filter directly
above the table's ``Scan`` (where the splitter absorbs it) leaves the
final query result **byte-identical** while strictly shrinking the bytes
the table ships. A soundness walk guards the insertion: the path from the
multi-table filter down to the scan must not cross an ``Aggregate``,
``TopK``, ``PyOp``, a ``SemiJoin`` right side, a shared (DAG) subtree, or
a ``Map`` that shadows a predicate column.

Two lowering encodings per table, chosen by cost (the paper's §4.2
design-space discussion):

- **conjunct pushdown** — the implied predicate joins the table's pushed
  filter stage; the compute layer re-evaluates the full multi-table
  predicate over the (smaller) join output.
- **bitmap exchange** (``PushPlan.bitmap_only``) — the storage node
  additionally ships the packed predicate-verdict bitmap (1 bit/row), so
  the compute side can combine per-table verdicts with cheap bitwise ops
  (``core.bitmap.combine_bitmaps``) instead of re-reading this table's
  predicate columns across the join fan-out. Worth its 1 bit/row exactly
  when the saved re-evaluation outweighs the extra ship + combine
  (:func:`exchange_pays`) — high-selectivity, few-column conjuncts (Q19's
  ``l_quantity`` bound) qualify; highly selective dimension restrictions
  (Q19's part disjunction, Q7's nation lists) do not.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import torch

from repro_torch.compiler import ir, pushability
from repro_torch.core.cost import StorageResources
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc.table import from_key, sort_key

#: compute-node operator bandwidth the exchange scoring assumes when the
#: caller does not pass the engine's (matches EngineConfig.compute_bw)
DEFAULT_COMPUTE_BW = 2.4e9


@dataclasses.dataclass(frozen=True)
class Lowering:
    """One implied predicate lowered onto one table's frontier."""
    table: str
    predicate: ex.Expr          # implied single-table predicate
    bitmap: bool                # §4.2 exchange encoding chosen?
    est_selectivity: float      # of the implied predicate, table stats
    source: str                 # repr of the multi-table predicate


# ------------------------------------------------------------ implication
def implied_predicate(expr: ex.Expr, owned: Set[str],
                      domains: Optional[Dict[str, FrozenSet]] = None
                      ) -> Optional[ex.Expr]:
    """Strongest predicate over ``owned`` columns implied by ``expr``
    (None when nothing is implied). ``And`` keeps whichever side implies;
    ``Or`` weakens — both branches must imply, else nothing does. A
    column-column compare within one table qualifies; across tables it
    implies nothing *on its own* — but when ``domains`` carries the value
    domain of the far column (derived from a restricted dimension table and
    propagated over inner equi-joins by :func:`lower`), a cross-table
    equality translates into an ``In`` over the owned column: Q5's
    ``c_nationkey == s_nationkey`` under ``s_nationkey ∈ region-2 nations``
    implies ``In(c_nationkey, region-2 nations)``."""
    if isinstance(expr, ex.And):
        left = implied_predicate(expr.left, owned, domains)
        right = implied_predicate(expr.right, owned, domains)
        if left is None:
            return right
        if right is None:
            return left
        return ex.And(left, right)
    if isinstance(expr, ex.Or):
        left = implied_predicate(expr.left, owned, domains)
        right = implied_predicate(expr.right, owned, domains)
        if left is None or right is None:
            return None
        return ex.Or(left, right)
    cols = ex.columns_of(expr)
    if cols and cols <= owned:
        return expr
    if (domains and isinstance(expr, ex.Cmp) and expr.op == "=="
            and isinstance(expr.value, ex.Col)):
        for mine, other in ((expr.col.name, expr.value.name),
                            (expr.value.name, expr.col.name)):
            dom = domains.get(other)
            if mine in owned and other not in owned and dom:
                return ex.In(ex.Col(mine), tuple(sorted(dom)))
    return None


# ------------------------------------------------------- value domains
#: tables larger than this are never evaluated for domains (dimension
#: tables only — the derivation scans the real data once)
DOMAIN_MAX_ROWS = 4096
#: a domain wider than this cannot win as an In-filter
DOMAIN_MAX_VALUES = 512


def _chain_domains(node: ir.Node, catalog,
                   memo: Dict[int, Dict[str, FrozenSet]]
                   ) -> Dict[str, FrozenSet]:
    """Per-column value domains of the rows a unary chain over a *small*
    Scan produces: evaluate the chain's absorbable filters against the
    base table and collect each base column's surviving distinct values.
    Only domains *strictly narrower* than the column's full NDV qualify —
    an ``In`` over every value is vacuous and would pollute frontiers."""
    if id(node) in memo:
        return memo[id(node)]
    out: Dict[str, FrozenSet] = {}
    preds: List[ex.Expr] = []
    cur = node
    ok = True
    while isinstance(cur, ir.UNARY_TYPES):
        if isinstance(cur, (ir.Aggregate, ir.TopK)):
            ok = False  # output rows are groups, not base rows
            break
        if isinstance(cur, ir.Filter):
            if not pushability.filter_absorbable(cur):
                ok = False
                break
            preds.append(cur.predicate)
        cur = cur.child
    if ok and isinstance(cur, ir.Scan) and preds:
        parts = catalog.partitions_of(cur.table)
        base = set(parts[0].data.columns)
        if (sum(len(p.data) for p in parts) <= DOMAIN_MAX_ROWS
                and all(ex.columns_of(p) <= base for p in preds)):
            data = catalog.scan_table(cur.table)
            mask = torch.ones(len(data), dtype=torch.bool,
                              device=data.device)
            for p in preds:
                mask &= ex.compile_expr(p)(data.cols)
            for c in data.columns:
                col = data.cols[c]
                key = col if col.is_floating_point() else sort_key(col)
                vals = torch.unique(key[mask])
                if 0 < vals.numel() <= DOMAIN_MAX_VALUES \
                        and vals.numel() < torch.unique(key).numel():
                    if not col.is_floating_point():
                        vals = from_key(vals, col.dtype)
                    out[c] = frozenset(vals.tolist())
    memo[id(node)] = out
    return out


def _equality_atoms(pred: ex.Expr):
    """Top-level ``a == b`` column-column conjuncts of an And-tree."""
    if isinstance(pred, ex.And):
        yield from _equality_atoms(pred.left)
        yield from _equality_atoms(pred.right)
    elif (isinstance(pred, ex.Cmp) and pred.op == "=="
          and isinstance(pred.value, ex.Col)):
        yield pred.col.name, pred.value.name


def _output_facts(root: ir.Node, parents: Dict[int, int], catalog
                  ) -> Dict[int, Dict[str, FrozenSet]]:
    """For every node, the column-domain facts that hold for each of its
    rows *that contributes to the final output* — the license to drop the
    violating rows early.

    Facts are born at inner equi-joins whose other side is a restricted
    small-table chain (a row only survives the join if its key matches a
    surviving dimension value) and at equality filter conjuncts (a
    surviving row carries equal values, so a domain transfers across the
    atom). They flow *down* the plan, because a child row that reaches the
    output does so through its parent — gated by the same soundness rules
    as the multi-table walk: a shared (DAG) subtree resets (the other
    consumer sees all rows), Aggregate/TopK/PyOp reset (removed rows fold
    into surviving outputs), a Map drops facts on columns it shadows, and
    a SemiJoin's membership side never receives facts (removing its rows
    flips matches)."""
    facts_at: Dict[int, Dict[str, FrozenSet]] = {}
    domains_memo: Dict[int, Dict[str, FrozenSet]] = {}

    def visit(node: ir.Node, facts: Dict[str, FrozenSet]) -> None:
        if parents.get(id(node), 0) > 1:
            facts = {}
        prev = facts_at.get(id(node))
        if prev is not None:
            facts = {c: d for c, d in prev.items() if facts.get(c) == d}
            if facts == prev:
                return  # fixpoint for this node
        facts_at[id(node)] = facts
        if isinstance(node, (ir.Aggregate, ir.TopK, ir.PyOp, ir.Merged)):
            down: Dict[str, FrozenSet] = {}
        elif isinstance(node, ir.Map):
            shadowed = {n for n, _, _ in node.derives}
            down = {c: d for c, d in facts.items() if c not in shadowed}
        elif isinstance(node, ir.Filter):
            down = dict(facts)
            for a, b in _equality_atoms(node.predicate):
                if a in down and b not in down:
                    down[b] = down[a]
                elif b in down and a not in down:
                    down[a] = down[b]
        else:
            down = facts
        if isinstance(node, ir.Join):
            lfacts, rfacts = dict(down), dict(down)
            dom = _chain_domains(node.right, catalog, domains_memo
                                 ).get(node.rkey)
            if dom:
                lfacts[node.lkey] = (lfacts[node.lkey] & dom
                                     if node.lkey in lfacts else dom)
            dom = _chain_domains(node.left, catalog, domains_memo
                                 ).get(node.lkey)
            if dom:
                rfacts[node.rkey] = (rfacts[node.rkey] & dom
                                     if node.rkey in rfacts else dom)
            visit(node.left, lfacts)
            visit(node.right, rfacts)
            return
        if isinstance(node, ir.SemiJoin):
            lfacts = dict(down)
            if not node.anti:
                dom = _chain_domains(node.right, catalog, domains_memo
                                     ).get(node.rkey)
                if dom:
                    lfacts[node.lkey] = (lfacts[node.lkey] & dom
                                         if node.lkey in lfacts else dom)
            visit(node.left, lfacts)
            visit(node.right, {})
            return
        for child in node.inputs():
            visit(child, down)

    visit(root, {})
    # close the facts *at* each Filter node over its own equality atoms —
    # a row surviving the output passed the filter, so the transfer holds
    # at the node too (implied_predicate consumes these as `domains`)
    for node in ir.walk(root):
        if not isinstance(node, ir.Filter):
            continue
        facts = dict(facts_at.get(id(node), {}))
        for a, b in _equality_atoms(node.predicate):
            if a in facts and b not in facts:
                facts[b] = facts[a]
            elif b in facts and a not in facts:
                facts[a] = facts[b]
        facts_at[id(node)] = facts
    return facts_at


# --------------------------------------------------------- soundness walk
def _parent_counts(root: ir.Node) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for node in ir.walk(root):
        for child in node.inputs():
            counts[id(child)] = counts.get(id(child), 0) + 1
    return counts


def _path_to_scan(node: ir.Node, table: str) -> Optional[List[ir.Node]]:
    """Nodes from ``node`` down to ``Scan(table)`` when every step is
    row-removal-safe; None otherwise. Aggregate/TopK (row counts feed the
    result), PyOp (opaque) and a SemiJoin's right side (membership tests
    invert under anti-joins) block the descent."""
    if isinstance(node, ir.Scan):
        return [node] if node.table == table else None
    if isinstance(node, (ir.Aggregate, ir.TopK, ir.PyOp, ir.Merged)):
        return None
    if isinstance(node, ir.SemiJoin):
        sub = _path_to_scan(node.left, table)
        return [node] + sub if sub is not None else None
    if isinstance(node, ir.Join):
        for side in (node.left, node.right):
            sub = _path_to_scan(side, table)
            if sub is not None:
                return [node] + sub
        return None
    if isinstance(node, ir.UNARY_TYPES):
        sub = _path_to_scan(node.child, table)
        return [node] + sub if sub is not None else None
    return None


def _path_sound(path: List[ir.Node], pred_cols: Set[str],
                parents: Dict[int, int]) -> bool:
    for node in path:
        if parents.get(id(node), 0) > 1:
            return False  # shared subtree: the other consumer sees fewer rows
        if isinstance(node, ir.Map) and (
                {n for n, _, _ in node.derives} & pred_cols):
            return False  # derive shadows a predicate column
    return True


# ------------------------------------------------------- exchange scoring
def exchange_pays(sel: float, n_pred_cols: int, res: StorageResources,
                  compute_bw: float = DEFAULT_COMPUTE_BW) -> bool:
    """Per-row economics of shipping the verdict bitmap (§4.2 exchange)
    instead of having the compute layer re-evaluate this table's share of
    the multi-table predicate:

    - saved at compute: re-reading the ``n_pred_cols`` shipped predicate
      columns over the surviving rows — ``sel * 8 * n_pred_cols`` bytes;
    - paid: 1 bit/row across the per-stream network share plus the
      bitwise combine at compute.
    """
    saved = sel * 8.0 * n_pred_cols / compute_bw
    paid = 0.125 * (1.0 / res.stream_bw + 1.0 / compute_bw)
    return saved > paid


# ---------------------------------------------------------------- rewrite
def _insert_filters(node: ir.Node, by_table: Dict[str, ex.Expr],
                    memo: Dict[int, ir.Node]) -> ir.Node:
    if id(node) in memo:
        return memo[id(node)]
    if isinstance(node, ir.Scan):
        out: ir.Node = (ir.Filter(node, by_table[node.table])
                        if node.table in by_table else node)
    elif isinstance(node, (ir.Join, ir.SemiJoin)):
        out = dataclasses.replace(
            node, left=_insert_filters(node.left, by_table, memo),
            right=_insert_filters(node.right, by_table, memo))
    elif isinstance(node, ir.PyOp):
        out = dataclasses.replace(node, children=tuple(
            _insert_filters(c, by_table, memo) for c in node.children))
    elif isinstance(node, ir.UNARY_TYPES):
        out = ir.rebuild_unary(node,
                               _insert_filters(node.child, by_table, memo))
    else:
        out = node
    memo[id(node)] = out
    return out


def lower(root: ir.Node, catalog, res: StorageResources,
          compute_bw: float = DEFAULT_COMPUTE_BW
          ) -> Tuple[ir.Node, List[Lowering]]:
    """Lower every sound multi-table predicate of ``root`` onto its
    tables' frontiers. Returns the rewritten plan (implied filters
    inserted directly above the scans, where the splitter absorbs them)
    plus the per-table :class:`Lowering` records — tables whose record has
    ``bitmap=True`` should split with ``bitmap_tables`` so their frontier
    carries the §4.2 exchange."""
    owned_by_table: Dict[str, Set[str]] = {
        t: set(parts[0].data.columns) for t, parts in catalog.tables.items()
        if parts}
    owner: Dict[str, str] = {c: t for t, cols in owned_by_table.items()
                             for c in cols}
    parents = _parent_counts(root)
    facts_at = _output_facts(root, parents, catalog)

    implied_by_table: Dict[str, ex.Expr] = {}
    seen_conjuncts: Dict[str, Set[str]] = {}
    source_by_table: Dict[str, List[str]] = {}

    def _add(table: str, implied: ex.Expr, source: str) -> None:
        if repr(implied) in seen_conjuncts.setdefault(table, set()):
            return  # same conjunct from filter- and domain-derivation
        seen_conjuncts[table].add(repr(implied))
        prev = implied_by_table.get(table)
        implied_by_table[table] = (implied if prev is None
                                   else ex.And(prev, implied))
        source_by_table.setdefault(table, []).append(source)

    for node in ir.walk(root):
        if not isinstance(node, ir.Filter):
            continue
        pred_cols = ex.columns_of(node.predicate)
        span = {owner[c] for c in pred_cols if c in owner}
        if len(span) < 2:
            continue
        for table in sorted(span):
            implied = implied_predicate(node.predicate,
                                        owned_by_table[table],
                                        facts_at.get(id(node)))
            if implied is None:
                continue
            path = _path_to_scan(node.child, table)
            if path is None or not _path_sound(path, pred_cols, parents):
                continue
            _add(table, implied, repr(node.predicate))

    # scan-level domain lowerings: a fact that survived the gated descent
    # all the way to a Scan is directly an implied In-filter on that table
    # (Q8's region-restricted nation join narrows customer without any
    # multi-table filter in between). Tables scanned more than once are
    # skipped — _insert_filters keys by table name, so a fact proven for
    # one scan instance must not leak onto the other.
    all_scans = ir.scans(root)
    scan_count: Dict[str, int] = {}
    for s in all_scans:
        scan_count[s.table] = scan_count.get(s.table, 0) + 1
    for s in all_scans:
        if scan_count[s.table] > 1:
            continue
        facts = facts_at.get(id(s)) or {}
        for col in sorted(facts):
            if owner.get(col) != s.table:
                continue
            _add(s.table, ex.In(ex.Col(col), tuple(sorted(facts[col]))),
                 f"domain[{col}]")
    if not implied_by_table:
        return root, []

    lowerings: List[Lowering] = []
    for table, implied in sorted(implied_by_table.items()):
        # the stats of the columns the estimate reads (not a copy of the
        # whole table, which for lineitem is several GB on the card)
        stats = catalog.scan_table(
            table, sorted(ex.columns_of(implied))).stats()
        sel = ex.estimate_selectivity(implied, stats)
        bitmap = exchange_pays(sel, len(ex.columns_of(implied)), res,
                               compute_bw)
        lowerings.append(Lowering(table, implied, bitmap, sel,
                                  "; ".join(source_by_table[table])))
    return _insert_filters(root, implied_by_table, {}), lowerings
