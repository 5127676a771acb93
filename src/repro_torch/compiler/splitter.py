"""Plan splitter: cut a query DAG into storage frontier + compute residual.

Port of ``repro.compiler.splitter``, host-only: the same cuts, lowered to
the port's ``core.plan.PushPlan``.

For every ``Scan``-rooted branch the splitter climbs the unary operator
chain and absorbs the **maximal pushdown-amenable prefix** (per
``analyzer.classify``) into a ``core.plan.PushPlan`` — respecting the
PushPlan stage order ``predicate -> derive -> (agg | project) -> top_k`` —
then rebuilds everything above the cut as a *residual* plan rooted at
``Merged(table)`` leaves. Absorbed partial operators leave their merge
obligation in the residual:

- partial ``Aggregate``  -> residual re-aggregates the partials
  (``sum/count -> sum``, ``min -> min``, ``max -> max``);
- partial ``TopK``       -> residual re-selects top-k over the concatenated
  per-partition top-k supersets.

``Shuffle`` markers anywhere on a branch are recorded as the branch's
redistribution key (``Query.shuffle_keys``, the Fig-15 evaluation) and
dropped from both sides — the partition function itself is amenable but its
execution path lives in ``core/shuffle.py``.

The cut is *per branch*, so one query can push a full filter+derive+partial
aggregation on the fact table while shipping a dimension table whole — and,
unlike the hand-built seed plans, dimension-side filters written at their
natural relational position (below the join) are pushed too: strictly
larger frontiers on Q5/Q8 (a whole new filter stage on ``nation``) and a
strictly stronger pushed predicate on Q22 (the nation-list conjunct joins
the balance filter in the same stage).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.compiler import analyzer, ir, pushability
from repro_torch.core.plan import PushPlan, batchable_stages, plan_signature
from repro_torch.queryproc import expressions as ex


class CompileError(ValueError):
    pass


@dataclasses.dataclass
class SplitResult:
    residual: ir.Node
    plans: Dict[str, PushPlan]
    shuffle_keys: Dict[str, str]
    # per-table stages the fused batch executor runs in one vectorized pass
    # (core.executor.batchable_stages) — shuffle/bitmap-bearing frontiers
    # included since the executor emits their aux products batched; the
    # engine and the shuffle/bitmap evaluations consult this instead of
    # assuming only scan->filter->agg chains batch
    batchable: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    # candidate-cut enumeration: per table, the PushPlan for every cut
    # point k = 0..max_cut along the absorbable chain prefix
    # (candidates[t][k]; candidates[t][max_cut[t]] is the maximal
    # frontier). ``cuts`` records where this split actually cut.
    candidates: Dict[str, List[PushPlan]] = dataclasses.field(
        default_factory=dict)
    cuts: Dict[str, int] = dataclasses.field(default_factory=dict)
    max_cut: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _SplitCtx:
    """State threaded through one split walk."""
    plans: Dict[str, PushPlan]
    skeys: Dict[str, str]
    cuts: Optional[Dict[str, int]]          # requested cut per table
    bitmap_tables: frozenset                # lower these to bitmap_only
    candidates: Dict[str, List[PushPlan]]
    chosen: Dict[str, int]
    max_cut: Dict[str, int]
    clustered: Dict[str, str]               # table -> cluster key (catalog
    #                                         group-locality proof; unlocks
    #                                         post-agg HAVING absorption)


def split(root: ir.Node, cuts: Optional[Dict[str, int]] = None,
          bitmap_tables: Optional[frozenset] = None,
          clustered: Optional[Dict[str, str]] = None) -> SplitResult:
    """Cut the plan into storage frontier + residual.

    By default every chain absorbs its **maximal** amenable prefix (the
    seed behavior, unchanged). ``cuts`` selects a shallower cut per table:
    ``cuts[table] = k`` absorbs only the first ``k`` absorbable operators
    (k = 0 is the raw-projection baseline — ship the accessed columns, the
    residual replays the whole chain). Any k is *correct* — the residual
    re-runs everything above the cut — which is what lets
    ``compile.compile_query_costed`` pick k by estimated cost, and the
    property harness (tests/test_cost_split.py) execute random cuts.

    ``bitmap_tables`` marks tables whose pushed predicate is lowered to
    the §4.2 selection-bitmap exchange (``PushPlan.bitmap_only``): the
    storage node ships the packed predicate-verdict bitmap alongside the
    filtered columns, so the compute side can combine verdicts with
    bitwise ops instead of re-evaluating its share of a multi-table
    predicate. Only applied to frontiers without an absorbed
    aggregate/top-k.

    ``clustered`` maps table -> cluster key (``Catalog.clustered``): for
    those tables a Filter *above* an absorbed group-by whose keys include
    the cluster key may be absorbed too (storage-side HAVING over partial
    aggregates, Q18) — sound because group-locality makes each partial
    group final, so pruning partials prunes exactly the groups the
    residual filter would prune.
    """
    ctx = _SplitCtx({}, {}, cuts, frozenset(bitmap_tables or ()), {}, {}, {},
                    dict(clustered or {}))
    residual = _rec(root, ctx, {})
    if cuts:
        unknown = set(cuts) - set(ctx.plans)
        if unknown:
            raise CompileError(f"cuts for unscanned tables: {sorted(unknown)}")
    batchable = {t: batchable_stages(p, ctx.skeys.get(t))
                 for t, p in ctx.plans.items()}
    return SplitResult(residual, ctx.plans, ctx.skeys, batchable,
                       ctx.candidates, ctx.chosen, ctx.max_cut)


# ------------------------------------------------------------------ walk
def _rec(node: ir.Node, ctx: _SplitCtx, memo: Dict[int, ir.Node]) -> ir.Node:
    # id-keyed memo: shared subtrees (Q17 joins its own join output back)
    # split once and stay shared in the residual
    if id(node) in memo:
        return memo[id(node)]
    chain = _chain_to_scan(node)
    if chain is not None:
        out = _lower_chain(chain, ctx)
    elif isinstance(node, (ir.Join, ir.SemiJoin)):
        out = dataclasses.replace(node,
                                  left=_rec(node.left, ctx, memo),
                                  right=_rec(node.right, ctx, memo))
    elif isinstance(node, ir.PyOp):
        out = dataclasses.replace(node, children=tuple(
            _rec(c, ctx, memo) for c in node.children))
    elif isinstance(node, ir.UNARY_TYPES):
        out = ir.rebuild_unary(node, _rec(node.child, ctx, memo))
    elif isinstance(node, ir.Merged):
        out = node
    else:
        raise CompileError(f"cannot split node {node!r}")
    memo[id(node)] = out
    return out


def _chain_to_scan(node: ir.Node) -> Optional[List[ir.Node]]:
    """[Scan, op1, op2, ...] when ``node`` heads a pure unary chain over a
    Scan leaf; None otherwise (the chain bottoms out at a join/PyOp)."""
    above: List[ir.Node] = []
    cur = node
    while isinstance(cur, ir.UNARY_TYPES):
        above.append(cur)
        cur = cur.child
    if isinstance(cur, ir.Scan):
        return [cur] + above[::-1]
    return None


# ----------------------------------------------------------------- lower
@dataclasses.dataclass
class _ChainState:
    """Absorption state after the first k absorbable chain operators."""
    pred: Optional[ex.Expr] = None
    derives: Tuple[ir.DeriveSpec, ...] = ()
    out_derived: Tuple[str, ...] = ()  # derives not (yet) pruned by Project
    columns: Tuple[str, ...] = ()
    agg: Optional[Tuple[Tuple[str, ...], Tuple[ir.AggSpec, ...]]] = None
    topk: Optional[Tuple[str, int, bool]] = None
    having: Optional[ex.Expr] = None   # post-agg filter (clustered only)


def _absorption_states(scan: ir.Scan, ops_chain: List[ir.Node],
                       cluster_key: Optional[str] = None
                       ) -> List[_ChainState]:
    """One state per cut point k = 0..M along the absorbable prefix.

    The step rules are the seed's absorption loop, with one addition: on
    clustered tables a Filter above an absorbed Aggregate may absorb as a
    HAVING stage. The invariant the enumeration leans on is therefore
    relaxed from "an absorbed Aggregate/TopK is always last" to "after an
    absorbed Aggregate only HAVING Filters may follow" — a shallow cut
    below the agg still never needs partial-merge obligations, and a cut
    between agg and having replays the Filter over the merged partials
    (a no-op on survivors under group-locality)."""
    states = [_ChainState(columns=scan.columns)]
    st = states[0]
    for node in ops_chain:
        if not analyzer.classify(node).pushable:
            break
        if isinstance(node, ir.Filter):
            if st.agg is not None or st.topk is not None:
                # post-agg filter: HAVING absorption. Sound only when the
                # catalog proves group-locality (cluster key is one of the
                # group keys) and the predicate reads only the partial
                # aggregate's output schema (keys + agg outputs).
                if (st.agg is not None and st.topk is None
                        and cluster_key is not None
                        and cluster_key in st.agg[0]
                        and ex.columns_of(node.predicate)
                        <= set(st.agg[0]) | {o for o, _, _ in st.agg[1]}):
                    st = dataclasses.replace(
                        st, having=(node.predicate if st.having is None
                                    else ex.And(st.having, node.predicate)))
                    states.append(st)
                    continue
                break
            # the shared pushability rule (compiler/pushability.py): only
            # base-column predicates below any agg/top-k may be absorbed —
            # the same predicate substitute_fact_predicate uses, so the
            # two walks cannot drift
            if not pushability.filter_absorbable(node):
                break
            st = dataclasses.replace(
                st, pred=(node.predicate if st.pred is None
                          else ex.And(st.pred, node.predicate)))
        elif isinstance(node, ir.Map):
            if st.agg or st.topk:
                break
            st = dataclasses.replace(
                st, derives=st.derives + tuple(node.derives),
                out_derived=st.out_derived + tuple(
                    n for n, _, _ in node.derives))
        elif isinstance(node, ir.Project):
            if st.agg or st.topk:
                break
            # an explicit projection decides the output schema — derives
            # below it that it dropped must not be re-added
            st = dataclasses.replace(st, columns=node.columns,
                                     out_derived=())
        elif isinstance(node, ir.Aggregate):
            if st.agg or st.topk:
                break
            st = dataclasses.replace(st, agg=(node.keys, node.aggs))
        elif isinstance(node, ir.TopK):
            # top-k over *partial* aggregates could drop the true winner;
            # only absorb when no aggregation was pushed below it
            if st.agg or st.topk:
                break
            cols = st.columns
            # the ordering column must ship — both the storage-side select
            # and the residual re-select need it in the output schema
            if node.col not in cols and node.col not in st.out_derived:
                cols = tuple(cols) + (node.col,)
            st = dataclasses.replace(
                st, topk=(node.col, node.k, node.ascending), columns=cols)
        else:
            break
        states.append(st)
    return states


def _needed_above(states: List[_ChainState], ops_chain: List[ir.Node],
                  k: int, skey: Optional[str]) -> set:
    """Base/derived column names a cut at k must ship so the residual can
    replay ``ops_chain[k:M]`` and still feed everything above the chain.

    Seeded with the *maximal* plan's output schema (whatever consumes the
    chain under the maximal split consumes a subset of it), then walked
    backward over the replayed operators: each op removes the names it
    produces and adds the names it consumes."""
    M = len(states) - 1
    top = states[M]
    if top.agg is not None:
        keys, specs = top.agg
        need = set(keys) | {out for out, _, _ in specs}
    else:
        need = set(top.columns) | set(top.out_derived)
    if skey is not None:
        need.add(skey)
    for node in reversed(ops_chain[k:M]):
        if isinstance(node, ir.Filter):
            need |= ex.columns_of(node.predicate)
        elif isinstance(node, ir.Map):
            need -= {n for n, _, _ in node.derives}
            for _, incols, _ in node.derives:
                need |= set(incols)
        elif isinstance(node, ir.Aggregate):
            need -= {out for out, _, _ in node.aggs}
            need |= set(node.keys) | {c for _, _, c in node.aggs if c}
        elif isinstance(node, ir.TopK):
            need.add(node.col)
        # Project: pure restriction — consumes nothing new, and anything
        # needed above it already lies inside its output schema
    return need


def _maximal_out_schema(states: List[_ChainState]) -> Tuple[str, ...]:
    """Output schema of the maximal-frontier plan — what everything above
    the chain observes. Shallow cuts project their replayed chain back to
    this, so the extra replay-input columns they ship can never leak into
    the merged schema (and from there into a Join-rooted result)."""
    top = states[-1]
    if top.agg is not None:
        keys, specs = top.agg
        return tuple(keys) + tuple(out for out, _, _ in specs)
    return tuple(top.columns) + tuple(
        n for n in top.out_derived if n not in top.columns)


def _plan_at(table: str, states: List[_ChainState],
             ops_chain: List[ir.Node], k: int,
             skey: Optional[str]) -> PushPlan:
    st = states[k]
    if st.agg is not None:
        out_columns = tuple(st.agg[0])
    else:
        out_columns = tuple(st.columns) + tuple(
            n for n in st.out_derived if n not in st.columns)
        if k < len(states) - 1:
            # shallow cut: additionally ship the inputs of the operators
            # the residual will replay
            need = _needed_above(states, ops_chain, k, skey)
            out_columns = out_columns + tuple(
                sorted(c for c in need if c not in out_columns))
    return PushPlan(
        table, out_columns, predicate=st.pred, derive=st.derives,
        agg=(tuple(st.agg[0]), tuple(st.agg[1])) if st.agg is not None
        else None,
        top_k=st.topk, having=st.having)


def _lower_chain(chain: List[ir.Node], ctx: _SplitCtx) -> ir.Node:
    scan = chain[0]
    assert isinstance(scan, ir.Scan)
    table = scan.table
    if table in ctx.plans:
        raise CompileError(f"table {table!r} scanned more than once")

    ops_chain: List[ir.Node] = []
    for node in chain[1:]:
        if isinstance(node, ir.Shuffle):  # marker: record + drop
            ctx.skeys[table] = node.key
        else:
            ops_chain.append(node)

    skey = ctx.skeys.get(table)
    states = _absorption_states(scan, ops_chain, ctx.clustered.get(table))
    max_k = len(states) - 1
    k = max_k if ctx.cuts is None else ctx.cuts.get(table, max_k)
    if not 0 <= k <= max_k:
        raise CompileError(
            f"cut {k} out of range for {table!r} (max {max_k})")

    plan = _plan_at(table, states, ops_chain, k, skey)
    if (table in ctx.bitmap_tables and plan.predicate is not None
            and plan.agg is None and plan.top_k is None):
        # §4.2 exchange: ship the packed predicate-verdict bitmap alongside
        plan = dataclasses.replace(plan, bitmap_only=True)
    ctx.plans[table] = plan
    ctx.candidates[table] = [_plan_at(table, states, ops_chain, j, skey)
                             for j in range(max_k + 1)]
    ctx.chosen[table] = k
    ctx.max_cut[table] = max_k

    st = states[k]
    residual: ir.Node = ir.Merged(table)
    if st.agg is not None:
        keys, specs = st.agg
        merge = tuple((out, analyzer.DECOMPOSABLE[fn], out)
                      for out, fn, _ in specs)
        residual = ir.Aggregate(residual, tuple(keys), merge)
        if st.having is not None:
            # re-apply the absorbed HAVING after the partial merge — a
            # no-op on the storage-filtered survivors under group-locality,
            # kept so the residual mirrors the original operator sequence
            residual = ir.Filter(residual, st.having)
    if st.topk is not None:
        col, kk, asc = st.topk
        residual = ir.TopK(residual, col, kk, asc)
    if k < max_k:
        # shallow cut: replay the unabsorbed absorbable prefix, then
        # project back to the maximal frontier's output schema so the
        # extra replay-input columns the plan shipped stay chain-local
        for node in ops_chain[k:max_k]:
            residual = ir.rebuild_unary(node, residual)
        residual = ir.Project(residual, _maximal_out_schema(states))
        for node in ops_chain[max_k:]:
            residual = ir.rebuild_unary(node, residual)
    else:
        for node in ops_chain[k:]:
            residual = ir.rebuild_unary(node, residual)
    return residual


# ----------------------------------------------------- frontier reporting
_STAGES = ("filter", "derive", "agg", "topk")


def frontier_signature(plans: Dict[str, PushPlan],
                       shuffle_keys: Optional[Dict[str, str]] = None
                       ) -> Dict[str, str]:
    """Per-table signature of the pushed stages, e.g.
    {'lineitem': 'scan+filter+derive+agg', 'orders': 'scan'}. Passing the
    split's ``shuffle_keys`` marks shuffle-bearing frontiers
    (``...+shuffle``) — the batch executor runs the partition function in
    the same fused pass as the rest of the chain."""
    return {table: plan_signature(
                p, shuffle_keys.get(table) if shuffle_keys else None)
            for table, p in sorted(plans.items())}


def frontier_size(plans: Dict[str, PushPlan]) -> int:
    """Total pushed stages across tables — the partial order used to show
    a compiled frontier is *strictly larger* than a hand-built one."""
    return sum(sig.count("+") + 1
               for sig in frontier_signature(plans).values())
