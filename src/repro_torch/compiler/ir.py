"""Logical-plan IR for the pushdown compiler.

Port of ``repro.compiler.ir``, host-only, over the port's ``Expr`` trees
(``repro_torch.queryproc.expressions``). A query is a DAG of relational
nodes. The IR mirrors the operator vocabulary of ``queryproc/operators.py``
— every node has an exact compute-layer implementation there — while the
*storage-amenable* subset (the paper's §4.1 "local + bounded" operators)
additionally lowers to ``core.plan.PushPlan`` stages.

Node inputs are other nodes; ``Scan`` and ``Merged`` are the leaves.
``Merged(table)`` only appears in *residual* plans produced by the splitter:
it denotes the concatenation of the per-partition pushdown results of one
table (what ``engine.execute_requests`` hands to ``Query.compute``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Tuple

from repro_torch.queryproc import expressions as ex

# (out_name, agg_fn, in_col); agg_fn in {"sum","count","min","max","mean"};
# "count" ignores in_col.
AggSpec = Tuple[str, str, str]
# (out_name, (in_cols...), fn) — same shape as PushPlan.derive entries.
DeriveSpec = Tuple[str, Tuple[str, ...], Callable]


class Node:
    """Base class; concrete nodes are frozen dataclasses."""

    def inputs(self) -> Tuple["Node", ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), Node))


@dataclasses.dataclass(frozen=True)
class Scan(Node):
    """Leaf: scan of a base table. ``columns`` are the base columns this
    branch exports downstream (derived columns are added by Map nodes)."""
    table: str
    columns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Merged(Node):
    """Residual leaf: merged per-partition pushdown results of ``table``."""
    table: str


@dataclasses.dataclass(frozen=True)
class Filter(Node):
    child: Node
    predicate: ex.Expr


@dataclasses.dataclass(frozen=True)
class Project(Node):
    child: Node
    columns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Map(Node):
    """Row-wise derived columns (S3-Select-style scalar expressions)."""
    child: Node
    derives: Tuple[DeriveSpec, ...]


@dataclasses.dataclass(frozen=True)
class Aggregate(Node):
    child: Node
    keys: Tuple[str, ...]
    aggs: Tuple[AggSpec, ...]


@dataclasses.dataclass(frozen=True)
class Join(Node):
    """Hash equi-join; argument order matches ops.hash_join(left, right)."""
    left: Node
    right: Node
    lkey: str
    rkey: str


@dataclasses.dataclass(frozen=True)
class SemiJoin(Node):
    """Keep left rows with (anti: without) a key match on the right."""
    left: Node
    right: Node
    lkey: str
    rkey: str
    anti: bool = False


@dataclasses.dataclass(frozen=True)
class Shuffle(Node):
    """Redistribution requirement on ``key`` for the downstream join
    (drives the Fig-15 shuffle-pushdown evaluation; row-preserving)."""
    child: Node
    key: str


@dataclasses.dataclass(frozen=True)
class TopK(Node):
    child: Node
    col: str
    k: int
    ascending: bool = False


@dataclasses.dataclass(frozen=True)
class Sort(Node):
    child: Node
    columns: Tuple[str, ...]
    ascending: bool = True


@dataclasses.dataclass(frozen=True)
class PyOp(Node):
    """Escape hatch for compute-only logic with no relational encoding
    (e.g. Q15's having-max, Q22's data-dependent threshold). ``fn`` takes
    one ColumnTable per input node; never pushdown-amenable."""
    children: Tuple[Node, ...]
    fn: Callable
    note: str = ""

    def inputs(self) -> Tuple[Node, ...]:
        return self.children


UNARY_TYPES = (Filter, Project, Map, Aggregate, Shuffle, TopK, Sort)


def walk(node: Node) -> Iterator[Node]:
    """Preorder DAG walk (each node yielded once)."""
    seen = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        yield n
        stack.extend(reversed(n.inputs()))


def scans(node: Node) -> List[Scan]:
    return [n for n in walk(node) if isinstance(n, Scan)]


def base_tables(node: Node) -> List[str]:
    return sorted({s.table for s in scans(node)})


def rebuild_unary(node: Node, child: Node) -> Node:
    """Copy a unary node onto a new input."""
    assert isinstance(node, UNARY_TYPES), node
    return dataclasses.replace(node, child=child)


def describe(node: Node) -> str:
    """One-line structural signature, e.g. 'Join(Merged[a],Merged[b])'."""
    if isinstance(node, (Scan, Merged)):
        tag = "Scan" if isinstance(node, Scan) else "Merged"
        return f"{tag}[{node.table}]"
    name = type(node).__name__
    return f"{name}({','.join(describe(i) for i in node.inputs())})"


def op_counts(node: Node) -> dict:
    """Multiset of node-type names — the residual-shape golden signature."""
    out: dict = {}
    for n in walk(node):
        out[type(n).__name__] = out.get(type(n).__name__, 0) + 1
    return out
