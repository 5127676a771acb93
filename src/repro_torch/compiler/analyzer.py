"""Pushdown-amenability analysis (the paper's §4.1 principle, executable).

Port of ``repro.compiler.analyzer``.

An operator is *pushdown-amenable* when a storage node can run it on its
own partition without coordination and without unbounded output:

- **partition-parallel** (local): ``op(concat(p1..pn))`` equals
  ``merge(op(p1)..op(pn))`` for a cheap merge — the operator distributes
  over the partitioning of its input table;
- **output-reducing** (bounded): the per-partition output is no larger than
  the input (selection, projection) or bounded by a constant (partial
  aggregation's group cap, top-k's K, the 1-bit/row selection bitmap).

Operators that align rows *across* partitions — joins, global sorts — fail
the first condition; opaque compute-layer code (``PyOp``) fails both by
construction. Partial aggregation and top-k pass with a *merge obligation*:
the compute layer must re-aggregate / re-select over the concatenated
partials (``partial=True`` below; the splitter emits the merge node).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.compiler import ir

# aggregation functions that decompose into per-partition partials + a merge
DECOMPOSABLE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


@dataclasses.dataclass(frozen=True)
class Amenability:
    pushable: bool
    partial: bool          # pushable, but the residual must merge partials
    reason: str


def classify(node: ir.Node) -> Amenability:
    """Amenability of a single operator, by the §4.1 criteria."""
    if isinstance(node, (ir.Scan, ir.Merged)):
        return Amenability(True, False,
                           "scan is partition-parallel by definition")
    if isinstance(node, ir.Filter):
        return Amenability(True, False,
                           "selection is row-local and output-reducing")
    if isinstance(node, ir.Project):
        return Amenability(True, False,
                           "projection is row-local and output-reducing")
    if isinstance(node, ir.Map):
        return Amenability(True, False,
                           "scalar expressions are row-local; output adds "
                           "one bounded column per derive")
    if isinstance(node, ir.Aggregate):
        bad = sorted({fn for _, fn, _ in node.aggs if fn not in DECOMPOSABLE})
        if bad:
            return Amenability(False, False,
                               f"aggregate fns {bad} are not decomposable "
                               "into partials + merge")
        return Amenability(True, True,
                           "decomposable aggregate: bounded per-partition "
                           "partials, compute layer merges")
    if isinstance(node, ir.TopK):
        return Amenability(True, True,
                           "top-k: per-partition top-k (K-bounded) is a "
                           "superset of the global top-k; re-select at merge")
    if isinstance(node, ir.Shuffle):
        return Amenability(True, False,
                           "partition function is row-local and bounded "
                           "(log2 n bits/row); §4.2 shuffle pushdown")
    if isinstance(node, (ir.Join, ir.SemiJoin)):
        return Amenability(False, False,
                           "join aligns rows across partitions of two "
                           "tables — not partition-parallel")
    if isinstance(node, ir.Sort):
        return Amenability(False, False,
                           "global sort is a cross-partition total order "
                           "and is not output-reducing")
    if isinstance(node, ir.PyOp):
        return Amenability(False, False,
                           "opaque compute-layer code: no locality or "
                           "boundedness guarantees")
    raise TypeError(f"unknown IR node: {node!r}")


def analyze(root: ir.Node) -> List[Tuple[ir.Node, Amenability]]:
    """Per-node classification for a whole plan (preorder)."""
    return [(n, classify(n)) for n in ir.walk(root)]


def report(root: ir.Node) -> Dict[str, Dict[str, int]]:
    """Summary: node-type -> {pushable, partial, blocked} counts."""
    out: Dict[str, Dict[str, int]] = {}
    for node, am in analyze(root):
        row = out.setdefault(type(node).__name__,
                             {"pushable": 0, "partial": 0, "blocked": 0})
        if am.partial:
            row["partial"] += 1
        elif am.pushable:
            row["pushable"] += 1
        else:
            row["blocked"] += 1
    return out
