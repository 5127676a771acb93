"""A plain reference of a compute cluster's shuffle (§4.2, Fig 15), in plain
PyTorch over dicts of CPU tensors. It imports neither JAX nor either
package, so a test can hold the port's routing, per-node joins and
compute-fabric bytes to it.

- ``partition_ids``: the partition function, from its definition (Knuth's
  multiplicative hash of the key's low 32 bits, shifted right by 16,
  modulo ``n``).
- ``route``: each node's rows of one table from its requests' results in
  request order, a result routed at compute landing on node ``index mod
  n`` first; the rows routed at compute and the bytes that leave their
  landing node.
- ``evaluate``: a residual plan over whole tables and per-node ones, a
  join of two inputs split on its keys run once a node with ``join``, a
  split input against a whole one once a node with the whole side
  broadcast (a semi-join alike, its rows matched by the caller), anything
  else gathered to node 0 first; the broadcast and gathered bytes.
  Operators other than joins are the caller's ``apply``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

KNUTH = 2654435761   # 2**32 / the golden ratio, rounded to an odd number
Table = Dict[str, torch.Tensor]


def partition_ids(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``((low32(key) * KNUTH) mod 2**32 >> 16) mod n`` of integer keys
    (a signed key's low 32 bits are those of its two's complement). The
    constant is split in 16-bit halves so no product passes 2**63."""
    k = keys.to(torch.int64) & 0xFFFFFFFF
    lo = k * (KNUTH & 0xFFFF)
    hi = ((k * (KNUTH >> 16)) & 0xFFFF) << 16
    return ((((lo + hi) & 0xFFFFFFFF) >> 16) % n).to(torch.int32)


def rows(t: Table) -> int:
    return len(next(iter(t.values()))) if t else 0


def nbytes(t: Table) -> int:
    return sum(v.numel() * v.element_size() for v in t.values())


def take(t: Table, idx: torch.Tensor) -> Table:
    return {c: v[idx] for c, v in t.items()}


def concat(tables: Sequence[Table]) -> Table:
    return {c: torch.cat([t[c] for t in tables]) for c in tables[0]}


def landing(index: int, n: int) -> int:
    """The node a result routed at compute lands on first: round-robin
    over the table's partitions."""
    return index % n


def route(results: Sequence[Tuple[int, Table, bool]], key: str, n: int
          ) -> Tuple[List[Table], int, int]:
    """(each node's table, rows routed at compute, bytes of them off their
    landing node) of one table from ``(partition index, result, routed at
    compute)`` per request, in request order."""
    nodes: List[List[Table]] = [[] for _ in range(n)]
    routed = off = 0
    for index, t, at_compute in results:
        pid = partition_ids(t[key], n)
        for i in range(n):
            piece = take(t, pid == i)
            nodes[i].append(piece)
            if at_compute and i != landing(index, n):
                off += nbytes(piece)
        if at_compute:
            routed += rows(t)
    return [concat(ps) for ps in nodes], routed, off


def join(left: Table, right: Table, lkey: str, rkey: str) -> Table:
    """Inner equi-join, by brute force: every (left, right) pair of equal
    keys; left columns, then right ones (``r_`` before a name the left
    has, the right key left out when both keys share a name)."""
    eq = left[lkey].to(torch.int64)[:, None] == right[rkey].to(
        torch.int64)[None, :]
    li, ri = torch.nonzero(eq, as_tuple=True)
    out = {c: v[li] for c, v in left.items()}
    for c, v in right.items():
        if c != rkey or lkey != rkey:
            out[c if c not in out else f"r_{c}"] = v[ri]
    return out


class Split:
    """A table over the nodes: ``nodes[i]`` on node ``i``, placed by the
    hash of ``key`` (None: by no column the table still holds)."""

    def __init__(self, nodes: List[Table], key: Optional[str]):
        self.nodes, self.key = nodes, key


class Cluster:
    """The compute fabric's bytes of one evaluation."""

    def __init__(self, n: int):
        self.n = n
        self.broadcast_bytes = 0
        self.gather_bytes = 0

    def whole(self, v) -> Table:
        if not isinstance(v, Split):
            return v
        self.gather_bytes += sum(nbytes(t) for t in v.nodes[1:])
        return concat(v.nodes)


def _kind(node) -> str:
    return type(node).__name__


def evaluate(node, leaves: Dict[str, object], n: int,
             apply: Callable[[object, List[Table]], Table]
             ) -> Tuple[Table, Cluster]:
    """(the answer, the fabric's bytes) of a residual plan whose
    ``Merged`` leaves are ``leaves`` (a whole table, or a ``Split``)."""
    cl = Cluster(n)
    memo: Dict[int, object] = {}

    def ev(x):
        if id(x) not in memo:
            memo[id(x)] = step(x)
        return memo[id(x)]

    def step(x):
        kind = _kind(x)
        if kind in ("Merged", "Scan"):
            return leaves[x.table]
        if kind == "Shuffle":
            return ev(x.child)
        ins = [ev(c) for c in x.inputs()]
        if kind == "PyOp":
            return apply(x, [cl.whole(v) for v in ins])
        split = [isinstance(v, Split) for v in ins]
        if kind in ("Project", "Filter", "Map") and split[0]:
            return Split([apply(x, [t]) for t in ins[0].nodes], ins[0].key)
        if kind == "Join":
            left, right = ins
            if all(split) and left.key == x.lkey and right.key == x.rkey:
                return Split([join(a, b, x.lkey, x.rkey)
                              for a, b in zip(left.nodes, right.nodes)],
                             left.key)
            if split == [True, False]:
                cl.broadcast_bytes += nbytes(right) * (n - 1)
                return Split([join(a, right, x.lkey, x.rkey)
                              for a in left.nodes], left.key)
            if split == [False, True]:
                cl.broadcast_bytes += nbytes(left) * (n - 1)
                return Split([join(left, b, x.lkey, x.rkey)
                              for b in right.nodes],
                             x.lkey if right.key == x.rkey else None)
            return join(cl.whole(left), cl.whole(right), x.lkey, x.rkey)
        if kind == "SemiJoin" and split[0]:
            left, right = ins
            if not split[1]:
                cl.broadcast_bytes += nbytes(right) * (n - 1)
                return Split([apply(x, [a, right]) for a in left.nodes],
                             left.key)
            if left.key == x.lkey and right.key == x.rkey:
                return Split([apply(x, [a, b]) for a, b in
                              zip(left.nodes, right.nodes)], left.key)
        return apply(x, [cl.whole(v) for v in ins])

    return cl.whole(ev(node)), cl
