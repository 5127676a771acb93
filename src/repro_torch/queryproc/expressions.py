"""Predicate expression trees: torch evaluation + selectivity estimation.

Port of ``repro.queryproc.expressions``, ``implies`` included. The numpy
engine compares a column with a constant under numpy's promotion rules
(NEP 50: a Python scalar is "weak", so an f32 column meets ``0.05`` in
f32 while an i32 column meets it in f64). Torch promotes differently (an
i32 tensor meets a Python float in f32), so every comparison here first
casts both sides to ``compare_dtype`` — the one place the port states
numpy's rules. The kernels' postfix programs
(``repro_torch.kernels.program``) use the same function, so the GPU and
the numpy engine select the same rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.queryproc.table import ColumnStats


class Expr:
    def __and__(self, other):
        return And(self, other)

    def __or__(self, other):
        return Or(self, other)


@dataclasses.dataclass
class Col(Expr):
    name: str

    def __le__(self, v):  # noqa: allow rich predicates
        return Cmp("<=", self, v)

    def __lt__(self, v):
        return Cmp("<", self, v)

    def __ge__(self, v):
        return Cmp(">=", self, v)

    def __gt__(self, v):
        return Cmp(">", self, v)

    def eq(self, v):
        return Cmp("==", self, v)

    def isin(self, vals):
        return In(self, tuple(vals))

    def between(self, lo, hi):
        return Cmp(">=", self, lo) & Cmp("<", self, hi)


@dataclasses.dataclass
class Cmp(Expr):
    op: str
    col: Col
    value: Any  # scalar, or Col for a column-column comparison


@dataclasses.dataclass
class In(Expr):
    col: Col
    values: Tuple


@dataclasses.dataclass
class And(Expr):
    left: Expr
    right: Expr


@dataclasses.dataclass
class Or(Expr):
    left: Expr
    right: Expr


CMP_OPS = ("<=", "<", ">=", ">", "==")
_TORCH_OPS = {"<=": torch.le, "<": torch.lt, ">=": torch.ge, ">": torch.gt,
              "==": torch.eq}
_NP_OF = {torch.int32: np.int32, torch.int64: np.int64,
          torch.float32: np.float32, torch.float64: np.float64}


def compare_dtype(col_dtype: torch.dtype, other) -> torch.dtype:
    """The dtype numpy compares ``col <op> other`` in, as torch's int64,
    float32 or float64. ``other`` is a column dtype (column-column
    compare), a tuple (``In``: ``np.isin`` makes a strongly typed array of
    it) or a scalar (weak when a Python number)."""
    if col_dtype not in _NP_OF:
        raise TypeError(f"unsupported column dtype {col_dtype}")
    a = _NP_OF[col_dtype]
    if isinstance(other, torch.dtype):
        rt = np.result_type(a, _NP_OF[other])
    elif isinstance(other, tuple):
        rt = np.result_type(a, np.asarray(other).dtype)
    else:
        rt = np.result_type(a, other)
    if rt.kind in "iu":
        return torch.int64  # exact for every int32/int64 operand
    if rt == np.float32:
        return torch.float32
    if rt == np.float64:
        return torch.float64
    raise TypeError(f"unsupported comparison {col_dtype} vs {other!r}")


def _scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    # a float constant compared in f32 rounds to f32 first, as numpy does
    return torch.tensor(np.asarray(v).astype(_NP_OF[dtype]), device=device)


def compile_expr(expr: Expr) -> Callable[[Dict[str, torch.Tensor]],
                                         torch.Tensor]:
    """Lower the tree once into a torch closure over a column dict that
    returns the boolean row mask numpy's ``compile_expr`` returns."""
    if isinstance(expr, Cmp):
        op = _TORCH_OPS[expr.op]
        name = expr.col.name
        if isinstance(expr.value, Col):
            rname = expr.value.name

            def colcol(cols):
                a, b = cols[name], cols[rname]
                dt = compare_dtype(a.dtype, b.dtype)
                return op(a.to(dt), b.to(dt))
            return colcol
        v = expr.value

        def colconst(cols):
            a = cols[name]
            dt = compare_dtype(a.dtype, v)
            return op(a.to(dt), _scalar(v, dt, a.device))
        return colconst
    if isinstance(expr, In):
        name, vals = expr.col.name, expr.values

        def isin(cols):
            a = cols[name]
            dt = compare_dtype(a.dtype, vals)
            return torch.isin(a.to(dt), _scalar(vals, dt, a.device))
        return isin
    if isinstance(expr, And):
        lf, rf = compile_expr(expr.left), compile_expr(expr.right)
        return lambda cols: lf(cols) & rf(cols)
    if isinstance(expr, Or):
        lf, rf = compile_expr(expr.left), compile_expr(expr.right)
        return lambda cols: lf(cols) | rf(cols)
    raise TypeError(expr)


# leaf arithmetic of ``implies``: numpy's comparisons of the plan's Python
# constants, as the reference makes them
_NP_CMP = {"<=": np.less_equal, "<": np.less, ">=": np.greater_equal,
           ">": np.greater, "==": np.equal}


def implies(a, b) -> bool:
    """Conservative implication: True means every row satisfying ``a``
    also satisfies ``b``; False means "could not prove". ``None`` is the
    vacuous predicate (all rows), so anything implies ``None`` and ``None``
    implies only ``None``. An ``And`` antecedent proves through either
    side, an ``Or`` antecedent through both; leaves compare intervals and
    memberships over one column. The result cache (``core.result_cache``)
    asks it whether a cached looser-predicate result can serve a tighter
    request after a re-filter."""
    if b is None:
        return True
    if a is None:
        return False
    if repr(a) == repr(b):
        return True
    if isinstance(b, And):
        return implies(a, b.left) and implies(a, b.right)
    if isinstance(a, And):
        # either conjunct alone proving b suffices (both hold on a's rows)
        if implies(a.left, b) or implies(a.right, b):
            return True
    if isinstance(a, Or):
        return implies(a.left, b) and implies(a.right, b)
    if isinstance(b, Or):
        return implies(a, b.left) or implies(a, b.right)
    return _atom_implies(a, b)


def _atom_implies(a: Expr, b: Expr) -> bool:
    """Leaf-level implication between two atoms over the *same* column."""
    if isinstance(a, And) or isinstance(b, And):
        return False  # an unproven conjunct pair reaching a leaf b
    col_a = a.col.name if isinstance(a, (Cmp, In)) else None
    col_b = b.col.name if isinstance(b, (Cmp, In)) else None
    if col_a is None or col_a != col_b:
        return False
    # column-column compares carry no interval: repr equality (done) only
    if (isinstance(a, Cmp) and isinstance(a.value, Col)) or \
            (isinstance(b, Cmp) and isinstance(b.value, Col)):
        return False
    if isinstance(a, In) and isinstance(b, In):
        return set(a.values) <= set(b.values)
    if isinstance(a, In) and isinstance(b, Cmp):
        op = _NP_CMP[b.op]
        return all(bool(op(v, b.value)) for v in a.values)
    if isinstance(a, Cmp) and isinstance(b, In):
        return a.op == "==" and a.value in b.values
    if isinstance(a, Cmp) and isinstance(b, Cmp):
        va, vb = a.value, b.value
        if b.op in ("<", "<="):
            if a.op == "<" and va <= vb:
                return True
            if a.op == "<=" and (va < vb if b.op == "<" else va <= vb):
                return True
            return a.op == "==" and bool(_NP_CMP[b.op](va, vb))
        if b.op in (">", ">="):
            if a.op == ">" and va >= vb:
                return True
            if a.op == ">=" and (va > vb if b.op == ">" else va >= vb):
                return True
            return a.op == "==" and bool(_NP_CMP[b.op](va, vb))
        if b.op == "==":
            return a.op == "==" and va == vb
    return False


def columns_of(expr: Expr) -> set:
    if isinstance(expr, Cmp):
        if isinstance(expr.value, Col):
            return {expr.col.name, expr.value.name}
        return {expr.col.name}
    if isinstance(expr, In):
        return {expr.col.name}
    if isinstance(expr, (And, Or)):
        return columns_of(expr.left) | columns_of(expr.right)
    raise TypeError(expr)


def estimate_selectivity(expr: Expr, stats: Dict[str, ColumnStats]) -> float:
    """Uniform-range cardinality estimate (the paper's lightweight model)."""
    if isinstance(expr, Cmp):
        if isinstance(expr.value, Col):
            return 0.5  # column-column compare: no per-column range applies
        st = stats.get(expr.col.name)
        if st is None or st.max <= st.min:
            return 0.5
        span = st.max - st.min
        v = float(expr.value)
        if expr.op in ("<", "<="):
            return float(np.clip((v - st.min) / span, 0.0, 1.0))
        if expr.op in (">", ">="):
            return float(np.clip((st.max - v) / span, 0.0, 1.0))
        return 1.0 / max(1, st.ndv)
    if isinstance(expr, In):
        st = stats.get(expr.col.name)
        return min(1.0, len(expr.values) / max(1, st.ndv if st else 10))
    if isinstance(expr, And):
        return (estimate_selectivity(expr.left, stats)
                * estimate_selectivity(expr.right, stats))
    if isinstance(expr, Or):
        a = estimate_selectivity(expr.left, stats)
        b = estimate_selectivity(expr.right, stats)
        return a + b - a * b
    raise TypeError(expr)


def compile_selectivity(expr: Expr) -> Callable[[Dict[str, ColumnStats]],
                                                float]:
    """Compile-once form of ``estimate_selectivity``: a closure over a stats
    dict giving the identical estimate without re-walking the tree per
    partition (partitions differ only in their stats)."""
    if isinstance(expr, Cmp):
        if isinstance(expr.value, Col):
            return lambda stats: 0.5
        name, op = expr.col.name, expr.op
        v = float(expr.value)

        def cmp_sel(stats: Dict[str, ColumnStats]) -> float:
            st = stats.get(name)
            if st is None or st.max <= st.min:
                return 0.5
            span = st.max - st.min
            if op in ("<", "<="):
                return float(np.clip((v - st.min) / span, 0.0, 1.0))
            if op in (">", ">="):
                return float(np.clip((st.max - v) / span, 0.0, 1.0))
            return 1.0 / max(1, st.ndv)
        return cmp_sel
    if isinstance(expr, In):
        name, n_vals = expr.col.name, len(expr.values)

        def in_sel(stats: Dict[str, ColumnStats]) -> float:
            st = stats.get(name)
            return min(1.0, n_vals / max(1, st.ndv if st else 10))
        return in_sel
    if isinstance(expr, And):
        lf, rf = compile_selectivity(expr.left), compile_selectivity(expr.right)
        return lambda stats: lf(stats) * rf(stats)
    if isinstance(expr, Or):
        lf, rf = compile_selectivity(expr.left), compile_selectivity(expr.right)

        def or_sel(stats: Dict[str, ColumnStats]) -> float:
            a, b = lf(stats), rf(stats)
            return a + b - a * b
        return or_sel
    raise TypeError(expr)

