"""Predicate expression trees: torch evaluation + selectivity estimation.

Port of ``repro.queryproc.expressions``, ``implies`` included. The numpy
engine compares a column with a constant under numpy 2.0.2's rules
(NEP 50: a Python scalar is "weak", so an f32 column meets ``0.05`` in
f32 while an i32 column meets it in f64; two integer sides compare
exactly, an out-of-range Python int included). Torch promotes
differently and has few kernels for uint16/32/64, so every comparison here
runs in a mode of ``compare_dtype`` over keys of both sides
(``cmp_leaf``, ``in_leaf``, ``mode_key``) — the one place the port states
numpy's rules. The kernels' postfix programs
(``repro_torch.kernels.program``) use the same functions, so the GPU and
the numpy engine select the same rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.queryproc.table import (NP_OF, ColumnStats, as_float64,
                                         as_int64)


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
TORCH_OPS = {"<=": torch.le, "<": torch.lt, ">=": torch.ge, ">": torch.gt,
              "==": torch.eq}
_I64 = (-2 ** 63, 2 ** 63 - 1)
_U64 = (0, 2 ** 64 - 1)


def _np(dtype: torch.dtype) -> np.dtype:
    if dtype not in NP_OF:
        raise TypeError(f"unsupported column dtype {dtype}")
    return np.dtype(NP_OF[dtype])


def _weak(v) -> bool:
    """A Python number, which numpy 2 types by the array it meets (NEP 50);
    a numpy scalar keeps its own dtype."""
    return isinstance(v, (bool, int, float)) and not isinstance(v, np.generic)


def _int_like(v) -> bool:
    return isinstance(v, (bool, int, np.integer, np.bool_))


def compare_dtype(col_dtype: torch.dtype, other) -> str:
    """The mode in which numpy 2.0.2 compares a column of ``col_dtype``
    with ``other``: a column dtype (column-column), a tuple (``In``:
    ``np.isin`` makes an array of it) or a scalar (weak when a Python
    number). Two integer sides compare exactly, as numpy's comparison
    loops do whatever their signedness and an out-of-range Python int:
    ``"i64"`` (every bool and integer dtype but uint64), ``"u64"`` (unsigned
    sides, one of them uint64) or ``"mixed"`` (a uint64 column against a
    signed one); any float side compares in numpy's result type, ``"f32"``
    (float16 too, which float32 orders exactly) or ``"f64"``."""
    a = _np(col_dtype)
    if isinstance(other, torch.dtype):
        b = _np(other)
        if a.kind in "biu" and b.kind in "biu":
            if np.uint64 in (a, b):
                return "u64" if a.kind in "bu" and b.kind in "bu" else \
                    "mixed"
            return "i64"
    elif isinstance(other, tuple):
        if a.kind in "biu" and all(_int_like(v) for v in other):
            return "u64" if a == np.uint64 else "i64"
        b = np.asarray(other).dtype
        if b == object:
            raise TypeError(f"unsupported In list {other!r}")
    elif _int_like(other) and a.kind in "biu":
        return "u64" if a == np.uint64 else "i64"
    elif _weak(other):
        b = type(other)(0)  # numpy types a weak scalar by its kind alone
    elif isinstance(other, np.generic):
        b = other.dtype
    else:
        raise TypeError(f"unsupported comparison {col_dtype} vs {other!r}")
    rt = np.result_type(a, b)
    if rt.kind != "f":
        raise TypeError(f"unsupported comparison {col_dtype} vs {other!r}")
    return "f32" if rt.itemsize <= 4 else "f64"


def _float_const(v, col_dtype: torch.dtype) -> float:
    """A float comparison's constant as numpy rounds it: a weak Python
    number to a float column's own type (``np.float32(v)``: an int through
    float64, as numpy does), a numpy scalar to the result type."""
    a = _np(col_dtype)
    if _weak(v):
        return float((a.type if a.kind == "f" else np.float64)(v))
    return float(np.asarray(v).astype(np.result_type(a, v)))


def cmp_leaf(op: str, col_dtype: torch.dtype, v):
    """``(mode, op, const)`` of ``col <op> v`` in a ``compare_dtype`` mode: the
    constant rounded as numpy rounds it, or an integer outside the mode's
    range replaced by an equivalent one inside it (``uint8 < 300`` holds
    for every row, as ``<= 2**63 - 1`` does)."""
    mode = compare_dtype(col_dtype, v)
    if mode in ("f32", "f64"):
        return mode, op, _float_const(v, col_dtype)
    lo, hi = _U64 if mode == "u64" else _I64
    c = int(v)
    if col_dtype == torch.bool and _weak(v) and not lo <= c <= hi:
        # numpy meets a bool column with a Python int in int64, and raises
        # for one past int64's range (an integer column compares exactly)
        raise OverflowError("Python int too large to convert to C long")
    if c > hi:
        return (mode, "<=", hi) if op in ("<", "<=") else (mode, "<", lo)
    if c < lo:
        return (mode, ">=", lo) if op in (">", ">=") else (mode, "<", lo)
    return mode, op, c


def in_leaf(col_dtype: torch.dtype, vals: Tuple):
    """``(mode, consts)`` of ``col in vals``: integers outside the mode's
    range dropped (no row can equal them), floats rounded to the result
    type."""
    mode = compare_dtype(col_dtype, vals)
    if mode in ("f32", "f64"):
        arr = np.asarray(vals).reshape(-1)
        rt = np.result_type(_np(col_dtype), arr.dtype)
        return mode, arr.astype(rt).astype(np.float64).tolist()
    lo, hi = _U64 if mode == "u64" else _I64
    return mode, [int(v) for v in vals if lo <= int(v) <= hi]


def mode_key(a: torch.Tensor, mode: str) -> torch.Tensor:
    """The column in a mode's key space: int64 values (``u64``: with the
    sign bit flipped, so that signed order is unsigned order) or floats."""
    if mode == "i64":
        return as_int64(a)
    if mode == "u64":
        return (a.view(torch.int64) if a.dtype == torch.uint64
                else as_int64(a)) ^ -2 ** 63
    f = as_float64(a)
    return f.to(torch.float32) if mode == "f32" else f


def mode_const(c, mode: str):
    """A leaf's constant in its mode's key space."""
    return c - 2 ** 63 if mode == "u64" else c


def compare_mixed(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a <op> b`` for a uint64 column against a signed one, exactly: a
    uint64 value at or past 2**63 exceeds every signed one, and the others
    compare as int64."""
    ka = a.view(torch.int64) if a.dtype == torch.uint64 else as_int64(a)
    kb = b.view(torch.int64) if b.dtype == torch.uint64 else as_int64(b)
    out = TORCH_OPS[op](ka, kb)
    for side, k, a_greater in ((a, ka, True), (b, kb, False)):
        if side.dtype == torch.uint64:
            out = torch.where(k < 0, TORCH_OPS[op](
                torch.tensor(int(a_greater)), torch.tensor(int(not a_greater))
            ).to(out.device), out)
    return out


def compile_expr(expr: Expr) -> Callable[[Dict[str, torch.Tensor]],
                                         torch.Tensor]:
    """Lower the tree once into a torch closure over a column dict that
    returns the boolean row mask numpy's ``compile_expr`` returns."""
    if isinstance(expr, Cmp):
        name = expr.col.name
        if isinstance(expr.value, Col):
            rname, op = expr.value.name, expr.op

            def colcol(cols):
                a, b = cols[name], cols[rname]
                mode = compare_dtype(a.dtype, b.dtype)
                if mode == "mixed":
                    return compare_mixed(op, a, b)
                return TORCH_OPS[op](mode_key(a, mode), mode_key(b, mode))
            return colcol
        v = expr.value

        def colconst(cols):
            a = cols[name]
            mode, op, c = cmp_leaf(expr.op, a.dtype, v)
            return TORCH_OPS[op](mode_key(a, mode), mode_const(c, mode))
        return colconst
    if isinstance(expr, In):
        name, vals = expr.col.name, expr.values

        def isin(cols):
            a = cols[name]
            mode, consts = in_leaf(a.dtype, vals)
            k = mode_key(a, mode)
            return torch.isin(k, torch.tensor(
                [mode_const(c, mode) for c in consts], dtype=k.dtype,
                device=a.device))
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

