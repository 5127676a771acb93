"""Expr tree -> postfix predicate program shared by the CUDA kernels.

The TPU kernels took the predicate as a traced closure that Pallas inlined
into each kernel body (``repro.kernels.predicate_bitmap.compile_predicate``).
CUDA has no such tracing, and generating source per plan would mean a
build per query. Instead the tree is compiled once into a short postfix
program of int32 opcodes plus a constant pool, which one device function
(``csrc/program.cuh``) interprets per row. Every lane runs the same
program, so the interpretation does not diverge.

Op encoding, one int32 quad ``(code, col, x, y)`` per op, with
``code = kind | cmp << 4 | mode << 8``:

- ``CMP``:     push ``col <cmp> const[x]``
- ``CMP_COL``: push ``col <cmp> col x``
- ``IN``:      push ``col == const[x] or ... or col == const[x + y - 1]``
- ``IN_POOL``: push ``col in pool[x:x + y]``, a sorted list the kernel
  binary-searches (an ``In`` of more than ``INLINE_IN_MAX`` values)
- ``AND``/``OR``: pop two, push the result

``mode`` (3 bits) is how the comparison runs, chosen by
``expressions.compare_dtype`` (numpy's rules): exact int64, exact
unsigned 64-bit, a uint64 column against a signed one, float32 or
float64; the launch may narrow an int64 leaf to int32 (``MODE_I32`` in
``csrc/program.cuh``). A column may hold any dtype of ``DTYPE_CODES``;
the kernels load it at its stored width and convert it to the mode's
type. Constants come rounded and in range (``cmp_leaf``, ``in_leaf``):
integers as int64 (a uint64 one as its bits), floats as f64 values. The
pool holds int64 values (the bits of uint64 ones, in unsigned order), or
the bits of f64 values for the float modes (rounded to f32 first in f32
mode); it goes to the device once per program (``Program.pool_on``) and
the kernels take it by pointer. The stack is one 32-bit register, so a
program may nest 32 deep.

A predicate past the by-value limits (``MAX_OPS`` ops, ``MAX_CONSTS``
inline constants, ``MAX_COLS`` columns, depth ``MAX_DEPTH``) compiles to
a ``SplitProgram``: the tree cut at ``And``/``Or`` nodes into programs
that fit, whose packed words combine with ``&``/``|``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from repro_torch.queryproc import expressions as ex

K_CMP, K_CMP_COL, K_IN, K_AND, K_OR, K_IN_POOL = range(6)
# expressions.compare_dtype's modes -> the mode field (csrc/program.cuh:
# 3 is MODE_I32)
MODE_CODES = {"i64": 0, "f32": 1, "f64": 2, "u64": 4, "mixed": 5}
MODE_OF = {v: k for k, v in MODE_CODES.items()}
DTYPE_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3, torch.bool: 4, torch.uint8: 5,
               torch.int8: 6, torch.int16: 7, torch.uint16: 8,
               torch.uint32: 9, torch.uint64: 10, torch.float16: 11}

# limits of the kernels' by-value parameter block (csrc/program.cuh)
MAX_OPS, MAX_CONSTS, MAX_COLS, MAX_DEPTH = 64, 64, 8, 32
# an In of more values is pooled: a binary search of 16 values takes 5
# dependent steps, the inline scan 16 compares
INLINE_IN_MAX = 16


@dataclasses.dataclass(frozen=True)
class Program:
    ops: np.ndarray            # (n_ops, 4) int32
    fconst: np.ndarray         # (n_consts,) float64
    iconst: np.ndarray         # (n_consts,) int64
    columns: Tuple[str, ...]   # column slot -> name
    dtypes: Tuple[torch.dtype, ...]
    pool: np.ndarray           # (n_pool,) int64: the IN_POOL lists
    _pools: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def pool_on(self, device: torch.device) -> torch.Tensor:
        """The pool as a tensor on ``device``, copied there once."""
        if device not in self._pools:
            self._pools[device] = torch.from_numpy(self.pool).to(device)
        return self._pools[device]


@dataclasses.dataclass(frozen=True)
class SplitProgram:
    """A predicate too large for one program: its ``left`` and ``right``
    subtrees (each a ``Program`` or ``SplitProgram``), whose selections
    combine by ``op`` (``"and"`` or ``"or"``)."""
    op: str
    left: Union[Program, "SplitProgram"]
    right: Union[Program, "SplitProgram"]

    @property
    def columns(self) -> Tuple[str, ...]:
        return tuple(sorted(set(self.left.columns) | set(self.right.columns)))


def _int_bits(vals, mode: str) -> np.ndarray:
    """Integer constants (in the mode's range) as int64: a uint64 mode's as
    the bits of their uint64 values."""
    return np.asarray(vals, np.uint64 if mode == "u64" else np.int64
                      ).reshape(-1).view(np.int64)


def _pooled(vals, mode: str) -> np.ndarray:
    """A pooled In list of ``in_leaf`` constants: sorted (a uint64 mode's
    in unsigned order), deduplicated, NaN dropped (it matches no row), as
    int64 values or the bits of f64 ones."""
    if mode in ("i64", "u64"):
        return _int_bits(np.unique(np.asarray(
            vals, np.uint64 if mode == "u64" else np.int64)), mode)
    v = np.asarray(vals, np.float64)
    return np.unique(v[~np.isnan(v)]).view(np.int64)


def _encode(expr: ex.Expr, dtypes: Dict[str, torch.dtype]
            ) -> Tuple[Program, bool]:
    """(the program of ``expr`` for columns of the given dtypes, whether
    it fits the kernels' limits)."""
    names = sorted(ex.columns_of(expr))
    slot = {n: i for i, n in enumerate(names)}
    ops: List[Tuple[int, int, int, int]] = []
    fc: List[float] = []
    ic: List[int] = []
    pool: List[np.ndarray] = []
    n_pool = [0]
    depth = [0, 0]  # current, max

    def push():
        depth[0] += 1
        depth[1] = max(depth[1], depth[0])

    def const(vals, mode: str) -> int:
        start = len(fc)
        if mode in ("i64", "u64"):
            ic.extend(_int_bits(vals, mode).tolist())
            fc.extend(0.0 for _ in vals)
        else:
            fc.extend(float(v) for v in vals)
            ic.extend(0 for _ in vals)
        return start

    def walk(e):
        if isinstance(e, ex.Cmp):
            dt = dtypes[e.col.name]
            if isinstance(e.value, ex.Col):
                mode = ex.compare_dtype(dt, dtypes[e.value.name])
                ops.append((K_CMP_COL | ex.CMP_OPS.index(e.op) << 4
                            | MODE_CODES[mode] << 8, slot[e.col.name],
                            slot[e.value.name], 0))
            else:
                mode, op, c = ex.cmp_leaf(e.op, dt, e.value)
                ops.append((K_CMP | ex.CMP_OPS.index(op) << 4
                            | MODE_CODES[mode] << 8, slot[e.col.name],
                            const([c], mode), 0))
            push()
        elif isinstance(e, ex.In):
            mode, vals = ex.in_leaf(dtypes[e.col.name], e.values)
            if len(e.values) > INLINE_IN_MAX:
                vals = _pooled(vals, mode)
                ops.append((K_IN_POOL | MODE_CODES[mode] << 8,
                            slot[e.col.name], n_pool[0], len(vals)))
                pool.append(vals)
                n_pool[0] += len(vals)
            else:
                ops.append((K_IN | MODE_CODES[mode] << 8, slot[e.col.name],
                            const(vals, mode), len(vals)))
            push()
        elif isinstance(e, (ex.And, ex.Or)):
            walk(e.left)
            walk(e.right)
            ops.append((K_AND if isinstance(e, ex.And) else K_OR, 0, 0, 0))
            depth[0] -= 1
        else:
            raise TypeError(e)

    walk(expr)
    fits = (len(ops) <= MAX_OPS and len(fc) <= MAX_CONSTS
            and len(names) <= MAX_COLS and depth[1] <= MAX_DEPTH)
    prog = Program(np.asarray(ops, np.int32).reshape(-1, 4),
                   np.asarray(fc, np.float64), np.asarray(ic, np.int64),
                   tuple(names), tuple(dtypes[n] for n in names),
                   np.concatenate(pool) if pool else np.zeros(0, np.int64))
    return prog, fits


def compile_predicate(expr: ex.Expr, dtypes: Dict[str, torch.dtype]
                      ) -> Union[Program, SplitProgram]:
    """One program when ``expr`` fits the limits, else the tree split at
    its ``And``/``Or`` nodes until every part fits."""
    prog, fits = _encode(expr, dtypes)
    if fits:
        return prog
    if not isinstance(expr, (ex.And, ex.Or)):
        raise ValueError(f"predicate leaf too large for a kernel program: "
                         f"{expr!r}")
    return SplitProgram("and" if isinstance(expr, ex.And) else "or",
                        compile_predicate(expr.left, dtypes),
                        compile_predicate(expr.right, dtypes))


def program_for(expr: ex.Expr, cols: Dict[str, torch.Tensor]
                ) -> Union[Program, SplitProgram]:
    return compile_predicate(expr, {n: cols[n].dtype
                                    for n in ex.columns_of(expr)})
