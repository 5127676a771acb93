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
- ``AND``/``OR``: pop two, push the result

``mode`` is the type the comparison runs in, chosen by
``expressions.compare_dtype`` (numpy's rules): int64, float32 or float64.
The stack is one 32-bit register, so a program may nest 32 deep.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.queryproc import expressions as ex

K_CMP, K_CMP_COL, K_IN, K_AND, K_OR = range(5)
MODES = (torch.int64, torch.float32, torch.float64)
DTYPE_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3}

# limits of the kernels' by-value parameter block (csrc/program.cuh)
MAX_OPS, MAX_CONSTS, MAX_COLS, MAX_DEPTH = 64, 64, 8, 32


@dataclasses.dataclass(frozen=True)
class Program:
    ops: np.ndarray            # (n_ops, 4) int32
    fconst: np.ndarray         # (n_consts,) float64
    iconst: np.ndarray         # (n_consts,) int64
    columns: Tuple[str, ...]   # column slot -> name
    dtypes: Tuple[torch.dtype, ...]

    @property
    def n_ops(self) -> int:
        return len(self.ops)


def compile_program(expr: ex.Expr, dtypes: Dict[str, torch.dtype]
                    ) -> Program:
    """Encode ``expr`` for columns of the given dtypes."""
    names = sorted(ex.columns_of(expr))
    slot = {n: i for i, n in enumerate(names)}
    ops: List[Tuple[int, int, int, int]] = []
    fc: List[float] = []
    ic: List[int] = []
    depth = [0, 0]  # current, max

    def push():
        depth[0] += 1
        depth[1] = max(depth[1], depth[0])

    def const(vals, mode: torch.dtype) -> int:
        start = len(fc)
        arr = np.asarray(vals)
        if mode == torch.int64:
            ic.extend(int(v) for v in arr.reshape(-1))
            fc.extend(0.0 for _ in arr.reshape(-1))
        else:
            np_t = np.float32 if mode == torch.float32 else np.float64
            fc.extend(float(v) for v in arr.astype(np_t).reshape(-1))
            ic.extend(0 for _ in arr.reshape(-1))
        return start

    def walk(e):
        if isinstance(e, ex.Cmp):
            cmp = ex.CMP_OPS.index(e.op)
            dt = dtypes[e.col.name]
            if isinstance(e.value, ex.Col):
                mode = ex.compare_dtype(dt, dtypes[e.value.name])
                ops.append((K_CMP_COL | cmp << 4 | MODES.index(mode) << 8,
                            slot[e.col.name], slot[e.value.name], 0))
            else:
                mode = ex.compare_dtype(dt, e.value)
                ops.append((K_CMP | cmp << 4 | MODES.index(mode) << 8,
                            slot[e.col.name], const(e.value, mode), 0))
            push()
        elif isinstance(e, ex.In):
            mode = ex.compare_dtype(dtypes[e.col.name], e.values)
            ops.append((K_IN | MODES.index(mode) << 8, slot[e.col.name],
                        const(e.values, mode), len(e.values)))
            push()
        elif isinstance(e, (ex.And, ex.Or)):
            walk(e.left)
            walk(e.right)
            ops.append((K_AND if isinstance(e, ex.And) else K_OR, 0, 0, 0))
            depth[0] -= 1
        else:
            raise TypeError(e)

    walk(expr)
    if (len(ops) > MAX_OPS or len(fc) > MAX_CONSTS or len(names) > MAX_COLS
            or depth[1] > MAX_DEPTH):
        raise ValueError(f"predicate too large for the kernel program: "
                         f"{len(ops)} ops, {len(fc)} constants, "
                         f"{len(names)} columns, depth {depth[1]}")
    return Program(np.asarray(ops, np.int32).reshape(-1, 4),
                   np.asarray(fc, np.float64), np.asarray(ic, np.int64),
                   tuple(names), tuple(dtypes[n] for n in names))


def program_for(expr: ex.Expr, cols: Dict[str, torch.Tensor]) -> Program:
    return compile_program(expr, {n: cols[n].dtype
                                  for n in ex.columns_of(expr)})
