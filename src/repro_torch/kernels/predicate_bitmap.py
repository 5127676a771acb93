"""predicate_bitmap: a postfix predicate program -> packed selection bitmap.

Replaces the TPU kernel ``repro/kernels/predicate_bitmap.py::predicate_bitmap``
(its ``pl.pallas_call``), whose predicate was a closure traced into the
kernel by ``compile_predicate``. Here the ``Expr`` tree is compiled once
into a postfix program (``kernels.program``) that the CUDA kernel
(``csrc/predicate_bitmap.cu``) interprets per row. Comparisons run in the
column's own type under numpy's rules, not in the TPU wrapper's f32.

Bound on the card: bytes — each distinct predicate column read once plus
R/8 bytes of words written, at 3.35 TB/s. Design: a persistent grid of up
to three blocks per SM stages tiles of every program column through a ring
of shared-memory stages, filled by one producer warp with 1-D bulk copies
(TMA; the unaligned head and tail rows of a view by ordinary loads) while
eight consumer warps interpret the program over the ready stage. So every
column is read from device memory once however many leaves read it, and
the loads overlap the interpretation. ``__ballot_sync`` over 32 rows forms
each little-endian word directly.
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import torch

from repro_torch.kernels import _build, _launch, ref
from repro_torch.kernels.program import Program, SplitProgram


def predicate_bitmap(prog: Program, cols: Sequence[torch.Tensor]
                     ) -> torch.Tensor:
    """(ceil(R/32),) int32 words carrying the uint32 bitmap of ``prog``
    over ``cols`` (one tensor per program column slot, any R)."""
    if not cols:
        raise ValueError("predicate_bitmap needs the program's columns")
    R, dev = cols[0].shape[0], cols[0].device
    _launch.check_program_cols(prog, cols, dev, R)
    if dev.type == "cpu":
        return ref.predicate_bitmap(prog, cols)
    _launch.reject_device(dev)
    words = torch.empty(-(-R // 32), dtype=torch.int32, device=dev)
    if R == 0:
        return words
    args, _keep = _launch.program_args(prog, cols)
    lib = _build.library("predicate_bitmap")
    _launch.raise_on(lib.predicate_bitmap_launch(
        *args, R, _launch.sm_count(dev), words.data_ptr(),
        _launch.stream_of(dev)),
        "predicate_bitmap")
    predicate_bitmap.launches += 1
    return words


predicate_bitmap.launches = 0


def predicate_words(prog: Union[Program, SplitProgram],
                    cols: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The words of a program or of a split one over named columns: one
    ``predicate_bitmap`` launch per program of the split, the words
    combined with ``&``/``|`` on the columns' device (bits past R are 0 in
    every part, so they stay 0)."""
    if isinstance(prog, Program):
        return predicate_bitmap(prog, [cols[c] for c in prog.columns])
    left = predicate_words(prog.left, cols)
    right = predicate_words(prog.right, cols)
    return left & right if prog.op == "and" else left | right
