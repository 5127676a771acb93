"""Op-level entry points with the signatures of ``repro.kernels.ops``.

A shim for the parity tests against the JAX package: it compiles the
predicate on every call and casts counts to int32 as the JAX ops do. The
engine calls the kernel wrappers directly, with a program compiled once
per plan, f64 sums and int64 counts.

Any row count R (the kernels need no padding: the bitmap kernel masks
its tail word by construction, the aggregation kernel drops ids outside
[0, G) the way the TPU wrapper's poison group did). Predicates come as an
``Expr`` plus a column dict instead of a traced closure. Sums come back in
the values' dtype, counts as int32 as in the JAX package. CUDA tensors launch the CUDA
kernels; CPU tensors run the plain versions in ``kernels.ref``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import bitmap_apply as _ba
from repro_torch.kernels import fused_scan_agg as _fsa
from repro_torch.kernels import fused_scan_shuffle as _fss
from repro_torch.kernels import grouped_agg as _ga
from repro_torch.kernels import hash_partition as _hp
from repro_torch.kernels import predicate_bitmap as _pb
from repro_torch.kernels.program import program_for
from repro_torch.queryproc.expressions import Expr


def predicate_bitmap(cols: Dict[str, torch.Tensor], expr: Expr
                     ) -> torch.Tensor:
    """Packed (ceil(R/32),) bitmap of ``expr`` as int32 words holding
    uint32 bits."""
    prog = program_for(expr, cols)
    return _pb.predicate_bitmap(prog, [cols[n] for n in prog.columns])


def _outputs(sums: torch.Tensor, counts: torch.Tensor,
             values: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = values.dtype if values is not None else torch.float64
    return sums.to(dt), counts.to(torch.int32)


def grouped_agg(ids: torch.Tensor, values: Optional[torch.Tensor],
                num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (G,), counts (G,) int32)."""
    return _outputs(*_ga.grouped_agg(ids, values, num_groups), values)


def fused_scan_agg(cols: Dict[str, torch.Tensor], expr: Optional[Expr],
                   ids: torch.Tensor, values: Optional[torch.Tensor],
                   num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (G,), counts (G,) int32) over the rows passing ``expr``
    (``None`` keeps every row): one value column, as in the JAX package, in
    a one-value launch of the kernel."""
    prog = program_for(expr, cols) if expr is not None else None
    pcols = [cols[n] for n in prog.columns] if prog is not None else []
    sums, counts = _fsa.fused_scan_agg(
        prog, pcols, ids, [] if values is None else [values], num_groups)
    return _outputs(sums[0] if values is not None else
                    torch.zeros(num_groups, dtype=torch.float64,
                                device=ids.device), counts, values)


def bitmap_apply(words: torch.Tensor, col: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked column (R,), total selected count as a 0-d int32 tensor)."""
    masked, count = _ba.bitmap_apply(words, col)
    return masked, count.to(torch.int32)


def hash_partition(keys: torch.Tensor, num_parts: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pids (R,) int32, rows per target (P,) int32)."""
    pids, hist = _hp.hash_partition(keys, num_parts)
    return pids, hist.to(torch.int32)


def fused_scan_shuffle(cols: Dict[str, torch.Tensor], expr: Optional[Expr],
                       keys: torch.Tensor, num_parts: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(words (ceil(R/32),) int32 of the rows passing ``expr`` (``None``
    keeps every row), pids (R,) int32, kept rows per target (P,) int32)."""
    prog = program_for(expr, cols) if expr is not None else None
    pcols = [cols[n] for n in prog.columns] if prog is not None else []
    words, pids, hist = _fss.fused_scan_shuffle(prog, pcols, keys, num_parts)
    return words, pids, hist.to(torch.int32)
