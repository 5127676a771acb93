"""Op-level entry points with the signatures of ``repro.kernels.ops``.

A shim for the parity tests against the JAX package: it compiles the
predicate on every call and casts counts to int32 as the JAX ops do. The
engine calls the kernel wrappers (``predicate_bitmap``,
``fused_scan_agg``, ``grouped_agg``) directly, with a program compiled
once per plan, f64 sums and int64 counts.

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

from repro_torch.kernels import fused_scan_agg as _fsa
from repro_torch.kernels import grouped_agg as _ga
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
    (``None`` keeps every row)."""
    prog = program_for(expr, cols) if expr is not None else None
    pcols = [cols[n] for n in prog.columns] if prog is not None else []
    return _outputs(*_fsa.fused_scan_agg(prog, pcols, ids, values,
                                         num_groups), values)
