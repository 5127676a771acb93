"""fused_scan_agg: predicate -> keep mask -> per-group sum and count.

Replaces the TPU kernel ``repro/kernels/fused_scan_agg.py::fused_scan_agg``
(its ``pl.pallas_call``), a one-hot MXU contraction gated by the traced
predicate. The CUDA kernel (``csrc/fused_scan_agg.cu``) interprets the
same postfix program as ``predicate_bitmap`` over tiles of 32x8 rows per
warp; each warp combines a tile's kept rows group by group (registers,
then one shuffle tree) and adds one sum and one count per group with
atomics, or one per row once a tile spans too many groups: into
shared-memory partials per block for G up to 3072, into global memory
above. Sums accumulate in f64, counts exactly.

Bound on the card: bytes — the predicate columns read once, ids and values
of the kept rows, and G sums and counts written, at 3.35 TB/s.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, _launch, ref
from repro_torch.kernels.program import DTYPE_CODES, Program

VALUE_DTYPES = (torch.float32, torch.float64)


def check_agg_inputs(ids: torch.Tensor, values: Optional[torch.Tensor],
                     num_groups: int) -> None:
    _launch.check_vector(ids, "ids", (torch.int32,), ids.device)
    if values is not None:
        _launch.check_vector(values, "values", VALUE_DTYPES, ids.device,
                             ids.shape[0])
    if not 0 <= num_groups < 2 ** 31:
        raise ValueError(f"num_groups {num_groups} out of range")


def agg_outputs(num_groups: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros(num_groups, dtype=torch.float64, device=device),
            torch.zeros(num_groups, dtype=torch.int64, device=device))


def fused_scan_agg(prog: Optional[Program], cols: Sequence[torch.Tensor],
                   ids: torch.Tensor, values: Optional[torch.Tensor],
                   num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (G,) f64, counts (G,) int64) over the rows that pass ``prog``
    (all rows when None) and whose int32 id lies in [0, G). ``values``
    may be f32, f64, or None for counts only."""
    check_agg_inputs(ids, values, num_groups)
    R, dev = ids.shape[0], ids.device
    if prog is not None:
        _launch.check_program_cols(prog, cols, dev, R)
    if dev.type == "cpu":
        return ref.fused_scan_agg(prog, cols, ids, values, num_groups)
    _launch.reject_device(dev)
    sums, counts = agg_outputs(num_groups, dev)
    if R == 0 or num_groups == 0:
        return sums, counts
    args, _keep = _launch.program_args(prog, cols if prog is not None else ())
    max_blocks, stream = _launch.launch_config(dev)
    lib = _build.library("fused_scan_agg")
    _launch.raise_on(lib.fused_scan_agg_launch(
        *args, ids.data_ptr(),
        values.data_ptr() if values is not None else None,
        DTYPE_CODES[values.dtype] if values is not None else -1,
        R, num_groups, sums.data_ptr(), counts.data_ptr(), max_blocks,
        stream), "fused_scan_agg")
    fused_scan_agg.launches += 1
    return sums, counts


fused_scan_agg.launches = 0
