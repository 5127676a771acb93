"""grouped_agg: per-group sum and count of every row.

Replaces the TPU kernel ``repro/kernels/grouped_agg.py::grouped_agg`` (its
``pl.pallas_call``, a one-hot MXU contraction capped at G <= 4096). On the
card it is the ``fused_scan_agg`` kernel body with an empty predicate
program (``csrc/fused_scan_agg.cu::grouped_agg_launch``), with its own
entry point and launch count; G is not capped (above 3072 groups its
atomics go to global memory). It carries the residual group-bys: Q1's
final merge, Q3's group by orderkey (about 1.2e5 groups at sf=1000),
Q12's by shipmode.

Bound on the card: bytes — ids and values read once, G sums and counts
written, at 3.35 TB/s.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _launch, ref
from repro_torch.kernels.fused_scan_agg import agg_outputs, check_agg_inputs
from repro_torch.kernels.program import DTYPE_CODES


def grouped_agg(ids: torch.Tensor, values: Optional[torch.Tensor],
                num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (G,) f64, counts (G,) int64) over the rows whose int32 id lies
    in [0, G). ``values`` may be f32, f64, or None for counts only."""
    check_agg_inputs(ids, values, num_groups)
    R, dev = ids.shape[0], ids.device
    if dev.type == "cpu":
        return ref.grouped_agg(ids, values, num_groups)
    _launch.reject_device(dev)
    sums, counts = agg_outputs(num_groups, dev)
    if R == 0 or num_groups == 0:
        return sums, counts
    max_blocks, stream = _launch.launch_config(dev)
    lib = _build.library("fused_scan_agg")
    _launch.raise_on(lib.grouped_agg_launch(
        ids.data_ptr(), values.data_ptr() if values is not None else None,
        DTYPE_CODES[values.dtype] if values is not None else -1,
        R, num_groups, sums.data_ptr(), counts.data_ptr(), max_blocks,
        stream), "grouped_agg")
    grouped_agg.launches += 1
    return sums, counts


grouped_agg.launches = 0
