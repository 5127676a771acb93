"""fused_scan_agg: predicate -> keep mask -> per-group sums of several value
columns and a count, in one pass.

Replaces the TPU kernel ``repro/kernels/fused_scan_agg.py::fused_scan_agg``
(its ``pl.pallas_call``), a one-hot MXU contraction gated by the traced
predicate, one value column per call. Here one launch takes 0 to
``MAX_VALUES`` value columns, so a plan's sums cost one pass: the
predicate is evaluated once per row and the ids read once per kept row. The
CUDA kernel (``csrc/fused_scan_agg.cu``) stages tiles of the predicate
columns in shared memory by bulk copies, as ``predicate_bitmap`` does
(``csrc/staging.cuh``), and interprets the program over them with
``eval_staged``; each consumer warp then loads the ids and values of its
kept rows, combines them group by group (registers, then one shuffle tree
for all the sums), and adds the sums and the count with atomics: into
shared-memory partials per block when they fit beside the stages, into
global memory otherwise. Sums accumulate in f64, counts exactly.

Bound on the card: bytes — the predicate columns read once, the ids and
values of the kept rows, and G x (8V + 8) bytes of sums and counts
written, at 3.35 TB/s.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, _launch, ref
from repro_torch.kernels.program import Program

VALUE_DTYPES = (torch.float32, torch.float64)
MAX_VALUES = 4  # csrc/fused_scan_agg.cu: Q1's four sums in one launch


def check_agg_inputs(ids: torch.Tensor, values: Sequence[torch.Tensor],
                     num_groups: int) -> None:
    _launch.check_vector(ids, "ids", (torch.int32,), ids.device)
    for v in values:
        _launch.check_vector(v, "values", VALUE_DTYPES, ids.device,
                             ids.shape[0])
    if not 0 <= num_groups < 2 ** 31:
        raise ValueError(f"num_groups {num_groups} out of range")


def fused_scan_agg(prog: Optional[Program], cols: Sequence[torch.Tensor],
                   ids: torch.Tensor, values: Sequence[torch.Tensor],
                   num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (V, G) f64, one row per value column, counts (G,) int64) over
    the rows that pass ``prog`` (all rows when None) and whose int32 id
    lies in [0, G). ``values`` holds 0 to ``MAX_VALUES`` f32 or f64
    columns (none: counts only)."""
    if isinstance(values, torch.Tensor) or len(values) > MAX_VALUES:
        raise ValueError(f"values must be a sequence of at most {MAX_VALUES} "
                         f"columns")
    check_agg_inputs(ids, values, num_groups)
    R, dev, V, G = ids.shape[0], ids.device, len(values), num_groups
    if prog is not None:
        _launch.check_program_cols(prog, cols, dev, R)
    if dev.type == "cpu":
        return ref.fused_scan_agg(prog, cols, ids, values, G)
    _launch.reject_device(dev)
    # one buffer, so that zeroing the outputs is one memset
    out = torch.zeros((V + 1) * G, dtype=torch.int64, device=dev)
    sums, counts = out[:V * G].view(torch.float64).view(V, G), out[V * G:]
    if R == 0 or G == 0:
        return sums, counts
    args, _keep = _launch.program_args(prog, cols if prog is not None else ())
    vptr = np.asarray([v.data_ptr() for v in values] or [0], np.int64)
    vf64 = np.asarray([v.dtype == torch.float64 for v in values] or [0],
                      np.int32)
    lib = _build.library("fused_scan_agg")
    _launch.raise_on(lib.fused_scan_agg_launch(
        *args, ids.data_ptr(), vptr.ctypes.data, vf64.ctypes.data, V, R, G,
        sums.data_ptr(), counts.data_ptr(), _launch.sm_count(dev),
        _launch.stream_of(dev)), "fused_scan_agg")
    fused_scan_agg.launches += 1
    return sums, counts


fused_scan_agg.launches = 0
