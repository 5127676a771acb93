"""Argument checks and ctypes marshalling shared by the kernel wrappers."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.program import DTYPE_CODES, Program


def check_vector(t: torch.Tensor, name: str, dtypes: Tuple[torch.dtype, ...],
                 device: torch.device, length: Optional[int] = None) -> None:
    """Raise unless ``t`` is a contiguous 1-D tensor of an accepted dtype
    on ``device`` (and of ``length`` rows, when given)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if length is not None and t.shape[0] != length:
        raise ValueError(f"{name} has {t.shape[0]} rows, expected {length}")


def check_program_cols(prog: Program, cols: Sequence[torch.Tensor],
                       device: torch.device, length: int) -> None:
    if not isinstance(prog, Program):
        raise TypeError(f"a kernel takes one Program, not "
                        f"{type(prog).__name__} (predicate_bitmap."
                        f"predicate_words evaluates a SplitProgram)")
    if len(cols) != len(prog.columns):
        raise ValueError(f"program reads {len(prog.columns)} columns, "
                         f"got {len(cols)}")
    for name, dt, c in zip(prog.columns, prog.dtypes, cols):
        check_vector(c, name, (dt,), device, length)


def program_args(prog: Optional[Program], cols: Sequence[torch.Tensor]
                 ) -> Tuple[list, List[np.ndarray]]:
    """The ``(ops, n_ops, fconst, iconst, n_consts, col_ptrs, dtypes,
    n_cols, pool, n_pool)`` arguments of a launch on the columns' device,
    plus the host arrays they point into (keep those alive until the call
    returns)."""
    pool_ptr, n_pool = 0, 0
    if prog is None:
        ops = np.zeros((0, 4), np.int32)
        fc, ic = np.zeros(0, np.float64), np.zeros(0, np.int64)
    else:
        ops = np.ascontiguousarray(prog.ops, np.int32)
        fc = np.ascontiguousarray(prog.fconst, np.float64)
        ic = np.ascontiguousarray(prog.iconst, np.int64)
        if len(prog.pool):
            pool_ptr = prog.pool_on(cols[0].device).data_ptr()
            n_pool = len(prog.pool)
    ptrs = np.asarray([c.data_ptr() for c in cols], np.int64)
    dts = np.asarray([DTYPE_CODES[c.dtype] for c in cols], np.int32)
    keep = [ops, fc, ic, ptrs, dts]
    args = [ops.ctypes.data, len(ops), fc.ctypes.data, ic.ctypes.data,
            len(fc), ptrs.ctypes.data, dts.ctypes.data, len(cols), pool_ptr,
            n_pool]
    return args, keep


# 4 x 256 threads an SM: each thread keeps 8 rows of loads in flight, and
# fewer blocks mean fewer shared-memory partials to flush
BLOCKS_PER_SM = 4


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_config(device: torch.device) -> Tuple[int, int]:
    """(grid-size cap, current stream handle) for a launch on ``device``."""
    return sm_count(device) * BLOCKS_PER_SM, stream_of(device)


class KernelError(RuntimeError):
    """A kernel library failed to build, or a launch returned a CUDA
    error. Callers that replay a plain path on their own failures (the
    residual's tensor backend) let this one propagate."""


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise KernelError(f"{kernel} launch failed: CUDA error {err}")


def reject_device(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"kernels run on cuda or cpu tensors, not {device}")
