"""fused_scan_shuffle: predicate -> packed words, shuffle targets and the
kept rows per target, in one pass.

Replaces the TPU kernel
``repro/kernels/fused_scan_shuffle.py::fused_scan_shuffle`` (its
``pl.pallas_call``). The CUDA kernel (``csrc/shuffle.cu``) runs
``predicate_bitmap``'s design: a persistent grid in which one producer warp
stages tiles of every program column and of the keys into a ring of
shared-memory stages by bulk copies (TMA), while eight consumer warps
interpret the postfix program over the ready stage (``eval_staged``), form
each word with ``__ballot_sync``, hash every row's key as
``hash_partition`` does, write the pids coalesced and count only the kept
rows per target (in registers at up to 8 targets). A pooled ``In`` list is
searched in the block's shared memory when it fits there. It carries the
shuffle by-product of a filter-only plan with a predicate: the words are
the filter and the survivors' pids the position vector. Comparisons run in
each column's own type, not in the TPU wrapper's f32.

Bound on the card: bytes — the predicate columns and the keys read once,
R/8 bytes of words and 4R bytes of pids written, at 3.35 TB/s.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, _launch, ref
from repro_torch.kernels.hash_partition import KEY_DTYPES, check_targets
from repro_torch.kernels.program import DTYPE_CODES, Program

# what the last launch on the card chose (csrc/shuffle.cu's ``info``)
LAUNCH_FIELDS = ("blocks", "blocks_per_sm", "stages", "tile_rows",
                 "smem_bytes", "pool_staged")


def fused_scan_shuffle(prog: Optional[Program], cols: Sequence[torch.Tensor],
                       keys: torch.Tensor, n_parts: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(words (ceil(R/32),) int32 of the rows that pass ``prog`` (every row
    when None), pids (R,) int32 of every row, kept rows per target (P,)
    int64)."""
    _launch.check_vector(keys, "keys", KEY_DTYPES, keys.device)
    check_targets(n_parts)
    R, dev = keys.shape[0], keys.device
    if prog is not None:
        _launch.check_program_cols(prog, cols, dev, R)
    if dev.type == "cpu":
        return ref.fused_scan_shuffle(prog, cols, keys, n_parts)
    _launch.reject_device(dev)
    words = torch.empty(-(-R // 32), dtype=torch.int32, device=dev)
    pids = torch.empty(R, dtype=torch.int32, device=dev)
    hist = torch.zeros(n_parts, dtype=torch.int64, device=dev)
    if R:
        args, _keep = _launch.program_args(prog, cols if prog is not None
                                           else ())
        host_pool = prog.pool.ctypes.data if prog is not None else 0
        info = (ctypes.c_int * len(LAUNCH_FIELDS))()
        lib = _build.library("shuffle")
        _launch.raise_on(lib.fused_scan_shuffle_launch(
            *args, host_pool, keys.data_ptr(), DTYPE_CODES[keys.dtype], R,
            n_parts, words.data_ptr(), pids.data_ptr(), hist.data_ptr(),
            _launch.sm_count(dev), _launch.stream_of(dev), info),
            "fused_scan_shuffle")
        fused_scan_shuffle.launches += 1
        fused_scan_shuffle.last_launch = dict(zip(LAUNCH_FIELDS, info))
    return words, pids, hist


fused_scan_shuffle.launches = 0
fused_scan_shuffle.last_launch = None
