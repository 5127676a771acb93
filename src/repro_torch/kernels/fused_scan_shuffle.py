"""fused_scan_shuffle: predicate -> packed words, shuffle targets and the
kept rows per target, in one pass.

Replaces the TPU kernel
``repro/kernels/fused_scan_shuffle.py::fused_scan_shuffle`` (its
``pl.pallas_call``). The CUDA kernel (``csrc/shuffle.cu``) interprets the
same postfix program as ``predicate_bitmap`` over tiles of 32x8 rows per
warp, forms each word with ``__ballot_sync``, hashes every row's key as
``hash_partition`` does, and counts only the kept rows per target. It
carries the shuffle by-product of a filter-only plan with a predicate: the
words are the filter and the survivors' pids the position vector.
Comparisons run in each column's own type, not in the TPU wrapper's f32.

Bound on the card: bytes — the predicate columns and the keys read once,
R/8 bytes of words and 4R bytes of pids written, at 3.35 TB/s.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, _launch, ref
from repro_torch.kernels.hash_partition import KEY_DTYPES, check_targets
from repro_torch.kernels.program import DTYPE_CODES, Program


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
        max_blocks, stream = _launch.launch_config(dev)
        lib = _build.library("shuffle")
        _launch.raise_on(lib.fused_scan_shuffle_launch(
            *args, keys.data_ptr(), DTYPE_CODES[keys.dtype], R, n_parts,
            words.data_ptr(), pids.data_ptr(), hist.data_ptr(), max_blocks,
            stream), "fused_scan_shuffle")
        fused_scan_shuffle.launches += 1
    return words, pids, hist


fused_scan_shuffle.launches = 0
