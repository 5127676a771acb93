"""bitmap_apply: a packed selection bitmap applied to a column.

Replaces the TPU kernel ``repro/kernels/bitmap_apply.py::bitmap_apply``
(its ``pl.pallas_call``): the compute half of the §4.2 selection bitmap
(Fig 3), where words shipped by the storage node filter a column the
compute layer holds. Late materialisation, as on the TPU: the column keeps
its shape with dropped rows zeroed, and the selected rows are counted. The
CUDA kernel (``csrc/bitmap_apply.cu``) moves each value as raw bits, so it
takes int32, int64, f32 and f64 columns.

Bound on the card: bytes — R/8 bytes of words read, the column read once
and written once, at 3.35 TB/s. Design: a warp loads 32 words at once and
broadcasts each with ``__shfl_sync``; lane l writes row l of the word, and
each block adds its popcounts with one atomic.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, _launch, ref

COLUMN_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)


def bitmap_apply(words: torch.Tensor, col: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``col`` with the rows the words drop zeroed (R,), the selected rows
    as a 0-d int64 tensor). ``words`` are the (ceil(R/32),) int32 words of
    the bitmap (uint32 bits); bits past R are ignored."""
    dev = col.device
    _launch.check_vector(col, "col", COLUMN_DTYPES, dev)
    R = col.shape[0]
    _launch.check_vector(words, "words", (torch.int32,), dev, -(-R // 32))
    if dev.type == "cpu":
        return ref.bitmap_apply(words, col)
    _launch.reject_device(dev)
    out = torch.empty_like(col)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    if R:
        max_blocks, stream = _launch.launch_config(dev)
        lib = _build.library("bitmap_apply")
        _launch.raise_on(lib.bitmap_apply_launch(
            words.data_ptr(), col.data_ptr(), col.element_size(), R,
            out.data_ptr(), count.data_ptr(), max_blocks, stream),
            "bitmap_apply")
        bitmap_apply.launches += 1
    return out, count[0]


bitmap_apply.launches = 0
