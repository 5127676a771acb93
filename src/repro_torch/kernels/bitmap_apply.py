"""bitmap_apply: packed selection bitmaps applied to columns.

Replaces the TPU kernel ``repro/kernels/bitmap_apply.py::bitmap_apply``
(its ``pl.pallas_call``): the compute half of the §4.2 selection bitmap
(Fig 3), where words shipped by the storage node filter a column the
compute layer holds. Late materialisation, as on the TPU: the column keeps
its shape with dropped rows zeroed, and the selected rows are counted. The
CUDA kernel (``csrc/bitmap_apply.cu``) moves each value as raw bits at its
stored width, so it takes a column of any ``DTYPE_CODES`` dtype (1, 2, 4
or 8 bytes a row).

``bitmap_apply_segments`` applies many (words, column) segments in one
launch, as the Fig-3 apply does over every partition and cached column;
``bitmap_apply`` is its one-segment form (the op contract).

Bound on the card: bytes — the words read once, the kept rows' values
read, and every row written, at 3.35 TB/s. Design: the segments' rows are
cut into chunks of a fixed number of rows, which never cross a segment; a
grid of resident blocks strides over the chunks of all segments, stages
each chunk's words in shared memory, counts them with one atomic a chunk,
and moves 16 bytes (16, 8, 4 or 2 rows) a thread, skipping the load of a
vector with no kept row.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, _launch, ref
from repro_torch.kernels.program import DTYPE_CODES

COLUMN_DTYPES = tuple(DTYPE_CODES)  # moved at their stored width
# one output allocation a size
_RAW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _check(words: Sequence[torch.Tensor], cols: Sequence[torch.Tensor],
           part_of: Sequence[int]) -> torch.device:
    if not len(words) == len(cols) == len(part_of):
        raise ValueError(f"{len(words)} word vectors, {len(cols)} columns and "
                         f"{len(part_of)} partition indices")
    if not cols:
        raise ValueError("bitmap_apply needs at least one segment")
    dev = cols[0].device
    for w, c in zip(words, cols):
        _launch.check_vector(c, "col", COLUMN_DTYPES, dev)
        _launch.check_vector(w, "words", (torch.int32,), dev,
                             -(-c.shape[0] // 32))
    if min(part_of) < 0:
        raise ValueError("partition indices must be >= 0")
    return dev


def _outputs(cols: Sequence[torch.Tensor], dev: torch.device
             ) -> List[torch.Tensor]:
    """One empty output a column, as views of one allocation per element
    size, each starting at its column's offset within 16 bytes (so the
    kernel's 16-byte accesses are aligned on both sides)."""
    outs: List[torch.Tensor] = [None] * len(cols)
    by_size: Dict[int, List[int]] = {}
    for i, c in enumerate(cols):
        by_size.setdefault(c.element_size(), []).append(i)
    for size, idx in by_size.items():
        raw = _RAW[size]
        per = 16 // size
        pieces, end = [], 0  # (gap, rows) in elements
        for i in idx:
            phase = cols[i].data_ptr() % 16 // size
            gap = (phase - end) % per
            pieces += [gap, cols[i].shape[0]]
            end += gap + cols[i].shape[0]
        # the caching allocator's blocks start on 512-byte boundaries
        buf = torch.empty(end, dtype=raw, device=dev)
        views = torch.split(buf, pieces)[1::2]
        for i, v in zip(idx, views):
            outs[i] = v if cols[i].dtype == raw else v.view(cols[i].dtype)
    return outs


def bitmap_apply_segments(words: Sequence[torch.Tensor],
                          cols: Sequence[torch.Tensor],
                          part_of: Sequence[int]
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Apply ``words[i]`` ((ceil(R_i/32),) int32 words carrying uint32 bits;
    bits past R_i are ignored) to ``cols[i]``, for every segment i, in one
    launch. Returns (each column with its dropped rows zeroed, selected rows
    per partition as a (P,) int64 tensor, P = max(part_of) + 1): partition
    p's count comes from its first segment's words, and a partition no
    segment names counts 0."""
    dev = _check(words, cols, part_of)
    if dev.type == "cpu":
        return ref.bitmap_apply_segments(words, cols, part_of)
    _launch.reject_device(dev)
    parts = np.asarray(part_of, np.int64)
    counts = torch.zeros(int(parts.max()) + 1, dtype=torch.int64, device=dev)
    outs = _outputs(cols, dev)
    lib = _build.library("bitmap_apply")
    rows = np.asarray([c.shape[0] for c in cols], np.int64)
    sizes = np.asarray([c.element_size() for c in cols], np.int64)
    chunk = lib.bitmap_apply_chunk_rows()
    first = np.concatenate([[0], np.cumsum(-(-rows // chunk))])
    slot = np.full(len(cols), -1, np.int64)
    _, first_seg = np.unique(parts, return_index=True)
    slot[first_seg] = parts[first_seg]
    segs = np.stack([
        np.asarray([w.data_ptr() for w in words], np.int64),
        np.asarray([c.data_ptr() for c in cols], np.int64),
        np.asarray([o.data_ptr() for o in outs], np.int64), rows, sizes,
        slot], 1)
    # one copy, from pinned memory so that it does not stall the host
    table = torch.from_numpy(np.concatenate([first, segs.reshape(-1)])
                             ).pin_memory().to(dev, non_blocking=True)
    if first[-1]:
        _launch.raise_on(lib.bitmap_apply_launch(
            table.data_ptr(), len(cols), int(first[-1]), counts.data_ptr(),
            _launch.sm_count(dev), int((sizes < 4).any()),
            _launch.stream_of(dev)), "bitmap_apply")
        bitmap_apply.launches += 1
    return outs, counts


def bitmap_apply(words: torch.Tensor, col: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``col`` with the rows the words drop zeroed (R,), the selected rows
    as a 0-d int64 tensor). ``words`` are the (ceil(R/32),) int32 words of
    the bitmap (uint32 bits); bits past R are ignored."""
    outs, counts = bitmap_apply_segments([words], [col], [0])
    return outs[0], counts[0]


bitmap_apply.launches = 0
