"""Plain torch versions of the kernels (port of ``repro.kernels.ref``).

The wrappers use these for CPU tensors; ``chip_smoke.py`` and the CUDA
tests hold each kernel against them on the card. Bitmaps are packed
32 rows per word, least-significant bit first, and stored as int32 words
that carry uint32 bits (torch has little uint32 arithmetic on CUDA):
compare them through ``.numpy().view(np.uint32)``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.program import (K_AND, K_CMP, K_CMP_COL, K_IN, MODES,
                                         Program)

_CMP = (torch.le, torch.lt, torch.ge, torch.gt, torch.eq)  # CMP_OPS order


def words_from_uint32(w: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 words with the same bits."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def pack_bitmap(mask: torch.Tensor) -> torch.Tensor:
    """(R,) bool -> (ceil(R/32),) int32 words holding uint32 bits."""
    n = mask.shape[0]
    pad = (-n) % 32
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, pad))
    shifts = torch.arange(32, device=mask.device, dtype=torch.int64)
    return words_from_uint32((m.reshape(-1, 32) << shifts).sum(dim=1))


def unpack_bitmap(words: torch.Tensor, n: int) -> torch.Tensor:
    """(ceil(n/32),) words -> (n,) bool. Works on the words' bytes, least
    significant first in memory (little-endian, as on the card and its
    host), so it moves about 2 bytes per row and widens nothing."""
    bits = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                        device=words.device)
    b = words.contiguous().view(torch.uint8)
    return ((b[:, None] & bits) != 0).reshape(-1)[:n]


def run_program(prog: Program, cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Interpret the postfix program over whole columns (slot order):
    the row mask the CUDA device function computes row by row."""
    stack = []
    for code, c, x, y in prog.ops.tolist():
        kind, cmp, mode = code & 15, (code >> 4) & 7, MODES[(code >> 8) & 3]
        if kind in (K_CMP, K_IN):
            a = cols[c].to(mode)
            pool = prog.iconst if mode == torch.int64 else prog.fconst
            consts = torch.as_tensor(pool[x:x + (y if kind == K_IN else 1)],
                                     device=a.device).to(mode)
            if kind == K_CMP:
                stack.append(_CMP[cmp](a, consts[0]))
            else:
                hit = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
                for v in consts:
                    hit |= a == v
                stack.append(hit)
        elif kind == K_CMP_COL:
            stack.append(_CMP[cmp](cols[c].to(mode), cols[x].to(mode)))
        else:
            r, l_ = stack.pop(), stack.pop()
            stack.append(l_ & r if kind == K_AND else l_ | r)
    (mask,) = stack
    return mask


def predicate_bitmap(prog: Program, cols: Sequence[torch.Tensor]
                     ) -> torch.Tensor:
    return pack_bitmap(run_program(prog, cols))


def fused_scan_agg(prog: Optional[Program], cols: Sequence[torch.Tensor],
                   ids: torch.Tensor, values: Sequence[torch.Tensor],
                   num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (V, G) f64, one row per value column, counts (G,) int64) over
    the rows that pass the program (all rows when ``prog`` is None) and
    whose id lies in ``[0, G)`` — the kernel drops other ids instead of
    writing out of bounds."""
    keep = (ids >= 0) & (ids < num_groups)
    if prog is not None:
        keep &= run_program(prog, cols)
    g = ids[keep].to(torch.int64)
    counts = torch.bincount(g, minlength=num_groups)
    sums = torch.zeros((len(values), num_groups), dtype=torch.float64,
                       device=ids.device)
    for row, v in zip(sums, values):
        row.index_add_(0, g, v[keep].to(torch.float64))
    return sums, counts


def grouped_agg(ids: torch.Tensor, values: Optional[torch.Tensor],
                num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    sums, counts = fused_scan_agg(None, (), ids,
                                  () if values is None else (values,),
                                  num_groups)
    return (sums[0] if values is not None else
            torch.zeros(num_groups, dtype=torch.float64,
                        device=ids.device)), counts


def bitmap_apply(words: torch.Tensor, col: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the column with the rows the words drop zeroed (R,), the number of
    selected rows as a 0-d int64 tensor). Bits past R are ignored."""
    keep = unpack_bitmap(words, col.shape[0])
    masked = torch.where(keep, col, torch.zeros((), dtype=col.dtype,
                                                device=col.device))
    return masked, keep.sum()


def bitmap_apply_segments(words: Sequence[torch.Tensor],
                          cols: Sequence[torch.Tensor],
                          part_of: Sequence[int]
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``bitmap_apply`` of each (words, column) segment, and the selected
    rows of each partition ``0 .. max(part_of)`` (int64) from its first
    segment."""
    outs = []
    counts = torch.zeros(max(part_of) + 1, dtype=torch.int64,
                         device=cols[0].device)
    seen = set()
    for w, c, p in zip(words, cols, part_of):
        masked, count = bitmap_apply(w, c)
        outs.append(masked)
        if p not in seen:
            seen.add(p)
            counts[p] = count
    return outs, counts


KNUTH = 2654435761


def hash_partition_ids(keys: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Knuth multiplicative hash of the keys' low 32 bits:
    ``((low32(key) * 2654435761 mod 2**32) >> 16) mod n`` as int32. The
    product is formed from the key's 16-bit halves, so no int64 product
    passes 2**63 (a full ``low32(key) * KNUTH`` does once low32(key) nears
    3.47e9, as negative int32 keys do), and it is masked to 32 bits before
    the shift and the modulo."""
    if keys.is_floating_point():
        raise TypeError("hash_partition_ids takes integer keys")
    k = keys.to(torch.int64) & 0xFFFFFFFF
    lo, hi = k & 0xFFFF, k >> 16
    h = (lo * KNUTH + ((hi * KNUTH) & 0xFFFF) * 65536) & 0xFFFFFFFF
    return ((h >> 16) % n_parts).to(torch.int32)


def hash_partition(keys: torch.Tensor, n_parts: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pids (R,) int32, rows per target (P,) int64)."""
    pids = hash_partition_ids(keys, n_parts)
    return pids, torch.bincount(pids, minlength=n_parts)


def fused_scan_shuffle(prog: Optional[Program], cols: Sequence[torch.Tensor],
                       keys: torch.Tensor, n_parts: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(words (ceil(R/32),) of the rows that pass the program (every row
    when ``prog`` is None), pids (R,) int32 of every row, kept rows per
    target (P,) int64)."""
    keep = (run_program(prog, cols) if prog is not None
            else torch.ones(keys.shape, dtype=torch.bool, device=keys.device))
    pids = hash_partition_ids(keys, n_parts)
    return (pack_bitmap(keep), pids,
            torch.bincount(pids[keep], minlength=n_parts))
