"""Plain torch versions of the kernels (port of ``repro.kernels.ref``).

The wrappers use these for CPU tensors; ``chip_smoke.py`` and the CUDA
tests hold each kernel against them on the card. Bitmaps are packed
32 rows per word, least-significant bit first, and stored as int32 words
that carry uint32 bits (torch has little uint32 arithmetic on CUDA):
compare them through ``.numpy().view(np.uint32)``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.program import (K_AND, K_CMP, K_CMP_COL, K_IN, MODES,
                                         Program)

_CMP = (torch.le, torch.lt, torch.ge, torch.gt, torch.eq)  # CMP_OPS order


def pack_bitmap(mask: torch.Tensor) -> torch.Tensor:
    """(R,) bool -> (ceil(R/32),) int32 words holding uint32 bits."""
    n = mask.shape[0]
    pad = (-n) % 32
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, pad))
    shifts = torch.arange(32, device=mask.device, dtype=torch.int64)
    words = (m.reshape(-1, 32) << shifts).sum(dim=1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


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
                   ids: torch.Tensor, values: Optional[torch.Tensor],
                   num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (G,) f64, counts (G,) int64) over the rows that pass the
    program (all rows when ``prog`` is None) and whose id lies in
    ``[0, G)`` — the kernel drops other ids instead of writing out of
    bounds."""
    keep = (ids >= 0) & (ids < num_groups)
    if prog is not None:
        keep &= run_program(prog, cols)
    g = ids[keep].to(torch.int64)
    counts = torch.bincount(g, minlength=num_groups)
    sums = torch.zeros(num_groups, dtype=torch.float64, device=ids.device)
    if values is not None:
        sums.index_add_(0, g, values[keep].to(torch.float64))
    return sums, counts


def grouped_agg(ids: torch.Tensor, values: Optional[torch.Tensor],
                num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return fused_scan_agg(None, (), ids, values, num_groups)
