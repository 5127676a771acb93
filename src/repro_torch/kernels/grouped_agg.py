"""grouped_agg: per-group sum and count of every row.

Replaces the TPU kernel ``repro/kernels/grouped_agg.py::grouped_agg`` (its
``pl.pallas_call``, a one-hot MXU contraction capped at G <= 4096). It
carries the residual group-bys: Q1's final merge, Q3's group by orderkey
(about 1.2e5 groups at sf=1000), Q12's by shipmode.

Bound on the card: bytes — ids and values read once, G sums and counts
written, at 3.35 TB/s. Design (``csrc/grouped_agg.cu``): the partials stay
on chip, in one of three regimes that ``plan`` picks from ``(R, G)``:

- ``smem``: the groups are cut into at most ``MAX_RANGES`` ranges that
  each fit one block's opt-in shared memory (12 B a group) and the rows
  into chunks; a block aggregates one chunk's rows of one range. With one
  chunk each block writes its range whole (no zero-fill); with more, the
  blocks add into zero-filled outputs;
- ``l2``: few rows a group over outputs that fit L2 (a residual's
  group-by): every row adds straight into the zero-filled outputs, which
  stay in L2;
- ``range``: rows are scattered into buckets of consecutive group ids
  (a histogram, a scan, a scatter of 16-byte records), then each window
  of a bucket is aggregated in one block's shared memory and, when one
  block owns it, written directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _launch, ref
from repro_torch.kernels.fused_scan_agg import check_agg_inputs
from repro_torch.kernels.program import DTYPE_CODES

SMEM_PER_SM = 228 * 1024        # sm_90: per SM, of which 1 KB per block is
SMEM_RESERVED = 1024            # the runtime's
SMEM_BLOCK = 227 * 1024         # a block's opt-in dynamic shared memory
PARTIAL_BYTES = 12              # an f64 sum and a u32 count per group
SMEM_GROUPS = SMEM_BLOCK // PARTIAL_BYTES        # 19,370 groups a block
MAX_RANGES = 8                  # smem: ranges, so chunk ids are read from L2
#                                 at most this many times (at 7.75 ranges and
#                                 60M ids smem beat range 0.9145 to 1.1982
#                                 ms; above 8, smem is unmeasured)
SMEM_MAX_GROUPS = MAX_RANGES * SMEM_GROUPS       # 154,960
COMBINE_GROUPS = 3072           # smem: at most this many groups a range,
#                                 a warp combines a tile's rows by group
#                                 (no shape near it measured)
WIN_SHIFT = 14                  # range: 16,384 groups of partials per block
TARGET_BUCKETS = 256            # range: buckets wide enough that a scatter
#                                 tile's rows of a bucket come in runs
MAX_WINDOW_BITS = 1             # range: at most 2 windows a bucket (each
#                                 window's block rereads the whole bucket)
MAX_BUCKETS = 1 << 13           # range: the scatter's 16 B a bucket and its
#                                 8192-row tile (96 KB) fit one block
SCATTER_ROWS = 1 << 15          # range: rows per histogram/scatter block
AGG_ROWS = 1 << 19              # range: rows of a bucket per aggregating block
MAX_SPLIT = 64
L2_ROWS_PER_GROUP = 16          # l2: at most this many rows a group (l2
#                                 and smem tie at 12, smem wins at 20)
L2_OUTPUT_BYTES = 24 << 20      # l2: outputs that fit half of the 50 MB L2
#                                 (l2 and range tie at 21 MB, range wins at 27)
# The threshold times are profile_kernels.py's, NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md).
REGIMES = ("smem", "l2", "range")


@dataclasses.dataclass(frozen=True)
class Plan:
    regime: str
    blocks: int         # smem: row chunks; l2: the grid; range: the
    #                     histogram's and the scatter's blocks
    threads: int
    per: int = 0        # smem: groups of a range
    ranges: int = 0     # smem
    combine: bool = False  # smem: warps combine a tile's rows by group
    shift: int = 0      # range: log2 of a bucket's width in group ids
    buckets: int = 0    # range
    chunk: int = 0      # range: rows per histogram/scatter block
    split: int = 1      # range: aggregating blocks per bucket and window
    win: int = 0        # range: groups a block aggregates (a window)
    wpb: int = 0        # range: windows a bucket

    @property
    def zero_fill(self) -> bool:
        """The launch zeroes the outputs first (atomics add into them);
        else its kernels write every output."""
        if self.regime == "smem":
            return self.blocks > 1
        return self.regime == "l2" or self.split > 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(R: int, G: int, sms: int, regime: Optional[str] = None) -> Plan:
    """The launch of ``grouped_agg`` over R >= 1 rows and G >= 1 groups on a
    card of ``sms`` SMs: ``regime`` (one of ``REGIMES``) or, when None,
    ``smem`` for G up to one block's partials; else ``l2`` for at most
    ``L2_ROWS_PER_GROUP`` rows a group over outputs of at most
    ``L2_OUTPUT_BYTES``; else ``smem`` up to ``SMEM_MAX_GROUPS`` groups and
    ``range`` above."""
    if regime is None:
        regime = ("smem" if G <= SMEM_GROUPS else
                  "l2" if R <= L2_ROWS_PER_GROUP * G
                  and G * 16 <= L2_OUTPUT_BYTES else
                  "smem" if G <= SMEM_MAX_GROUPS else "range")
    if regime == "l2":
        blocks = max(1, min(8 * sms, _cdiv(R, 256 * 8)))
        return Plan("l2", blocks, 256)
    if regime == "smem":
        if G > SMEM_MAX_GROUPS:
            raise ValueError(f"smem regime holds {SMEM_MAX_GROUPS} groups, "
                             f"not {G}")
        ranges = _cdiv(G, SMEM_GROUPS)
        per = _cdiv(G, ranges)
        per_sm = SMEM_PER_SM // (per * PARTIAL_BYTES + SMEM_RESERVED)
        bps = 4 if per_sm >= 4 else 2 if per_sm >= 2 else 1
        threads = 1024 // bps  # 1024 threads an SM
        chunks = max(1, min(_cdiv(R, threads * 8), sms * bps // ranges))
        return Plan("smem", chunks, threads, per=per, ranges=ranges,
                    combine=per <= COMBINE_GROUPS)
    if regime != "range":
        raise ValueError(f"unknown regime {regime!r}")
    wide = (_cdiv(G, TARGET_BUCKETS) - 1).bit_length()
    shift = min(max(WIN_SHIFT, wide), WIN_SHIFT + MAX_WINDOW_BITS)
    while _cdiv(G, 1 << shift) > MAX_BUCKETS:
        shift += 1
    nb = _cdiv(G, 1 << shift)
    win = min(1 << WIN_SHIFT, G)
    nblk = max(1, min(sms, _cdiv(R, SCATTER_ROWS)))
    split = max(1, min(MAX_SPLIT, _cdiv(R, nb * AGG_ROWS)))
    return Plan("range", nblk, 1024, shift=shift, buckets=nb,
                chunk=_cdiv(R, nblk), split=split, win=win,
                wpb=_cdiv(min(1 << shift, G), win))


def grouped_agg(ids: torch.Tensor, values: Optional[torch.Tensor],
                num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (G,) f64, counts (G,) int64) over the rows whose int32 id lies
    in [0, G). ``values`` may be a column of any ``DTYPE_CODES`` dtype,
    read at its stored width, or None for counts only. On the card
    ``plan`` picks the regime; ``run_plan`` launches a given plan."""
    check_agg_inputs(ids, () if values is None else (values,), num_groups)
    R, dev, G = ids.shape[0], ids.device, num_groups
    if dev.type == "cpu":
        return ref.grouped_agg(ids, values, G)
    _launch.reject_device(dev)
    if R == 0 or G == 0:
        return (torch.zeros(G, dtype=torch.float64, device=dev),
                torch.zeros(G, dtype=torch.int64, device=dev))
    return run_plan(plan(R, G, _launch.sm_count(dev)), ids, values, G)


def run_plan(p: Plan, ids: torch.Tensor, values: Optional[torch.Tensor],
             G: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``p`` on CUDA ``ids`` (R >= 1) and ``values``."""
    R, dev = ids.shape[0], ids.device
    # one buffer, so that a zero-fill is one memset (in the launch)
    out = torch.empty(2 * G, dtype=torch.float64, device=dev)
    sums, counts = out[:G], out[G:].view(torch.int64)
    vptr = values.data_ptr() if values is not None else None
    vdt = DTYPE_CODES[values.dtype] if values is not None else -1
    head = (ids.data_ptr(), vptr, vdt, R, G)
    tail = (sums.data_ptr(), counts.data_ptr(), _launch.stream_of(dev))
    lib = _build.library("grouped_agg")
    if p.regime == "smem":
        err = lib.grouped_agg_smem_launch(*head, p.per, p.ranges, p.blocks,
                                          int(p.combine), p.threads, *tail)
    elif p.regime == "l2":
        err = lib.grouped_agg_l2_launch(*head, p.blocks, p.threads, *tail)
    else:
        hist = torch.empty(p.buckets * p.blocks, dtype=torch.int64, device=dev)
        tot = torch.empty(p.buckets, dtype=torch.int64, device=dev)
        rec = torch.empty(2 * R, dtype=torch.float64, device=dev)
        err = lib.grouped_agg_range_launch(
            *head, p.shift, p.buckets, p.blocks, p.chunk, p.split, p.wpb,
            p.win, hist.data_ptr(), tot.data_ptr(), rec.data_ptr(), *tail)
    _launch.raise_on(err, "grouped_agg")
    grouped_agg.launches += 1
    return sums, counts


grouped_agg.launches = 0
