"""Columnar tables over device tensors + per-column stats.

Port of ``repro.queryproc.table``. The stats feed the cost model and,
through it, the Arbitrator's decision vector, so ``ColumnStats.of`` gives
exactly the reference's numbers: the strided-sample distinct count, the
float min/max and the compression model's ``int(raw * comp)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ColumnStats:
    min: float
    max: float
    ndv: int  # approx distinct values
    nbytes_raw: int
    nbytes_stored: int  # after the compression model

    @staticmethod
    def of(arr: torch.Tensor) -> "ColumnStats":
        n = arr.numel()
        raw = n * arr.element_size()
        if n == 0:
            return ColumnStats(0.0, 0.0, 0, 0, 0)
        step = max(1, n // 4096)
        ndv = min(torch.unique(arr[::step]).numel() * step, n)
        # compression model: low-cardinality dictionary-encodes well
        card_ratio = ndv / max(1, n)
        comp = 0.08 + 0.92 * min(1.0, card_ratio * 8)
        lo, hi = torch.aminmax(arr)
        return ColumnStats(float(lo), float(hi), int(ndv), raw,
                           int(raw * comp))


def _raw_nbytes(v: torch.Tensor) -> int:
    return v.numel() * v.element_size()


class ColumnTable:
    """A dict of equal-length 1-D tensors on one device."""

    def __init__(self, cols: Dict[str, torch.Tensor],
                 stats: Optional[Dict[str, ColumnStats]] = None):
        lens = {len(v) for v in cols.values()}
        if len(lens) > 1:
            raise ValueError(
                f"ragged columns: { {k: len(v) for k, v in cols.items()} }")
        self.cols = cols
        self._stats = stats

    def __len__(self) -> int:
        return len(next(iter(self.cols.values()))) if self.cols else 0

    @property
    def columns(self) -> List[str]:
        return list(self.cols)

    @property
    def device(self) -> torch.device:
        return next(iter(self.cols.values())).device

    def stats(self) -> Dict[str, ColumnStats]:
        if self._stats is None:
            self._stats = {k: ColumnStats.of(v) for k, v in self.cols.items()}
        return self._stats

    def nbytes(self, columns: Optional[Iterable[str]] = None,
               stored: bool = True) -> int:
        cols = list(columns) if columns is not None else self.columns
        if not stored:  # raw bytes need no stats
            return sum(_raw_nbytes(self.cols[c]) for c in cols)
        st = self.stats()
        return sum(st[c].nbytes_stored for c in cols)

    def select(self, columns: Iterable[str]) -> "ColumnTable":
        cols = list(columns)
        st = self._stats
        if st is not None and all(c in st for c in cols):
            st = {c: st[c] for c in cols}
        else:
            st = None
        return ColumnTable({c: self.cols[c] for c in cols}, stats=st)

    def take(self, idx: torch.Tensor) -> "ColumnTable":
        return ColumnTable({k: v[idx] for k, v in self.cols.items()})

    def filter(self, mask: torch.Tensor) -> "ColumnTable":
        return self.take(torch.nonzero(mask).flatten())

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.cols.items()}

    @staticmethod
    def from_numpy(cols: Dict[str, np.ndarray], device) -> "ColumnTable":
        return ColumnTable({k: torch.from_numpy(np.ascontiguousarray(v))
                            .to(device) for k, v in cols.items()})

    @staticmethod
    def concat(tables: List["ColumnTable"]) -> "ColumnTable":
        nonempty = [t for t in tables if len(t)]
        if not nonempty:
            # keep the schema: a filter matching zero rows everywhere must
            # still yield a joinable (0-row, correct-columns) table
            return tables[0] if tables else ColumnTable({})
        if len(nonempty) == 1:
            return nonempty[0]
        cols = nonempty[0].columns
        return ColumnTable({c: torch.cat([t.cols[c] for t in nonempty])
                            for c in cols})

    def __repr__(self):
        return f"ColumnTable({len(self)} rows x {self.columns})"
