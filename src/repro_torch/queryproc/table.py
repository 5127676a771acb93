"""Columnar tables over device tensors + per-column stats.

Port of ``repro.queryproc.table``. The stats feed the cost model and,
through it, the Arbitrator's decision vector, so ``ColumnStats.of`` gives
exactly the reference's numbers: the strided-sample distinct count, the
float min/max and the compression model's ``int(raw * comp)``.

A column may hold any dtype of ``NP_OF``: every dtype the reference's
numpy engine runs that torch can hold. Torch has few kernels for uint16,
uint32 and uint64 (on the card none that index, compare, sort or reduce
them), so ``gather``, ``as_int64``, ``as_float64`` and ``sort_key`` move
and order such a column through a view of the signed type of its width,
and no column changes its stored dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

NP_OF = {torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
         torch.int16: np.int16, torch.uint16: np.uint16,
         torch.int32: np.int32, torch.uint32: np.uint32,
         torch.int64: np.int64, torch.uint64: np.uint64,
         torch.float16: np.float16, torch.float32: np.float32,
         torch.float64: np.float64}
# torch's wide unsigned dtypes -> the signed dtype of their width
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}
_MIN64 = -2 ** 63


def signed_view(v: torch.Tensor) -> torch.Tensor:
    """``v`` itself, or a uint16/32/64 column viewed as the signed type of
    its width (the same bits; torch moves those on any device)."""
    return v.view(_SIGNED[v.dtype]) if v.dtype in _SIGNED else v


def gather(v: torch.Tensor, idx) -> torch.Tensor:
    """``v[idx]`` (indices, a mask or a slice) in ``v``'s dtype."""
    if v.dtype in _SIGNED:
        return v.view(_SIGNED[v.dtype])[idx].view(v.dtype)
    return v[idx]


def as_int64(v: torch.Tensor) -> torch.Tensor:
    """The values of a bool or integer column other than uint64, as int64
    (uint64 has no such form: see ``sort_key``)."""
    if v.dtype in (torch.uint16, torch.uint32):
        width = 16 if v.dtype == torch.uint16 else 32
        return v.view(_SIGNED[v.dtype]).to(torch.int64) & ((1 << width) - 1)
    if v.dtype == torch.uint64:
        raise TypeError("uint64 values do not all fit int64")
    return v.to(torch.int64)


def as_float64(v: torch.Tensor) -> torch.Tensor:
    """The column as float64, each value rounded once, as numpy's
    ``astype(np.float64)`` does (a uint64 from its exact 32-bit halves)."""
    if v.dtype == torch.uint64:
        b = v.view(torch.int64)
        return ((b >> 32) & 0xFFFFFFFF).to(torch.float64) * 2.0 ** 32 \
            + (b & 0xFFFFFFFF).to(torch.float64)
    if v.dtype in _SIGNED:
        return as_int64(v).to(torch.float64)
    return v.to(torch.float64)


def float_key(v: torch.Tensor) -> torch.Tensor:
    """int64 keys of float values in numpy's sort order: -0.0 equals 0.0,
    and every NaN sorts last and equals every other NaN."""
    x = v.to(torch.float64) + 0.0  # -0.0 -> 0.0
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    b = x.view(torch.int64)
    return b ^ ((b >> 63) & (2 ** 63 - 1))


def sort_key(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor in ``v``'s order whose equal entries are numpy's
    equal values: bool and integers by value (uint64 with its sign bit
    flipped), floats by ``float_key``. Torch sorts, searches and reduces
    int64 on every device."""
    if v.is_floating_point():
        return float_key(v)
    if v.dtype == torch.uint64:
        return v.view(torch.int64) ^ _MIN64
    return as_int64(v)


def from_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The bool or integer values of ``sort_key`` keys, in ``dtype``."""
    if dtype == torch.uint64:
        return (k ^ _MIN64).view(torch.uint64)
    if dtype in _SIGNED:
        half = 1 << (15 if dtype == torch.uint16 else 31)
        return torch.where(k >= half, k - 2 * half, k).to(
            _SIGNED[dtype]).view(dtype)
    return k.to(dtype)


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
        key = sort_key(arr)
        ndv = min(torch.unique(key[::step]).numel() * step, n)
        # compression model: low-cardinality dictionary-encodes well
        card_ratio = ndv / max(1, n)
        comp = 0.08 + 0.92 * min(1.0, card_ratio * 8)
        if arr.is_floating_point():  # NaN propagates, as numpy's min does
            lo, hi = (float(x) for x in torch.aminmax(arr))
        else:  # a uint64 key is its value less 2**63
            shift = 2 ** 63 if arr.dtype == torch.uint64 else 0
            lo, hi = (float(int(x) + shift) for x in torch.aminmax(key))
        return ColumnStats(lo, hi, int(ndv), raw, int(raw * comp))


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
        return ColumnTable({k: gather(v, idx) for k, v in self.cols.items()})

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
