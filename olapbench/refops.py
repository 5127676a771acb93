"""Plain PyTorch operators that the reference queries are written with.

Nothing here imports the program. The reference runs on the card once
the window has closed and the program's state is freed (on the CPU in the
tests), over its own copy of the benchmark's tables (``RefTables``).
Every operator takes the float type ``F`` it computes in: float64 for the
reference, float32 for the control that ``control.py`` runs, which must
come out as not correct.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

F64 = torch.float64


class RefTables:
    """The benchmark's host tables, each column copied to ``device`` when a
    query first reads it: integers as int64, floats as stored."""

    def __init__(self, tables: Dict[str, Dict[str, np.ndarray]], device):
        self.host = tables
        self.device = torch.device(device)
        self._cols: Dict[Tuple[str, str], torch.Tensor] = {}

    def col(self, table: str, name: str) -> torch.Tensor:
        k = (table, name)
        if k not in self._cols:
            v = self.host[table][name]
            if v.dtype.kind != "f":
                v = v.astype(np.int64)
            self._cols[k] = torch.from_numpy(v).to(self.device)
        return self._cols[k]


def col(T: RefTables, table: str, name: str, F=F64,
        rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A column in the reference's arithmetic (integers int64, floats in
    ``F``), of the rows ``rows`` selects (a mask or indices) if given."""
    v = T.col(table, name)
    if rows is not None:
        v = v[rows]
    return v.to(F) if v.is_floating_point() else v


def isin(v: torch.Tensor, values) -> torch.Tensor:
    return torch.isin(v, torch.tensor(values, dtype=v.dtype, device=v.device))


def pk_lookup(pk: torch.Tensor, keep: Optional[torch.Tensor] = None):
    """A lookup from key values to the rows of a table whose primary key is
    ``pk`` (non-negative integers, each once), ``keep`` masking rows out.
    The returned function maps foreign keys to row numbers, -1 where no
    kept row has that key: an inner join on a primary key."""
    if pk.numel() and int(pk.min()) < 0:
        raise ValueError("negative primary key")
    size = int(pk.max()) + 2 if pk.numel() else 1
    lut = torch.full((size,), -1, dtype=torch.int64, device=pk.device)
    rows = torch.arange(pk.numel(), device=pk.device)
    if keep is not None:
        pk, rows = pk[keep], rows[keep]
    lut[pk] = rows
    if int((lut >= 0).sum()) != pk.numel():
        raise ValueError("primary key with repeated values")

    def find(fk: torch.Tensor) -> torch.Tensor:
        ok = (fk >= 0) & (fk < size)
        out = torch.full_like(fk, -1)
        out[ok] = lut[fk[ok]]
        return out
    return find


def dense_key(*keys: torch.Tensor) -> Tuple[torch.Tensor, list]:
    """One int64 key over several non-negative integer keys, and each
    key's extent, so that ``split_key`` gives them back."""
    out = torch.zeros_like(keys[0])
    sizes = []
    for k in keys:
        if k.numel() and int(k.min()) < 0:
            raise ValueError("negative group key")
        size = int(k.max()) + 1 if k.numel() else 1
        out = out * size + k
        sizes.append(size)
    return out, sizes


def split_key(key: torch.Tensor, sizes: list) -> list:
    parts = []
    for size in reversed(sizes):
        parts.append(key % size)
        key = key // size
    return parts[::-1]


def group_sums(key: torch.Tensor, values: Dict[str, torch.Tensor], F=F64
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(the keys present in ascending order, their row counts in ``F``,
    each value's sum per key, added in ``F``) over an int64 ``key``."""
    n = int(key.max()) + 1 if key.numel() else 0
    cnt = torch.bincount(key, minlength=n)
    present = torch.nonzero(cnt).flatten()
    sums = {c: torch.zeros(n, dtype=F, device=key.device)
            .index_add_(0, key, v.to(F))[present] for c, v in values.items()}
    return present, cnt[present].to(F), sums


def top_k(order_by: torch.Tensor, k: int) -> torch.Tensor:
    """Row numbers of the ``k`` largest values, largest first; ties keep
    row order."""
    return torch.argsort(-order_by, stable=True)[:k]


def fsum(v: torch.Tensor, F=F64) -> torch.Tensor:
    return v.to(F).sum().reshape(1)
