"""Disaggregated storage layer: nodes holding columnar partitions.

Port of ``repro.storage.catalog``. Each column of a table is one device
tensor; a partition's columns are views ``v[lo:hi]`` of it, placed
round-robin over the storage nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.queryproc.table import ColumnTable


@dataclasses.dataclass
class Partition:
    table: str
    index: int          # partition number within the table
    node_id: int        # storage node that owns it
    data: ColumnTable


@dataclasses.dataclass
class StorageNode:
    node_id: int
    partitions: List[Partition] = dataclasses.field(default_factory=list)


class Catalog:
    """Table -> partitions placement across storage nodes."""

    def __init__(self, num_nodes: int = 1, device=None):
        self.device = resolve_device(device)
        self.nodes: List[StorageNode] = [StorageNode(i)
                                         for i in range(num_nodes)]
        self.tables: Dict[str, List[Partition]] = {}

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    def add_table(self, name: str,
                  data: Union[ColumnTable, Dict[str, np.ndarray]],
                  rows_per_partition: int) -> None:
        """Shard ``data`` into fixed-row partitions (views of one device
        tensor per column); numpy columns are copied to the device once."""
        if not isinstance(data, ColumnTable):
            data = ColumnTable.from_numpy(data, self.device)
        n = len(data)
        num_parts = max(1, -(-n // rows_per_partition))
        parts: List[Partition] = []
        for i in range(num_parts):
            lo, hi = i * rows_per_partition, min(n, (i + 1) * rows_per_partition)
            chunk = ColumnTable({k: v[lo:hi] for k, v in data.cols.items()})
            node = self.nodes[i % self.num_nodes]
            part = Partition(name, i, node.node_id, chunk)
            node.partitions.append(part)
            parts.append(part)
        self.tables[name] = parts

    def partitions_of(self, table: str) -> List[Partition]:
        return self.tables[table]

    def scan_table(self, table: str, columns: Optional[Sequence[str]] = None
                   ) -> ColumnTable:
        parts = self.tables[table]
        return ColumnTable.concat([p.data if columns is None
                                   else p.data.select(columns)
                                   for p in parts])

    def iter_partitions(self) -> Iterator[Partition]:
        for node in self.nodes:
            yield from node.partitions


def catalog_from_arrays(tables: Dict[str, Dict[str, np.ndarray]],
                        num_nodes: int = 1, rows_per_partition: int = 6_000,
                        device=None) -> Catalog:
    """A catalog over numpy tables, partitioned as the reference's
    ``tpch.build_catalog`` does: ``lineitem`` in ``rows_per_partition``
    rows, every other table in ``num_nodes * 4`` objects."""
    cat = Catalog(num_nodes, device)
    for name, cols in tables.items():
        n = len(next(iter(cols.values())))
        rpp = rows_per_partition if name == "lineitem" else max(
            n // max(1, num_nodes * 4), 1)
        cat.add_table(name, cols, rpp)
    return cat
