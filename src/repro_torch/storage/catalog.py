"""Disaggregated storage layer: nodes holding columnar partitions.

Port of ``repro.storage.catalog``. Each column of a table is one device
tensor; a partition's columns are views ``v[lo:hi]`` of it, placed
round-robin over the storage nodes. A table may be clustered by a key: it
is stably sorted by it and every partition ends at the end of a run of the
key, so no key value straddles two partitions (the group-locality that
makes storage-side HAVING over partial aggregates sound).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.queryproc.table import ColumnTable, sort_key


@dataclasses.dataclass
class Partition:
    table: str
    index: int          # partition number within the table
    node_id: int        # storage node that owns it
    data: ColumnTable
    # monotone version stamp: every append or update bumps it, so a cached
    # derivation of this partition's bytes (``core.result_cache`` keys its
    # entries by it) detects staleness without hashing the contents
    version: int = 0


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
        # table -> cluster key: partition boundaries are aligned to runs of
        # this key, so every key value lies wholly inside one partition
        self.clustered: Dict[str, str] = {}

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    def add_table(self, name: str,
                  data: Union[ColumnTable, Dict[str, np.ndarray]],
                  rows_per_partition: int,
                  cluster_key: Optional[str] = None) -> None:
        """Shard ``data`` into fixed-row partitions (views of one device
        tensor per column); numpy columns are copied to the device once.

        With ``cluster_key`` the table is first stably sorted by that key,
        and each partition boundary is pushed forward to the end of the
        key run it lands in: partitions stay about ``rows_per_partition``
        rows, but no key value straddles two partitions."""
        if not isinstance(data, ColumnTable):
            data = ColumnTable.from_numpy(data, self.device)
        n = len(data)
        if cluster_key is not None:
            key, order = torch.sort(sort_key(data.cols[cluster_key]),
                                    stable=True)
            data = data.take(order)
            self.clustered[name] = cluster_key
            bounds = [0]
            while bounds[-1] < n:
                j = min(n, bounds[-1] + rows_per_partition)
                if j < n:  # to the end of the run of key[j - 1]
                    j = int(torch.searchsorted(key, key[j - 1:j],
                                               right=True))
                bounds.append(j)
        else:
            bounds = [min(n, i * rows_per_partition) for i in
                      range(max(1, -(-n // rows_per_partition)) + 1)]
        parts: List[Partition] = []
        for i, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            chunk = ColumnTable({k: v[lo:hi] for k, v in data.cols.items()})
            node = self.nodes[i % self.num_nodes]
            part = Partition(name, i, node.node_id, chunk)
            node.partitions.append(part)
            parts.append(part)
        self.tables[name] = parts

    def append_to_partition(self, table: str, index: int,
                            rows: ColumnTable) -> Partition:
        """Append ``rows`` (on the catalog's device) to one partition and
        bump its version stamp. The partition gets new column tensors, so
        its column stats are computed anew from the new bytes. Appended
        rows must keep a clustered table's group locality (no cluster-key
        value owned by another partition)."""
        part = self.tables[table][index]
        part.data = ColumnTable({c: torch.cat([v, rows.cols[c]])
                                 for c, v in part.data.cols.items()})
        part.version += 1
        return part

    def update_partition(self, table: str, index: int,
                         data: ColumnTable) -> Partition:
        """Replace one partition's bytes wholesale and bump its version
        stamp (the same staleness contract as ``append_to_partition``)."""
        part = self.tables[table][index]
        part.data = data
        part.version += 1
        return part

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
                        device=None,
                        cluster: Optional[Dict[str, str]] = None) -> Catalog:
    """A catalog over numpy tables, partitioned as the reference's
    ``tpch.build_catalog`` does: ``lineitem`` in ``rows_per_partition``
    rows, every other table in ``num_nodes * 4`` objects. ``cluster`` maps
    table -> cluster key (``Catalog.add_table(cluster_key=)``)."""
    cat = Catalog(num_nodes, device)
    cluster = cluster or {}
    for name, cols in tables.items():
        n = len(next(iter(cols.values())))
        rpp = rows_per_partition if name == "lineitem" else max(
            n // max(1, num_nodes * 4), 1)
        cat.add_table(name, cols, rpp, cluster_key=cluster.get(name))
    return cat
