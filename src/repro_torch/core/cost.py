"""The paper's lightweight cost model (§3.3, Eq. 8-11).

Port of ``repro.core.cost`` (``StorageResources`` and ``RequestCost``):

    t_pd = t_scan + S_in / C_storage + S_out / BW_net        (Eq. 8-9)
    t_pb = t_scan + S_in / BW_net                            (Eq. 10-11)

``t_scan`` appears in both and cancels in the Arbitrator's comparison.
``storage_power`` in (0, 1] scales the cores available for pushdown, as
the paper caps the storage node's thread pool (§6.2).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StorageResources:
    """Per-storage-node resources (defaults ~ the paper's r5d.4xlarge:
    16 vCPU, 2x NVMe, 10 Gbps)."""
    cores: int = 16
    core_bw: float = 800e6      # bytes/s of pushdown compute per core
    disk_bw: float = 8e9        # warm scan path
    net_bw: float = 1.25e9      # 10 Gbps storage<->compute pipe
    net_streams: int = 16       # max concurrent transfers (pushback slots)
    storage_power: float = 1.0  # fraction of cores available (multi-tenancy)

    @property
    def pd_slots(self) -> int:
        """Pushdown execution slots S_exec-pd (>= 1)."""
        return max(1, round(self.cores * self.storage_power))

    @property
    def eff_core_bw(self) -> float:
        """Per-slot compute bandwidth (a core fraction below one core)."""
        return self.core_bw * min(1.0, self.cores * self.storage_power)

    @property
    def pb_slots(self) -> int:
        """Pushback execution slots S_exec-pb (network streams)."""
        return self.net_streams

    @property
    def stream_bw(self) -> float:
        """Fixed per-request network share BW_net (paper assumption §3.3)."""
        return self.net_bw / self.net_streams


@dataclasses.dataclass(frozen=True)
class RequestCost:
    """Static byte counts of one pushdown request."""
    s_in: int        # stored bytes of accessed columns
    s_out: int       # estimated pushdown-result bytes
    compute_in: int  # bytes the pushdown computation must chew through

    def t_scan(self, res: StorageResources) -> float:
        return self.s_in / res.disk_bw

    def t_compute(self, res: StorageResources) -> float:
        return self.compute_in / res.eff_core_bw

    def t_pd(self, res: StorageResources, include_scan: bool = True) -> float:
        t = self.t_compute(res) + self.s_out / res.stream_bw
        return t + (self.t_scan(res) if include_scan else 0.0)

    def t_pb(self, res: StorageResources, include_scan: bool = True) -> float:
        t = self.s_in / res.stream_bw
        return t + (self.t_scan(res) if include_scan else 0.0)

    def pa(self, res: StorageResources) -> float:
        """Pushdown Amenability, Eq. 12 (scan cancels)."""
        return self.t_pb(res, False) - self.t_pd(res, False)
