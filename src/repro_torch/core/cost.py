"""The paper's lightweight cost model (§3.3, Eq. 8-11).

Port of ``repro.core.cost``: ``StorageResources``, ``RequestCost``, the
frontier-cut score and the online cardinality corrector:

    t_pd = t_scan + S_in / C_storage + S_out / BW_net        (Eq. 8-9)
    t_pb = t_scan + S_in / BW_net                            (Eq. 10-11)

``t_scan`` appears in both and cancels in the Arbitrator's comparison.
``storage_power`` in (0, 1] scales the cores available for pushdown, as
the paper caps the storage node's thread pool (§6.2).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Optional, Tuple


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

    def with_power(self, power: float) -> "StorageResources":
        return dataclasses.replace(self, storage_power=power)


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

    def with_s_out(self, s_out: int) -> "RequestCost":
        return dataclasses.replace(self, s_out=int(max(64, s_out)))

    def shuffled(self) -> "RequestCost":
        """The cost of the same request with the §4.2 partition function
        run storage-side: hashing and routing the rows add
        ``SHUFFLE_ROUTE_FACTOR`` to the bytes the pushdown chews through."""
        return dataclasses.replace(
            self, compute_in=int(self.compute_in * SHUFFLE_ROUTE_FACTOR))


# storage-side hash + route of a shuffled request (§4.2), on compute_in
SHUFFLE_ROUTE_FACTOR = 1.05


def cut_score(cost: RequestCost, res: StorageResources,
              has_operator_work: bool, cache_hit: bool = False) -> float:
    """What the cost-based frontier chooser minimizes per request: the
    predicted storage-side operator CPU plus the result-ship time (``s_out``
    over the per-stream share). The scan term is the same for every
    candidate cut of one table and cancels, as in Algorithm 1.

    ``has_operator_work`` is False for the raw-projection baseline (a bare
    ``scan`` cut): the storage node streams the accessed columns without
    running an operator, so it pays ship time only. That is what makes a
    partial aggregate over a high-NDV group key (Q18: partials about as
    many as the input rows) lose to cutting at the scan.

    ``cache_hit`` zeroes the CPU term: a warm entry of the pushed-result
    cache (``core.result_cache``) ships its bytes without running the
    operators again, so only the ship time remains. ``plan_requests``
    makes the same collapse per request (``compute_in=0`` and the entry's
    bytes as ``s_out``)."""
    cpu = (cost.t_compute(res)
           if has_operator_work and not cache_hit else 0.0)
    return cpu + cost.s_out / res.stream_bw


class CardinalityCorrector:
    """Online correction of the cost model's ``s_out`` estimates.

    ``runtime.feed_corrector`` hands it, per executed query, the bytes the
    pushdown requests really shipped against their uncorrected estimate.
    Its state is an EWMA **in log space** of ``log(real / estimated)``
    keyed by ``(query, table, frontier signature)``, so a ratio learned
    for ``scan+agg`` on Q18's lineitem never applies to the ``scan``
    candidate of the same table, with a ``(query, table)`` fallback for
    unseen signatures. With a stationary workload the log-error after k
    observations is ``(1 - alpha)^k`` of the first. Corrections are
    clamped to ``[1/clamp, clamp]`` and only ever rescale ``s_out``:
    decisions may flip, results cannot.

    ``engine.plan_requests`` rescales each request's cost with it, and
    ``compile.compile_query_costed`` each candidate cut's score.
    Thread-safe."""

    def __init__(self, alpha: float = 0.5, clamp: float = 32.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha {alpha} outside (0, 1]")
        self.alpha = alpha
        self.clamp = clamp
        self._log: Dict[Tuple[str, str, Optional[str]], float] = {}
        self._n: Dict[Tuple[str, str, Optional[str]], int] = {}
        self._lock = threading.Lock()

    def _clamped(self, log_r: float) -> float:
        return float(min(self.clamp, max(1.0 / self.clamp, math.exp(log_r))))

    def ratio(self, qid: str, table: str, sig: Optional[str] = None,
              exact: bool = False) -> float:
        """Multiplier for an ``s_out`` estimate (1.0: nothing learned).
        ``exact=True`` disables the (query, table) fallback: the cut
        chooser compares candidates of different signatures, so a ratio
        measured under one frontier must not leak onto another."""
        with self._lock:
            key = (qid, table, sig)
            if key not in self._log and not exact:
                key = (qid, table, None)
            log_r = self._log.get(key)
        return 1.0 if log_r is None else self._clamped(log_r)

    def correct(self, qid: str, table: str, sig: Optional[str],
                cost: RequestCost, exact: bool = False) -> RequestCost:
        r = self.ratio(qid, table, sig, exact=exact)
        return cost if r == 1.0 else cost.with_s_out(round(cost.s_out * r))

    def snapshot(self) -> Dict[str, float]:
        """The learned ratios by key, clamped as ``ratio()`` applies them."""
        with self._lock:
            return {"/".join(str(p) for p in key if p is not None):
                    self._clamped(v) for key, v in self._log.items()}

    def observe(self, qid: str, table: str, sig: Optional[str],
                est_s_out: float, real_s_out: float) -> None:
        """Feed one (estimate, actual) pair of pushdown bytes. The estimate
        must be the uncorrected one, so the state tracks the model's raw
        bias and repeated observation does not compound."""
        if est_s_out <= 0 or real_s_out <= 0:
            return
        obs = math.log(real_s_out / est_s_out)
        with self._lock:
            for key in ((qid, table, sig), (qid, table, None)):
                prev = self._log.get(key)
                self._log[key] = obs if prev is None \
                    else (1.0 - self.alpha) * prev + self.alpha * obs
                self._n[key] = self._n.get(key, 0) + 1

    def state(self, qid: Optional[str] = None) -> Dict[str, Dict]:
        """Applied ratio and observation count per learned key (of one
        query when ``qid`` is given)."""
        with self._lock:
            items = list(self._log.items())
            counts = dict(self._n)
        return {"/".join(str(p) for p in key if p is not None):
                {"ratio": self._clamped(log_r), "n": counts.get(key, 0)}
                for key, log_r in items if qid is None or key[0] == qid}

    @property
    def n_observations(self) -> int:
        with self._lock:
            return sum(n for (_q, _t, s), n in self._n.items() if s is None)
