"""The arithmetic the metric readers share: tails over all queries, rates
over the whole window, host spans per query, the plan pass's roofline and
the device's idle share. Each function returns None where the run holds
nothing to read, so that the metric is left out of the line."""
from __future__ import annotations

import bisect
import math
from typing import Iterable, Optional

from olapbench import compare, devtrace


def percentile(values, q: float) -> Optional[float]:
    """The nearest-rank ``q``-quantile: the smallest sample with at least
    ``q`` of all samples at or below it."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q * len(v)) - 1)]


def latency_p95_ms(run) -> Optional[float]:
    p = percentile(run.latencies_s, 0.95)
    return None if p is None else p * 1e3


def queries_per_s(run) -> Optional[float]:
    """Queries completed over the whole window, from its start to the end
    of its last query."""
    if not run.done or run.window_s <= 0:
        return None
    return len(run.done) / run.window_s


def span_s(run, names: Iterable[str]) -> float:
    names = set(names)
    return sum(b - a for a, b, n, _, _ in run.spans if n in names) / 1e9


def compile_s(run) -> float:
    """Seconds from each call of ``compile_and_run`` to the start of its
    ``query`` span: the compiler, which opens no span of its own on the
    uncosted path."""
    starts = sorted(a for a, _, n, _, _ in run.spans if n == "query")
    total = 0
    for d in run.done:
        i = bisect.bisect_left(starts, d.called_ns)
        if i < len(starts):
            total += starts[i] - d.called_ns
    return total / 1e9


def ms_per_query(run, seconds: float) -> Optional[float]:
    if not run.spans or not run.done:
        return None
    return seconds / len(run.done) * 1e3


def pushdown_roofline(run) -> Optional[float]:
    """The storage-side plan pass's share of its roofline, in percent: the
    least time in which the card could read every accessed column of every
    partition the window's queries scanned once (``compare.scanned_bytes``
    over the HBM rate of ``peaks``), over the device time of the work
    launched inside ``storage_execute`` and ``compute_replay`` spans."""
    if run.device is None or not run.hbm_bytes_per_s or not run.done:
        return None
    spans = sorted((a, b) for a, b, n, _, _ in run.spans
                   if n in ("storage_execute", "compute_replay"))
    busy = devtrace.work_launched_in(run.device, spans)
    if busy <= 0:
        return None
    nbytes = sum(compare.scanned_bytes(run.tables, run.mix["accessed"][d.qid])
                 for d in run.done)
    return nbytes / run.hbm_bytes_per_s / busy * 100.0


def idle_share(run) -> Optional[float]:
    """Percent of the traced window in which the card ran nothing."""
    if run.device is None:
        return None
    lo, hi = run.device.window
    busy = devtrace.device_busy_s(devtrace.clip(run.device))
    return (1.0 - busy / ((hi - lo) / 1e9)) * 100.0


def pushback_share(run) -> Optional[float]:
    """Percent of the completed queries' requests the Arbitrator pushed
    back."""
    n = sum(d.n_requests for d in run.done)
    return sum(len(d.pushback) for d in run.done) / n * 100.0 if n else None
