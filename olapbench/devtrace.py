"""Reading the device's side of a traced window from ``torch.profiler``.

The profiler records CUDA activity only: kernels, copies and sets on the
card, and the CUDA runtime calls that launched them, each launch linked
to its device work by a correlation id. Host spans come from the
program's own tracer (``repro_torch.obs.trace``), on ``perf_counter``'s
clock; the profiler's clock is mapped onto it by the two
``cudaDeviceSynchronize`` calls that open and close the window
(``Marks``).
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Sequence, Tuple

import torch

SYNC = "cudaDeviceSynchronize"


@dataclasses.dataclass
class DeviceTrace:
    """What the profiler saw, in nanoseconds of ``perf_counter``'s clock."""
    work: List[Tuple[int, int, str, int]]   # (start, end, name, correlation)
    launches: List[Tuple[int, int]]         # (host time, correlation)
    window: Tuple[int, int]                 # the traced window
    offset_ns: int                          # profiler clock - host clock
    drift_ns: int                           # the two marks' disagreement


class Marks:
    """Host times of the two synchronising calls that open and close the
    traced window."""

    def __init__(self):
        self.host: List[Tuple[int, int]] = []

    def mark(self) -> None:
        a = time.perf_counter_ns()
        torch.cuda.synchronize()
        self.host.append((a, time.perf_counter_ns()))


def device_busy_s(spans: Sequence[Tuple[float, float]]) -> float:
    """Seconds in which the card ran at least one kernel or copy: the union
    of the device events' intervals (a frozen copy of ``chip_smoke.py``'s
    ``device_busy_s``, commit e9a3657, over (start, end) pairs in ns)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e9


def busy_intervals(work) -> List[Tuple[int, int]]:
    """The union of the device work's intervals, in time order."""
    out: List[Tuple[int, int]] = []
    for a, b, _, _ in sorted(work):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _events(prof):
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        raise RuntimeError("the profiler kept no kineto results")
    return res.events()


def read(prof, marks: Marks) -> DeviceTrace:
    """The device work and launches of a profile whose window ``marks``
    opened and closed."""
    cuda = torch.autograd.DeviceType.CUDA
    work, launches, syncs = [], [], []
    for e in _events(prof):
        if e.device_type() == cuda:
            a = e.start_ns()
            work.append((a, a + e.duration_ns(), e.name(),
                         e.correlation_id()))
        else:
            name = e.name()
            if name == SYNC:
                syncs.append(e.start_ns())
            launches.append((e.start_ns(), e.correlation_id()))
    if len(syncs) < 2 or len(marks.host) < 2:
        raise RuntimeError(f"the trace holds {len(syncs)} {SYNC} calls; "
                           f"the window needs its two marks")
    first, last = min(syncs), max(syncs)
    (a0, b0), (a1, b1) = marks.host[0], marks.host[-1]
    off0, off1 = first - a0, last - a1  # each call starts as it is made
    off = (off0 + off1) // 2
    work = [(a - off, b - off, n, c) for a, b, n, c in work]
    launches = sorted((t - off, c) for t, c in launches)
    return DeviceTrace(work, launches, (b0, a1), off, abs(off1 - off0))


def clip(trace: DeviceTrace) -> List[Tuple[int, int]]:
    """The device intervals inside the window."""
    lo, hi = trace.window
    return [(max(a, lo), min(b, hi)) for a, b, _, _ in trace.work
            if b > lo and a < hi]


def work_launched_in(trace: DeviceTrace,
                     intervals: Sequence[Tuple[int, int]]) -> float:
    """Seconds of device work launched by host calls that fall inside
    ``intervals`` (host-clock ns, sorted, disjoint)."""
    starts = [a for a, _ in intervals]
    inside = set()
    for t, corr in trace.launches:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < intervals[i][1]:
            inside.add(corr)
    return sum(b - a for a, b, _, c in trace.work if c in inside) / 1e9


def top_ops(trace: DeviceTrace, k: int = 10) -> List[List]:
    by: Dict[str, int] = {}
    lo, hi = trace.window
    for a, b, name, _ in trace.work:
        if b > lo and a < hi:
            by[name] = by.get(name, 0) + min(b, hi) - max(a, lo)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[n[:200], v / 1e9] for n, v in top]


def idle_gaps(trace: DeviceTrace, spans, k: int = 10) -> List[List]:
    """The ``k`` longest stretches of the window in which the card ran
    nothing, each named by the innermost host span open at its middle
    (``harness`` where none was: the benchmark's own loop)."""
    lo, hi = trace.window
    busy = busy_intervals([(max(a, lo), min(b, hi), "", 0)
                           for a, b, _, _ in trace.work
                           if b > lo and a < hi])
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:k]:
        mid = (a + b) // 2
        inner = [s for s in spans if s[0] <= mid < s[1]]
        name = max(inner, key=lambda s: s[0])[2] if inner else "harness"
        out.append([name, (b - a) / 1e9])
    return out
