"""Readings beneath the ``query`` span: the program's finer spans, events
and counters (the residual's ``op.*`` spans, the uncosted ``compile``
span, ``device_sync`` events, and the simulator's ``sim.*`` counters
over the traced window).

Each function returns None where the run holds nothing to read: an
untraced run, or a program that records none of these (one older than
them), so that the metric is left out of the line. A program that
records them has ``obs.trace.last_counters``; where it has and the
window held no ``device_sync``, the reading is 0.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

from repro_torch.obs import trace

SPLIT, RESIDUAL = "execute_split", "residual_compute"


def records() -> bool:
    """Whether the program records these spans, events and counters."""
    return getattr(trace, "last_counters", None) is not None


def _per_query(run, total: float) -> Optional[float]:
    return total / len(run.done) if run.done else None


def named_ms_per_query(run, names: Iterable[str]) -> Optional[float]:
    """Host ms a query in the spans of ``names``; None where the window
    holds none of them."""
    names = set(names)
    durs = [b - a for a, b, n, _, _ in run.spans if n in names]
    if not durs:
        return None
    return _per_query(run, sum(durs) / 1e6)


def syncs_by_layer(run) -> Dict[str, int]:
    """``device_sync`` events counted by their nearest ancestor of
    ``execute_split`` and ``residual_compute`` (others are not counted)."""
    by_id = {sid: (n, parent) for _, _, n, sid, parent in run.spans}
    out = {SPLIT: 0, RESIDUAL: 0}
    for _, _, n, _, parent in run.spans:
        if n != "device_sync":
            continue
        while parent is not None and parent in by_id:
            name, parent = by_id[parent]
            if name in out:
                out[name] += 1
                break
    return out


def syncs_per_query(run, layer: str) -> Optional[float]:
    if not run.spans or not records():
        return None
    return _per_query(run, syncs_by_layer(run)[layer])


def window_counter(run, name: str) -> Optional[float]:
    """The registry counter ``name`` over the traced window: the program's
    ``last_counters()``, the deltas of the tracer the harness installed
    for the window and took away after it."""
    if not run.spans or not records():
        return None
    return trace.last_counters().get(name)
