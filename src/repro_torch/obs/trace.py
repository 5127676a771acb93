"""Per-query spans and decision channels on the host: off by default,
free when off.

Port of ``repro.obs.trace``. Every hook of the engine routes through the
module-level tracer, and the default ``NULL_TRACER`` makes each
``span(...)``/``event(...)``/``start(...)``/``amend(...)`` a
constant-time no-op: a shared context manager that yields a shared, falsy
null span whose ``set()`` swallows everything. Code that computes
attributes for a span tests ``tracer.enabled`` first, so a run with
tracing off does no extra work.

Span parenting: within one thread ``tracer.span(...)`` context managers
nest through a thread-local stack; across threads (``run_stream``'s
worker pools) the submitting code passes ``parent=`` and opens detached
spans with ``start``/``end``. A sink (``attach_sink``, e.g.
``obs.export.JsonlStreamWriter``) hears every span open and close. Span
times are host-clock seconds: a span around device work ends when the
host returns, not when the card is done.

``DecisionChannel`` is a bounded, thread-safe event log. Each ``Tracer``
owns one (``decisions``) that the Arbitrator feeds with the queue depth
and free slots at each batch of path assignments. One module-level
channel records the batch executor's filter decisions whether or not
tracing is on (``record_filter_decision``), and counts them in the
``executor.filter.<branch>`` counters.

Span attributes hold host values: a tensor attribute of more than one
element would make an exporter copy it off the device.

A run over a compute cluster (``core.cluster``) adds a ``route`` span
(cat ``shuffle``: ``table``, ``nodes``, ``rows_routed``, ``rows``) a
routed table under ``execute_split``, a ``gather`` span (cat ``shuffle``:
``nodes``, ``rows``, ``bytes``) each time the residual collects a table's
slices on node 0, and a ``node`` attribute on the ``op.*`` spans of the
operators that run once a node; its ``shuffle.routed_rows``,
``shuffle.redistributed_bytes``, ``shuffle.broadcast_bytes`` and
``shuffle.gather_bytes`` counters are added once a query, traced or not.

While an enabled tracer is installed (``set_tracer``), three hooks hear
what no span brackets: every garbage collection is a closed ``gc`` span
(cat ``host``, ``generation``, ``collected``) under the thread's current
span, recorded when the collection ends and handed to a sink only later,
from outside the collector, since a collection may run inside a sink's
own lock; where CUDA is initialised, every synchronising CUDA call made
inside an open span is a zero-length ``device_sync`` event under it
(torch's sync debug mode set to ``"warn"``, its warning recorded and not
printed); and the registry's counters are read at install and
uninstall, their deltas kept for ``last_counters()``. Uninstalling
restores the collector's callbacks, the sync debug mode and the warning
filters; with tracing off none of the hooks is in place.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import sys
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional

from repro_torch.obs.metrics import get_metrics

__all__ = [
    "Span", "Tracer", "DecisionChannel", "NULL_TRACER",
    "get_tracer", "set_tracer", "tracing", "last_counters",
    "record_filter_decision", "filter_decision_channel",
]

_DEVICE_SYNC = "device_sync"   # a host wait on the card, inside a span
_GC_SPAN = "gc"                # a garbage collection
# the start of torch's warning in sync debug mode "warn"
_SYNC_WARNING = "called a synchronizing CUDA operation"
_PROTOTYPE_WARNING = "Synchronization debug mode is a prototype"


class Span:
    """One timed node of a query's span tree."""

    __slots__ = ("sid", "parent", "name", "cat", "t0", "dur", "tid", "attrs")

    def __init__(self, sid: int, parent: Optional[int], name: str, cat: str,
                 t0: float, tid: int, attrs: Dict):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.cat = cat
        self.t0 = t0              # seconds since the tracer's epoch
        self.dur: Optional[float] = None   # seconds; None while open
        self.tid = tid
        self.attrs = attrs

    def set(self, **attrs) -> "Span":
        """Attach attributes (merging over earlier ones)."""
        self.attrs.update(attrs)
        return self

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, sid={self.sid}, parent={self.parent}, "
                f"dur={self.dur}, attrs={self.attrs})")


class _NullSpan:
    """Falsy, attribute-swallowing stand-in used when tracing is off."""

    __slots__ = ()
    sid = -1
    parent = None
    name = ""
    cat = ""
    t0 = 0.0
    dur = 0.0
    tid = 0
    attrs: Dict = {}

    def set(self, **_attrs) -> "_NullSpan":
        return self

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _NullCM:
    """Reusable no-op context manager yielding the shared null span."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return NULL_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_NULL_CM = _NullCM()


class DecisionChannel:
    """Bounded, thread-safe decision log (append-only up to ``cap``).

    Appends beyond the cap are counted (``dropped``) instead of growing
    memory. The hot path (``record``)
    leans on CPython's atomic ``list.append`` — no lock per decision, which
    matters at arbitration rates (hundreds of records per traced query);
    under a concurrent race at the exact cap boundary the channel may admit
    a few extra items (bounded by the number of racing threads), which is
    an acceptable trade for a memory *bound*. Readers and the dropped
    counter still serialize on the lock."""

    def __init__(self, cap: int = 8192):
        self.cap = cap
        self._items: List[Dict] = []
        self._dropped = 0
        self._lock = threading.Lock()

    def record(self, **fields) -> None:
        items = self._items
        if len(items) < self.cap:
            items.append(fields)        # atomic under the GIL
        else:
            with self._lock:
                self._dropped += 1

    def record_batch(self, assigned, **shared) -> None:
        """One compact entry for a batch of ``(req_id, path)`` decisions
        sharing the same load state (the Arbitrator drains whole batches
        under one queue/slot snapshot). The hot path appends a single
        tuple; readers expand to per-decision dicts lazily."""
        if not assigned:
            return
        items = self._items
        if len(items) < self.cap:
            items.append((tuple(assigned), shared))
        else:
            with self._lock:
                self._dropped += len(assigned)

    @staticmethod
    def _expand(entry) -> List[Dict]:
        if isinstance(entry, dict):
            return [dict(entry)]
        assigned, shared = entry
        return [dict(shared, req_id=rid, path=path)
                for rid, path in assigned]

    def snapshot(self) -> List[Dict]:
        """Copy of the recorded decisions (read-only view for callers)."""
        with self._lock:
            return [d for e in self._items for d in self._expand(e)]

    def counts(self, field: str) -> Dict:
        out: Dict = {}
        with self._lock:
            for e in self._items:
                for d in self._expand(e):
                    v = d.get(field)
                    out[v] = out.get(v, 0) + 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self._dropped = 0

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return sum(1 if isinstance(e, dict) else len(e[0])
                       for e in self._items)


class _SpanCM:
    """Hand-rolled span context manager (a generator-based
    ``@contextmanager`` costs several microseconds a use)."""

    __slots__ = ("_tr", "_name", "_cat", "_parent", "_attrs", "_sp",
                 "_stack")

    def __init__(self, tr: "Tracer", name: str, cat: str,
                 parent: Optional["Span"], attrs: Dict):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._parent = parent
        self._attrs = attrs
        self._sp: Optional[Span] = None
        self._stack: Optional[List[Span]] = None

    def __enter__(self):
        sp = self._tr._new(self._name, self._cat, self._parent, self._attrs)
        if sp is None:
            return NULL_SPAN
        self._sp = sp
        stack = self._stack = self._tr._stack()
        stack.append(sp)
        return sp

    def __exit__(self, *exc) -> bool:
        sp = self._sp
        if sp is not None:
            sp.dur = time.perf_counter() - self._tr.t0 - sp.t0
            stack = self._stack
            if stack and stack[-1] is sp:
                stack.pop()
            elif sp in stack:          # mis-nested exit: drop just ours
                stack.remove(sp)
            sink = self._tr.sink
            if sink is not None:
                sink.on_end(sp)
        return False


class Tracer:
    """Collects a span forest for one (or several) traced runs.

    - ``span(name, ...)``: context manager; parents to the current
      thread's innermost open ``span(...)`` unless ``parent=`` is given.
    - ``start(name, ...)`` / ``end(span, ...)``: explicit pair for spans
      whose lifetime crosses threads (started by the submitter, ended by
      the finisher). Detached: never pushed on any thread-local stack.
    - ``event(name, ...)``: zero-duration span (instant).

    Span creation is lock-free: ids come from an atomic counter and
    ``list.append`` is atomic under the GIL, so the hot path pays no lock
    (a concurrent race at the exact ``max_spans`` boundary may admit a few
    extra spans — acceptable for a memory *bound*). ``max_spans`` keeps a
    runaway loop dropping spans rather than filling the heap.
    """

    enabled = True
    # optional streaming sink (e.g. ``obs.export.JsonlStreamWriter``):
    # ``on_start(span)`` fires the moment a span opens, ``on_end(span)``
    # when it closes — the crash-safe export path. Class-level None keeps
    # the sink-less hot path to a single attribute test per span.
    sink = None

    def __init__(self, max_spans: int = 1_000_000):
        self.t0 = time.perf_counter()
        self.max_spans = max_spans
        self.spans: List[Span] = []
        self.dropped = 0
        self.decisions = DecisionChannel()   # arbitration decision channel
        self._local = threading.local()
        self._sid = itertools.count()

    def attach_sink(self, sink) -> "Tracer":
        """Stream every span start/end to ``sink`` (None detaches)."""
        self.sink = sink
        return self

    # ------------------------------------------------------------ internals
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _new(self, name: str, cat: str, parent: Optional[Span],
             attrs: Dict) -> Optional[Span]:
        pid = None
        if parent is not None:
            pid = parent.sid if parent.sid >= 0 else None
        else:
            stack = self._stack()
            if stack:
                pid = stack[-1].sid
        spans = self.spans
        if len(spans) >= self.max_spans:
            self.dropped += 1       # soft counter: benign race
            return None
        # slots assigned inline — skipping the __init__ frame is worth
        # a few hundred ns at engine span rates
        sp = Span.__new__(Span)
        sp.sid = next(self._sid)
        sp.parent = pid
        sp.name = name
        sp.cat = cat
        sp.dur = None
        sp.tid = threading.get_ident()
        sp.attrs = attrs
        sp.t0 = time.perf_counter() - self.t0
        spans.append(sp)            # atomic under the GIL
        sink = self.sink
        if sink is not None:
            if _gc_unsent:
                _send_gc()
            sink.on_start(sp)
        return sp

    # ------------------------------------------------------------ public
    def span(self, name: str, cat: str = "engine",
             parent: Optional[Span] = None, **attrs) -> "_SpanCM":
        """Context manager for a same-thread span."""
        return _SpanCM(self, name, cat, parent, attrs)

    def start(self, name: str, cat: str = "engine",
              parent: Optional[Span] = None, **attrs) -> Span:
        """Open a detached span (close it with :meth:`end`, any thread)."""
        sp = self._new(name, cat, parent, attrs)
        return sp if sp is not None else NULL_SPAN

    def end(self, span: Span, **attrs) -> None:
        if span is NULL_SPAN or not isinstance(span, Span):
            return
        if attrs:
            span.attrs.update(attrs)
        span.dur = time.perf_counter() - self.t0 - span.t0
        sink = self.sink
        if sink is not None:
            sink.on_end(span)

    def event(self, name: str, cat: str = "engine",
              parent: Optional[Span] = None, **attrs) -> Span:
        sp = self._new(name, cat, parent, attrs)
        if sp is None:
            return NULL_SPAN
        sp.dur = 0.0
        sink = self.sink
        if sink is not None:
            sink.on_end(sp)
        return sp

    def amend(self, span: Span, **attrs) -> None:
        """Attach attrs to an already-closed span (accounting computed
        after the fact, e.g. ``shipped_bytes``), re-notifying a streaming
        sink so the crash-safe export carries them too — ``from_jsonl``
        merges the re-emitted end record over the first one."""
        if span is NULL_SPAN or not isinstance(span, Span):
            return
        span.attrs.update(attrs)
        sink = self.sink
        if sink is not None and span.dur is not None:
            sink.on_end(span)

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    # -------------------------------------------------------------- reads
    def snapshot(self) -> List[Span]:
        return list(self.spans)     # list copy is atomic under the GIL

    def find(self, name: str) -> List[Span]:
        return [s for s in self.snapshot() if s.name == name]

    def tree(self) -> List[Dict]:
        """The span forest as nested dicts (roots in creation order)."""
        spans = self.snapshot()
        nodes = {s.sid: {"name": s.name, "cat": s.cat, "t0": s.t0,
                         "dur": s.dur, "attrs": dict(s.attrs), "children": []}
                 for s in spans}
        roots: List[Dict] = []
        for s in spans:
            if s.parent is not None and s.parent in nodes:
                nodes[s.parent]["children"].append(nodes[s.sid])
            else:
                roots.append(nodes[s.sid])
        return roots


class _NullTracer(Tracer):
    """The disabled tracer: every hook is a constant-time no-op."""

    enabled = False

    def __init__(self):  # no state beyond a drop-everything channel
        self.t0 = 0.0
        self.max_spans = 0
        self.spans = []
        self.dropped = 0
        self.decisions = DecisionChannel(cap=0)

    def span(self, name, cat="engine", parent=None, **attrs):
        return _NULL_CM

    def start(self, name, cat="engine", parent=None, **attrs):
        return NULL_SPAN

    def end(self, span, **attrs):
        return None

    def amend(self, span, **attrs):
        return None

    def event(self, name, cat="engine", parent=None, **attrs):
        return NULL_SPAN

    def current(self):
        return None

    def snapshot(self):
        return []

    def tree(self):
        return []


NULL_TRACER = _NullTracer()

_tracer: Tracer = NULL_TRACER
# the registry's counters when an enabled tracer went in, and their deltas
# over the last stretch one was installed
_counters_at_install: Dict[str, float] = {}
_last_counters: Dict[str, float] = {}


def get_tracer() -> Tracer:
    """The process-wide tracer every engine hook routes through."""
    return _tracer


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` (None -> disable); returns the previous one.
    The hooks of an enabled tracer (the module's docstring) go in when
    tracing turns on and come out when it turns off."""
    global _tracer, _counters_at_install, _last_counters
    prev = _tracer
    new = tracer if tracer is not None else NULL_TRACER
    if prev.enabled:
        now = get_metrics().snapshot()["counters"]
        _last_counters = {k: v - _counters_at_install.get(k, 0.0)
                          for k, v in now.items()}
    if new.enabled:
        _counters_at_install = get_metrics().snapshot()["counters"]
    if new.enabled and not prev.enabled:
        _install_hooks()
    elif prev.enabled and not new.enabled:
        _remove_hooks()
    if _gc_unsent:      # after the hooks are out: no span is left unsent
        _send_gc()
    _tracer = new
    return prev


def last_counters() -> Dict[str, float]:
    """What the registry's counters counted over the last stretch an
    enabled tracer was installed, for a caller that no longer holds it."""
    return dict(_last_counters)


# ------------------------------------------------ hooks of enabled tracing
_gc_start = None             # (tracer, parent sid, t0, generation) under way
_gc_unsent = collections.deque()   # (tracer, gc span) no sink has heard
_sync_route = None           # the saved warning state while syncs are heard


def _on_gc(phase: str, info: Dict) -> None:
    """Record a collection as a closed span without calling a sink: the
    collector may run inside a sink's lock (a write that allocates), so
    the span waits in ``_gc_unsent`` for the next span that opens."""
    global _gc_start
    if phase == "start":
        tr = _tracer
        if tr.enabled:
            stack = getattr(tr._local, "stack", None)
            _gc_start = (tr, stack[-1].sid if stack else None,
                         time.perf_counter(), info["generation"])
        return
    if _gc_start is None:
        return
    tr, pid, t0, generation = _gc_start
    _gc_start = None
    if len(tr.spans) >= tr.max_spans:
        tr.dropped += 1
        return
    sp = Span.__new__(Span)
    sp.sid = next(tr._sid)
    sp.parent = pid
    sp.name = _GC_SPAN
    sp.cat = "host"
    sp.tid = threading.get_ident()
    sp.attrs = {"generation": generation, "collected": info["collected"]}
    sp.t0 = t0 - tr.t0
    sp.dur = time.perf_counter() - t0
    tr.spans.append(sp)
    if tr.sink is not None:
        _gc_unsent.append((tr, sp))


def _send_gc() -> None:
    """Hand the recorded ``gc`` spans to their tracers' sinks: those there
    now, since a sink's writes may collect and record more."""
    for _ in range(len(_gc_unsent)):
        try:
            tr, sp = _gc_unsent.popleft()
        except IndexError:      # another thread took the last one
            return
        sink = tr.sink
        if sink is not None:
            sink.on_start(sp)
            sink.on_end(sp)


def _on_sync() -> None:
    tr = _tracer
    if tr.enabled and tr.current() is not None:
        tr.event(_DEVICE_SYNC, cat="device")


def _install_hooks() -> None:
    """The ``gc`` callback, and where CUDA is initialised and torch's sync
    debug mode is at its default, the ``device_sync`` route: the mode set
    to ``"warn"``, its warning let through every time and heard by a
    ``showwarning`` that records it and passes every other warning on.
    torch is not imported here: tracing stays host-only where nothing
    else loaded it."""
    global _sync_route
    gc.callbacks.append(_on_gc)
    torch = sys.modules.get("torch")
    if (torch is None or not torch.cuda.is_initialized()
            or torch.cuda.get_sync_debug_mode() != 0):
        return
    _sync_route = warnings.catch_warnings()
    _sync_route.__enter__()
    show = warnings.showwarning

    def hear(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(_SYNC_WARNING):
            _on_sync()
        else:
            show(message, category, filename, lineno, file, line)

    warnings.filterwarnings("always", message=_SYNC_WARNING)
    # torch says once a process that the mode is a prototype that may miss
    # syncs; the benchmark's traced runs hold the count to the profiler's
    warnings.filterwarnings("ignore", message=_PROTOTYPE_WARNING)
    warnings.showwarning = hear
    torch.cuda.set_sync_debug_mode("warn")


def _remove_hooks() -> None:
    global _sync_route, _gc_start
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    _gc_start = None
    if _sync_route is not None:
        sys.modules["torch"].cuda.set_sync_debug_mode(0)
        _sync_route.__exit__(None, None, None)
        _sync_route = None


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Enable tracing for a block: ``with tracing() as tr: ...``."""
    tr = tracer if tracer is not None else Tracer()
    prev = set_tracer(tr)
    try:
        yield tr
    finally:
        set_tracer(prev)


# ----------------------------------------------- filter-decision channel
# The batch executor's filter-stage decisions, recorded whether or not
# tracing is on (bounded and cheap).
_FILTER_CHANNEL = DecisionChannel(cap=8192)


def filter_decision_channel() -> DecisionChannel:
    return _FILTER_CHANNEL


def record_filter_decision(table: str, est_selectivity: Optional[float],
                           branch: str, n_parts: int, rows: int) -> None:
    """One batch filter-stage decision (called by ``executor._run_batch``)."""
    _FILTER_CHANNEL.record(table=table, est_selectivity=est_selectivity,
                           branch=branch, n_parts=n_parts, rows=rows)
    get_metrics().counter(f"executor.filter.{branch}").inc()
