"""Per-query spans on the host: off by default, free when off.

Port of the span core of ``repro.obs.trace``: ``Span``, the null span and
context manager, ``Tracer`` (without the detached ``start``/``end`` pair,
the decision channels and the streaming sink), ``NULL_TRACER`` and
``get_tracer``/``set_tracer``/``tracing``. Every hook of the engine routes
through the module-level tracer, and the default ``NULL_TRACER`` makes
each ``span(...)``/``event(...)``/``amend(...)`` a constant-time no-op: a
shared context manager that yields a shared, falsy null span whose
``set()`` swallows everything. Code that computes attributes for a span
tests ``tracer.enabled`` first, so a run with tracing off does no extra
work.

Span parenting: within one thread ``tracer.span(...)`` context managers
nest through a thread-local stack; ``parent=`` overrides it. Span times
are host-clock seconds: a span around device work ends when the host
returns, not when the card is done.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

__all__ = ["Span", "Tracer", "NULL_TRACER", "get_tracer", "set_tracer",
           "tracing"]


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
        return False


class Tracer:
    """Collects a span forest for one or several traced runs.

    - ``span(name, ...)``: context manager; parents to the current
      thread's innermost open ``span(...)`` unless ``parent=`` is given.
    - ``event(name, ...)``: a zero-duration span.
    - ``amend(span, ...)``: attributes computed after a span closed.

    Span creation takes no lock: ids come from an atomic counter and
    ``list.append`` is atomic under the GIL. ``max_spans`` makes a runaway
    loop drop spans (``dropped``) rather than fill the heap.
    """

    enabled = True

    def __init__(self, max_spans: int = 1_000_000):
        self.t0 = time.perf_counter()
        self.max_spans = max_spans
        self.spans: List[Span] = []
        self.dropped = 0
        self._local = threading.local()
        self._sid = itertools.count()

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
        if len(self.spans) >= self.max_spans:
            self.dropped += 1       # soft counter: benign race
            return None
        sp = Span(next(self._sid), pid, name, cat,
                  time.perf_counter() - self.t0, threading.get_ident(), attrs)
        self.spans.append(sp)       # atomic under the GIL
        return sp

    def span(self, name: str, cat: str = "engine",
             parent: Optional[Span] = None, **attrs) -> "_SpanCM":
        """Context manager for a same-thread span."""
        return _SpanCM(self, name, cat, parent, attrs)

    def event(self, name: str, cat: str = "engine",
              parent: Optional[Span] = None, **attrs) -> Span:
        sp = self._new(name, cat, parent, attrs)
        if sp is None:
            return NULL_SPAN
        sp.dur = 0.0
        return sp

    def amend(self, span: Span, **attrs) -> None:
        """Attach attributes to a span that already closed (accounting
        computed after the fact, e.g. ``shipped_bytes``)."""
        if isinstance(span, Span):
            span.attrs.update(attrs)

    def snapshot(self) -> List[Span]:
        return list(self.spans)     # a list copy is atomic under the GIL

    def find(self, name: str) -> List[Span]:
        return [s for s in self.snapshot() if s.name == name]


class _NullTracer(Tracer):
    """The disabled tracer: every hook is a constant-time no-op."""

    enabled = False

    def __init__(self):
        self.t0 = 0.0
        self.max_spans = 0
        self.spans = []
        self.dropped = 0

    def span(self, name, cat="engine", parent=None, **attrs):
        return _NULL_CM

    def amend(self, span, **attrs):
        return None

    def event(self, name, cat="engine", parent=None, **attrs):
        return NULL_SPAN


NULL_TRACER = _NullTracer()

_tracer: Tracer = NULL_TRACER


def get_tracer() -> Tracer:
    """The process-wide tracer every engine hook routes through."""
    return _tracer


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` (None disables tracing); returns the previous one."""
    global _tracer
    prev = _tracer
    _tracer = tracer if tracer is not None else NULL_TRACER
    return prev


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Enable tracing for a block: ``with tracing() as tr: ...``."""
    tr = tracer if tracer is not None else Tracer()
    prev = set_tracer(tr)
    try:
        yield tr
    finally:
        set_tracer(prev)
