"""Trace exporters: JSONL, Chrome ``trace_event`` (Perfetto), summary table.

Port of ``repro.obs.export``, whole:

- :func:`to_jsonl` / :func:`from_jsonl`: one span per line, a lossless
  round trip (``from_jsonl`` + :func:`build_tree` give the tracer's own
  ``tree()``).
- :class:`JsonlStreamWriter`: the crash-safe variant. Attached as a
  ``Tracer`` sink it writes a flushed ``span_start`` line the moment a
  span opens and a ``span_end`` line when it closes, so a process killed
  mid-run leaves a parseable trace. :func:`from_jsonl` reads both
  formats, merges start/end pairs, keeps spans that never closed open
  (``dur=None``) and ignores a torn final line.
- :func:`to_chrome_trace`: ``{"traceEvents": [...]}`` with complete ("X")
  events, microsecond timestamps and one Chrome "thread" per Python
  thread; chrome://tracing and https://ui.perfetto.dev load it.
- :func:`span_attribution` / :func:`summary_table`: each span name's
  total, self and child time; per-query one-liners (duration, split,
  real and simulated bytes, the ``s_out`` estimate's accuracy).

Span attributes may hold numpy scalars, 0-d tensors, tuples and the
runtime's dataclasses (``execute_split`` attaches its ``RequestOutcome``
list as it is); the one JSON encoder here coerces them at export time
(scalars to Python numbers, tuples to lists, dataclasses to dicts,
anything else to ``str``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.obs.trace import Span, Tracer

__all__ = ["span_to_dict", "to_jsonl", "from_jsonl", "build_tree",
           "to_chrome_trace", "span_attribution", "summary_table",
           "JsonlStreamWriter"]


def _coerce(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    # numpy scalars and 0-d tensors expose .item(); arrays and
    # tensors expose .tolist()
    item = getattr(obj, "item", None)
    if item is not None and getattr(obj, "ndim", 0) == 0:
        return item()
    tolist = getattr(obj, "tolist", None)
    if tolist is not None:
        return tolist()
    if isinstance(obj, (set, frozenset)):
        return sorted(obj)
    return str(obj)


def _dumps(obj) -> str:
    return json.dumps(obj, default=_coerce)


def span_to_dict(span: Span) -> Dict:
    return {"sid": span.sid, "parent": span.parent, "name": span.name,
            "cat": span.cat, "t0": span.t0, "dur": span.dur,
            "tid": span.tid, "attrs": span.attrs}


def _spans_of(source: Union[Tracer, Sequence[Span]]) -> List[Span]:
    if isinstance(source, Tracer):
        return source.snapshot()
    return list(source)


# ------------------------------------------------------------------ JSONL
def to_jsonl(source: Union[Tracer, Sequence[Span]], path,
             meta: Optional[Dict] = None) -> str:
    """Write one ``{"type": "meta"}`` header line then one span per line."""
    spans = _spans_of(source)
    with open(path, "w") as fh:
        header = {"type": "meta", "format": "repro-trace-v1",
                  "n_spans": len(spans)}
        if meta:
            header.update(meta)
        fh.write(_dumps(header) + "\n")
        for sp in spans:
            rec = span_to_dict(sp)
            rec["type"] = "span"
            fh.write(_dumps(rec) + "\n")
    return str(path)


class JsonlStreamWriter:
    """Crash-safe incremental trace export — a ``Tracer`` sink.

    ``tracer.attach_sink(JsonlStreamWriter(path))`` streams one flushed
    ``span_start`` line the instant each span opens and one ``span_end``
    line (final ``dur`` + attrs) when it closes. Because every line
    reaches the OS before the traced work proceeds, a process that dies
    mid-run — ``kill -9`` included — leaves a parseable trace: every
    span that had opened is present, spans that never closed read back
    open (``dur=None``), and :func:`from_jsonl` drops a torn final line
    instead of failing. ``fsync_per_line=True`` additionally survives an
    OS crash, at real I/O cost per span. Thread-safe; writes after
    ``close()`` are silently dropped (worker threads may still be
    finishing spans while the owner shuts the file)."""

    def __init__(self, path, meta: Optional[Dict] = None,
                 fsync_per_line: bool = False):
        self.path = str(path)
        self._fh = open(path, "w")
        self._lock = threading.Lock()
        self._fsync = fsync_per_line
        header = {"type": "meta", "format": "repro-trace-v1",
                  "streaming": True}
        if meta:
            header.update(meta)
        self._write(header)

    def _write(self, rec: Dict) -> None:
        line = _dumps(rec) + "\n"
        with self._lock:
            fh = self._fh
            if fh is None:
                return
            fh.write(line)
            fh.flush()
            if self._fsync:
                os.fsync(fh.fileno())

    # ---------------------------------------------------- Tracer sink API
    def on_start(self, span: Span) -> None:
        self._write({"type": "span_start", "sid": span.sid,
                     "parent": span.parent, "name": span.name,
                     "cat": span.cat, "t0": span.t0, "tid": span.tid,
                     "attrs": dict(span.attrs)})

    def on_end(self, span: Span) -> None:
        self._write({"type": "span_end", "sid": span.sid, "dur": span.dur,
                     "attrs": dict(span.attrs)})

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "JsonlStreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def from_jsonl(path) -> Tuple[Dict, List[Dict]]:
    """Parse a JSONL trace back into ``(meta, span dicts)``.

    Reads both formats: batch ``span`` lines (:func:`to_jsonl`) and
    streamed ``span_start``/``span_end`` pairs (:class:`JsonlStreamWriter`)
    — pairs are merged, a start whose end never made it to disk stays an
    open span (``dur=None``), and an unparseable final line (the process
    died mid-write) ends the parse with the valid prefix kept."""
    meta: Dict = {}
    spans: List[Dict] = []
    by_sid: Dict[int, Dict] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break  # torn tail — keep everything before it
            t = rec.get("type")
            if t == "meta":
                meta = rec
            elif t == "span":
                rec.pop("type")
                spans.append(rec)
            elif t == "span_start":
                rec.pop("type")
                rec["dur"] = None
                spans.append(rec)
                by_sid[rec["sid"]] = rec
            elif t == "span_end":
                sp = by_sid.get(rec["sid"])
                if sp is not None:
                    sp["dur"] = rec.get("dur")
                    sp["attrs"].update(rec.get("attrs") or {})
    return meta, spans


def build_tree(spans: Sequence[Dict]) -> List[Dict]:
    """Nest parsed span dicts into the same forest ``Tracer.tree()`` builds."""
    nodes = {s["sid"]: {"name": s["name"], "cat": s["cat"], "t0": s["t0"],
                        "dur": s["dur"], "attrs": dict(s["attrs"]),
                        "children": []}
             for s in spans}
    roots: List[Dict] = []
    for s in spans:
        pid = s.get("parent")
        if pid is not None and pid in nodes:
            nodes[pid]["children"].append(nodes[s["sid"]])
        else:
            roots.append(nodes[s["sid"]])
    return roots


# ----------------------------------------------------------- Chrome trace
def to_chrome_trace(source: Union[Tracer, Sequence[Span]], path,
                    meta: Optional[Dict] = None) -> str:
    """Write Chrome ``trace_event`` JSON (complete "X" events, ts/dur µs)."""
    spans = _spans_of(source)
    tids = {}
    events: List[Dict] = [{
        "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
        "args": {"name": "repro-engine"},
    }]
    for sp in spans:
        tid = tids.setdefault(sp.tid, len(tids))
        events.append({
            "ph": "X",
            "pid": 0,
            "tid": tid,
            "name": sp.name,
            "cat": sp.cat,
            "ts": sp.t0 * 1e6,
            "dur": (sp.dur or 0.0) * 1e6,
            "args": sp.attrs,
        })
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": meta or {}}
    with open(path, "w") as fh:
        fh.write(_dumps(doc))
    return str(path)


# ---------------------------------------------------------- summary table
def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GB"


def _render(rows: List[Tuple[str, ...]]) -> List[str]:
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return lines


def span_attribution(source: Union[Tracer, Sequence[Span]]
                     ) -> List[Dict]:
    """Per span-name timing attribution over a whole trace: wall time a
    span held (*total*) split into *self* time (the span's own work) and
    *child* time (wall covered by its direct sub-spans). Self-time is
    where an optimization lands — a span whose total is all child time is
    just an umbrella. Sorted by self-time, descending."""
    spans = _spans_of(source)
    child_by_parent: Dict[int, float] = {}
    for sp in spans:
        if sp.parent is not None:
            child_by_parent[sp.parent] = (child_by_parent.get(sp.parent, 0.0)
                                          + (sp.dur or 0.0))
    acc: Dict[Tuple[str, str], Dict] = {}
    for sp in spans:
        dur = sp.dur or 0.0
        child = min(dur, child_by_parent.get(sp.sid, 0.0))
        row = acc.setdefault((sp.name, sp.cat), {
            "name": sp.name, "cat": sp.cat, "count": 0,
            "total_s": 0.0, "self_s": 0.0, "child_s": 0.0})
        row["count"] += 1
        row["total_s"] += dur
        row["child_s"] += child
        row["self_s"] += dur - child
    return sorted(acc.values(), key=lambda r: -r["self_s"])


def summary_table(source: Union[Tracer, Sequence[Span]],
                  attribution: bool = True) -> str:
    """Per-query one-liners from the trace's ``query`` spans, followed by
    the span-level self-vs-child timing attribution (suppressed with
    ``attribution=False``)."""
    spans = _spans_of(source)
    rows = [("query", "ms", "pd", "pb", "net(real)", "net(sim)", "s_out r",
             "cache")]
    for sp in spans:
        if sp.name != "query":
            continue
        a = sp.attrs
        ratio = a.get("s_out_est_ratio")
        hits, n_pd = a.get("cache_hits"), a.get("n_pushdown")
        cache = "-"
        if isinstance(hits, int) and hits > 0:
            cache = (f"{hits}/{n_pd}" if isinstance(n_pd, int) and n_pd
                     else str(hits))
        rows.append((
            str(a.get("qid", "?")),
            f"{(sp.dur or 0.0) * 1e3:.1f}",
            str(a.get("n_pushdown", "-")),
            str(a.get("n_pushback", "-")),
            _fmt_bytes(a.get("real_net_bytes")),
            _fmt_bytes(a.get("sim_net_bytes")),
            f"{ratio:.2f}" if isinstance(ratio, float) else "-",
            cache,
        ))
    lines = _render(rows)
    if attribution:
        att = span_attribution(spans)
        if att:
            arows = [("span", "cat", "n", "total ms", "self ms", "child ms",
                      "self%")]
            for r in att:
                pct = (100.0 * r["self_s"] / r["total_s"]
                       if r["total_s"] > 0 else 0.0)
                arows.append((r["name"], r["cat"], str(r["count"]),
                              f"{r['total_s'] * 1e3:.1f}",
                              f"{r['self_s'] * 1e3:.1f}",
                              f"{r['child_s'] * 1e3:.1f}",
                              f"{pct:.0f}%"))
            lines += ["", *_render(arows)]
    return "\n".join(lines)
