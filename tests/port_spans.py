"""The spans the port's tracer records and the JAX package's does not, so
that a comparison of span trees with the reference leaves them out:
the residual interpreter's ``op.*`` spans, ``gc`` spans, ``device_sync``
events, the uncosted compiler's ``compile`` span (the reference opens
``compile`` on the costed path only) and a compute cluster's ``route``
and ``gather`` spans."""
import contextlib
import gc


def port_only(name, attrs) -> bool:
    return (name.startswith("op.")
            or name in ("gc", "device_sync", "route", "gather")
            or (name == "compile" and attrs.get("costed") is False))


def strip(forest):
    """A span forest (``Tracer.tree()``) without the port-only spans,
    each one's children spliced into its place."""
    out = []
    for node in forest:
        kids = strip(node["children"])
        if port_only(node["name"], node["attrs"]):
            out.extend(kids)
        else:
            out.append(dict(node, children=kids))
    return out


def spans(tr):
    """``tr.snapshot()`` without the port-only spans."""
    return [s for s in tr.snapshot() if not port_only(s.name, s.attrs)]


def strip_rows(rows, tr):
    """Rows of ``export.span_attribution(tr)`` without the names that only
    port-only spans of ``tr`` carry."""
    kept = {s.name for s in spans(tr)}
    return [r for r in rows if r["name"] in kept]


@contextlib.contextmanager
def no_collections():
    """No automatic garbage collection inside the block, so no ``gc`` span
    where a test counts every span or sink call."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()
