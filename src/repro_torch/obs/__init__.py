"""Observability: host-side counters and gauges (``metrics``), spans and
decision channels (``trace``), off by default, and trace exporters
(``export``). Quickstart::

    from repro_torch import obs
    from repro_torch.obs import export

    with obs.tracing() as tr:
        run = runtime.run_stream(stream, catalog, cfg)
    export.to_chrome_trace(tr, "stream.trace.json")   # chrome://tracing
    export.to_jsonl(tr, "stream.trace.jsonl")
    print(export.summary_table(tr))
"""
from repro_torch.obs.trace import (
    DecisionChannel, NULL_TRACER, Span, Tracer,
    filter_decision_channel, get_tracer, record_filter_decision,
    set_tracer, tracing,
)
from repro_torch.obs.metrics import (
    Counter, Gauge, Histogram, Metrics, get_metrics, set_metrics,
)
from repro_torch.obs import export

__all__ = [
    "Span", "Tracer", "DecisionChannel", "NULL_TRACER",
    "get_tracer", "set_tracer", "tracing",
    "record_filter_decision", "filter_decision_channel",
    "Counter", "Gauge", "Histogram", "Metrics",
    "get_metrics", "set_metrics",
    "export",
]
