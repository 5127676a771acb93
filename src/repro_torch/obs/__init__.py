"""Observability: host-side counters and gauges (``metrics``) and spans
(``trace``), off by default."""
