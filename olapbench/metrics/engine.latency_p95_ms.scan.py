"""The 95th percentile latency of a scan cell, a per-layer reading there:
the engine front door, paced by the host."""
from olapbench.readings import latency_p95_ms as read  # noqa: F401
