"""The 95th percentile of the latency of every query the window completed,
from the call to the synchronised result, in ms."""
from olapbench.readings import latency_p95_ms as read  # noqa: F401
