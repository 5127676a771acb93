"""Queries completed over the window of a scan cell, a per-layer reading
there: the engine front door, paced by the host."""
from olapbench.readings import queries_per_s as read  # noqa: F401
