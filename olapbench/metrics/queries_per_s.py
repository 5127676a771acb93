"""Queries completed over the whole window."""
from olapbench.readings import queries_per_s as read  # noqa: F401
