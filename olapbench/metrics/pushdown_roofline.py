"""The storage-side plan pass's share of its HBM roofline, in percent."""
from olapbench.readings import pushdown_roofline as read  # noqa: F401
