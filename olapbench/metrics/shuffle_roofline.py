"""The shuffle pass's share of its HBM roofline, in percent."""
from olapbench.shuffle_bytes import shuffle_roofline as read  # noqa: F401
