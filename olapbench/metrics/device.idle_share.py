"""Percent of the traced window in which the card ran nothing."""
from olapbench.readings import idle_share as read  # noqa: F401
