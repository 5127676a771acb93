"""Percent of the completed queries' requests the Arbitrator pushed back."""
from olapbench.readings import pushback_share as read  # noqa: F401
