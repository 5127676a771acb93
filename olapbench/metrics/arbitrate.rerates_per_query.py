"""Tasks the Arbitrator's fluid simulation re-rated a query: the
``sim.rerates`` counter over the traced window, per completed query."""
from olapbench.beneath import window_counter


def read(run):
    n = window_counter(run, "sim.rerates")
    return n / len(run.done) if n is not None and run.done else None
