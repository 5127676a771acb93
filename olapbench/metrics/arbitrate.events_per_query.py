"""Iterations of the Arbitrator's fluid simulation that advance time, a
query: the ``sim.events`` counter over the traced window, per completed
query."""
from olapbench.beneath import window_counter


def read(run):
    n = window_counter(run, "sim.events")
    return n / len(run.done) if n is not None and run.done else None
