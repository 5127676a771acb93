"""Pairs the residual's equi-joins wrote a query, in millions: the
``join.out_rows`` counter over the traced window, per completed query.
A program without the counter reads nothing."""
from olapbench.beneath import window_counter


def read(run):
    n = window_counter(run, "join.out_rows")
    return n / 1e6 / len(run.done) if n is not None and run.done else None
