"""Host ms a query spends planning and costing its requests and in the
Arbitrator's simulation: the `plan_requests` and `arbitrate` spans."""
from olapbench.readings import ms_per_query, span_s


def read(run):
    return ms_per_query(run, span_s(run, ("plan_requests", "arbitrate")))
