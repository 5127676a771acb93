"""Host ms a query spends in its residual operators: the
`residual_compute` span."""
from olapbench.readings import ms_per_query, span_s


def read(run):
    return ms_per_query(run, span_s(run, ("residual_compute",)))
