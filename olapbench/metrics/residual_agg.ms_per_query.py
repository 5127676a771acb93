"""Host ms a query spends in the residual's group-bys: the
``op.aggregate`` spans."""
from olapbench.beneath import named_ms_per_query


def read(run):
    return named_ms_per_query(run, ("op.aggregate",))
