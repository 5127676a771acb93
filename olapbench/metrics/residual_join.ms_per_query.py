"""Host ms a query spends in the residual's joins: the ``op.join`` and
``op.semijoin`` spans."""
from olapbench.beneath import named_ms_per_query


def read(run):
    return named_ms_per_query(run, ("op.join", "op.semijoin"))
