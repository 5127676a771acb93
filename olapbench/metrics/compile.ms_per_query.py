"""Host ms a query spends in the compiler's own ``compile`` span (the
uncosted path opens one too)."""
from olapbench.beneath import named_ms_per_query


def read(run):
    return named_ms_per_query(run, ("compile",))
