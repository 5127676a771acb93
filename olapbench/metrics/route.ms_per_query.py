"""Host ms a query spends routing tables over the compute nodes and
assembling each node's table: the ``route`` spans."""
from olapbench.beneath import named_ms_per_query


def read(run):
    return named_ms_per_query(run, ("route",))
