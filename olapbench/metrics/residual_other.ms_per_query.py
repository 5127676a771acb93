"""Host ms a query spends in the residual's other operators: the
``op.filter``, ``op.map``, ``op.sort`` and ``op.topk`` spans."""
from olapbench.beneath import named_ms_per_query


def read(run):
    return named_ms_per_query(run, ("op.filter", "op.map", "op.sort",
                                    "op.topk"))
