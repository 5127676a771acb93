"""Host ms a query spends in the compiler: from the call of
``compile_and_run`` to the start of its ``query`` span (the uncosted
compiler opens no span of its own)."""
from olapbench.readings import compile_s, ms_per_query


def read(run):
    return ms_per_query(run, compile_s(run))
