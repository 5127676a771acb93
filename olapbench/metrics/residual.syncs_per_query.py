"""Host waits on the card a query, in the residual: ``device_sync``
events whose nearest ancestor of ``execute_split`` and
``residual_compute`` is ``residual_compute``."""
from olapbench.beneath import RESIDUAL, syncs_per_query


def read(run):
    return syncs_per_query(run, RESIDUAL)
