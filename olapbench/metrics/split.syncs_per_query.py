"""Host waits on the card a query, in split execution: ``device_sync``
events whose nearest ancestor of ``execute_split`` and
``residual_compute`` is ``execute_split``."""
from olapbench.beneath import SPLIT, syncs_per_query


def read(run):
    return syncs_per_query(run, SPLIT)
