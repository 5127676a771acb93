"""Host ms a query spends executing its split: the `execute_split` span
(pushdowns, pushback copies and replays, and the merge)."""
from olapbench.readings import ms_per_query, span_s


def read(run):
    return ms_per_query(run, span_s(run, ("execute_split",)))
