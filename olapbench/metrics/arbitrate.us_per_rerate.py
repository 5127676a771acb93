"""Host us of the ``arbitrate`` spans per task the simulation re-rated
(``sim.rerates`` over the traced window): the event loop's cost per unit
of its work."""
from olapbench.beneath import window_counter
from olapbench.readings import span_s


def read(run):
    n = window_counter(run, "sim.rerates")
    return span_s(run, ("arbitrate",)) * 1e6 / n if n else None
