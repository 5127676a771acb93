"""Bytes that crossed between compute nodes, per completed query, in MB
(1e6 bytes): rows routed off their landing node, whole sides broadcast,
slices gathered to node 0 (the ``shuffle.redistributed_bytes``,
``shuffle.broadcast_bytes`` and ``shuffle.gather_bytes`` counters over the
traced window)."""
from olapbench.beneath import window_counter

COUNTERS = ("shuffle.redistributed_bytes", "shuffle.broadcast_bytes",
            "shuffle.gather_bytes")


def read(run):
    got = [window_counter(run, c) for c in COUNTERS]
    if not run.done or all(v is None for v in got):
        return None
    return sum(v or 0 for v in got) / len(run.done) / 1e6
