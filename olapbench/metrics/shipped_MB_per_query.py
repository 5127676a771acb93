"""Bytes that crossed from storage to compute (``QueryRun.real_net_bytes``)
over every completed query, per query, in MB (1e6 bytes)."""


def read(run):
    if not run.done:
        return None
    return sum(d.real_net_bytes for d in run.done) / len(run.done) / 1e6
