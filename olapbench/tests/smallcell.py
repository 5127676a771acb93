"""A cell's configuration cut to a size the CPU tests can hold: the same
keys, fewer rows, the same partitioning rules."""
from olapbench import harness

SF, RPP = 4.0, 2400      # 240,000 lineitem rows in 100 partitions
# TPC-H's throughput test over the wide catalog, as a cell: the stream
# driver's tests drive it; BENCHMARK.json holds no cell of it yet (PERF.md)
THROUGHPUT = {"name": "tpch-sf10-wide-p1.throughput",
              "config": "tpch-sf10-wide-p1", "traffic": "throughput",
              "chips": 1}


def bench():
    """``BENCHMARK.json``, with the throughput cell where it lacks it."""
    b = harness.load_json(harness.ROOT / "BENCHMARK.json")
    if THROUGHPUT["name"] not in {w["name"] for w in b["workloads"]}:
        b["workloads"] = b["workloads"] + [THROUGHPUT]
    return b


def small(cell: str):
    _, config, mix, b = harness.cell_parts(cell, bench())
    return dict(config, generator_sf=SF,
                lineitem_rows_per_partition=RPP), mix, b


def run(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0,
        trace: bool = False):
    import time
    config, _, b = small(cell)
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device="cpu", config_override=config, bench=b)
