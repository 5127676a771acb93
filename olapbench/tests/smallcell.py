"""A cell's configuration cut to a size the CPU tests can hold: the same
keys, fewer rows, the same partitioning rules."""
from olapbench import harness

SF, RPP = 4.0, 2400      # 240,000 lineitem rows in 100 partitions


def small(cell: str):
    _, config, mix, bench = harness.cell_parts(cell)
    return dict(config, generator_sf=SF,
                lineitem_rows_per_partition=RPP), mix, bench


def run(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0,
        trace: bool = False):
    import time
    config, _, _ = small(cell)
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device="cpu", config_override=config)
