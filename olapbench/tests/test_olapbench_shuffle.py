"""The compute-cluster cell (``tpch-sf10-wide-c4.join-shuffle``): its runs,
a broken routing coming out not correct, its configuration and mix
agreeing, and the shuffle pass's roofline bytes and spans by hand."""
import numpy as np
import pytest
import torch

import smallcell
from olapbench import devtrace, harness, shuffle_bytes
from repro_torch.core import cluster

CELL = "tpch-sf10-wide-c4.join-shuffle"
NEW = ("route.ms_per_query.join-shuffle",
       "exchange.MB_per_query.join-shuffle",
       "residual_join.ms_per_query.join-shuffle")


def test_a_traced_run_is_correct_and_reads_the_cluster():
    line = smallcell.run(CELL, trace=True)
    assert line["correct"] is True, line["compared"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(got)
    assert all(got[k] > 0 for k in NEW)
    # no CUDA here: the device's roofline reads nothing
    assert "shuffle_roofline.join-shuffle" not in got


def _drop(out):
    out.slices[1] = out.slices[1].take(torch.arange(0))


def _double(out):
    s = out.slices[2]
    out.slices[2] = type(s)({c: torch.cat([v, v]) for c, v in s.cols.items()})


@pytest.mark.parametrize("fault", (_drop, _double))
def test_a_lost_or_doubled_slice_is_not_correct(monkeypatch, fault):
    real = cluster.assemble

    def broken(*a, **k):
        out = real(*a, **k)
        fault(out)
        return out
    monkeypatch.setattr(cluster, "assemble", broken)
    line = smallcell.run(CELL, seconds=0.5)
    assert line["correct"] is False, line["compared"]


def test_the_configuration_and_the_mix_agree_on_the_cluster():
    _, config, mix, bench = harness.cell_parts(CELL)
    assert config["compute_nodes"] == mix["engine"]["num_compute_nodes"] == 4
    assert mix["engine"]["shuffle"] == "storage"
    # everything else is the wide configuration's, key for key
    _, wide, join, _ = harness.cell_parts("tpch-sf10-wide-p1.join", bench)
    differ = {k for k in set(config) | set(wide)
              if config.get(k) != wide.get(k)}
    assert differ == {"name", "source", "deployment", "compute_nodes",
                      "assumed"}
    assert mix["order"] == join["order"] and mix["accessed"] == \
        join["accessed"]
    assert set(shuffle_bytes.SHUFFLED) == set(mix["order"])


def _tiny():
    """Two 4-row lineitem partitions and two 3-row orders objects."""
    d = shuffle_bytes._D3
    tables = {
        "lineitem": {
            "l_orderkey": np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32),
            "l_shipdate": np.array([d, d + 1, d + 2, d - 1,
                                    d + 5, d, d, d + 9], np.int32),
            "l_extendedprice": np.arange(8, dtype=np.float64),
            "l_discount": np.zeros(8)},
        "orders": {
            "o_orderkey": np.arange(1, 7, dtype=np.int32),
            "o_orderdate": np.array([d - 3, d, d + 1, d - 1, d - 2, d],
                                    np.int32)}}
    config = {"cluster": {}, "lineitem_rows_per_partition": 4,
              "objects_per_table": 2}
    accessed = {"lineitem": ["l_discount", "l_extendedprice", "l_orderkey",
                             "l_shipdate"],
                "orders": ["o_orderdate", "o_orderkey"]}
    return tables, config, accessed


def test_the_roofline_bytes_by_hand():
    tables, config, accessed = _tiny()
    sb = shuffle_bytes.ShuffleBytes(tables, config)
    # Q3 keeps lineitem shipped after D (2 then 2 rows), orders placed
    # before D (1 then 2 rows)
    assert sb.kept("Q3", "lineitem") == [2, 2]
    assert sb.kept("Q3", "orders") == [1, 2]
    done = harness.Done("Q3", 0.01, 0, 4,
                        [("lineitem", 1, 0), ("orders", 0, 0)], [], {})
    # lineitem 0 pushed down: 4 rows x (8 + 8 + 4 + 4); lineitem 1 pushed
    # back: 2 kept keys x 4; orders 0 pushed back: 1 key x 4; orders 1
    # pushed down: 3 rows x (4 + 4)
    assert sb.of(done, accessed) == 4 * 24 + 2 * 4 + 1 * 4 + 3 * 8
    groups = shuffle_bytes.ShuffleBytes(
        {"lineitem": {"l_orderkey": np.array([3, 3, 1, 3, 2, 2, 2, 9],
                                             np.int32)}}, config)
    assert groups.kept("Q18", "lineitem") == [2, 2]


def test_the_shuffle_pass_is_its_spans_with_a_shuffle_kernel():
    work = [(10, 20, "void hash_partition_kernel<int>(...)", 1),
            (30, 40, "predicate_bitmap_kernel", 2),
            (50, 60, "fused_scan_shuffle_kernel", 3),
            (70, 80, "void at::native::elementwise", 4)]
    launches = [(5, 1), (25, 2), (45, 3), (65, 4)]
    trace = devtrace.DeviceTrace(work, launches, (0, 100), 0, 0)
    spans = [(0, 9, "storage_execute", 1, None),     # hashes: in
             (22, 28, "storage_execute", 2, None),   # no shuffle kernel
             (42, 48, "storage_execute", 3, None),   # fused: in
             (62, 68, "route", 4, None),             # always in
             (0, 90, "execute_split", 5, None)]
    got = shuffle_bytes.shuffle_intervals(trace, spans)
    assert got == [(0, 9), (42, 48), (62, 68)]
    assert devtrace.work_launched_in(trace, got) == pytest.approx(30e-9)
