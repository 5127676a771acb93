"""The mix files' column lists: the program's accessed columns, the bytes
a pushed-back request ships, and the byte count of the plan pass's
roofline."""
import json
from pathlib import Path

import pytest

import smallcell
from olapbench import compare, harness
from repro_torch.compiler import compile_query
from repro_torch.core.executor import compile_push_plan

MIXES = sorted((Path(harness.HERE) / "mixes").glob("*.json"))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_accessed_lists_are_the_compiled_plans(path):
    mix = json.loads(path.read_text())
    assert sorted(mix["accessed"]) == sorted(harness.queries_of(mix))
    for qid, tables in mix["accessed"].items():
        plans = compile_query(qid).plans
        assert {t: sorted(p.accessed_columns()) for t, p in plans.items()} \
            == {t: sorted(c) for t, c in tables.items()}


@pytest.mark.parametrize("cell", ["tpch-sf10-wide-p1.join",
                                  "tpch-sf10-narrow-p01.scan"])
def test_roofline_bytes_are_every_partitions_accessed_columns(cell):
    config, mix, _ = smallcell.small(cell)
    tables = harness.make_tables(config, 17)
    cat = harness.make_catalog(tables, config, "cpu")
    layout = compare.Layout(tables, config)
    for qid, accessed in mix["accessed"].items():
        total = 0
        for table, plan in compile_query(qid).plans.items():
            cplan = compile_push_plan(plan)
            parts = cat.partitions_of(table)
            assert layout.n_partitions(table) == len(parts)
            for part in parts:
                proj = cplan.raw_projection(part.data)
                total += proj.nbytes(stored=False)
                # what a pushed-back request ships: the stored bytes
                assert proj.nbytes(stored=True) == layout.stored(
                    table, part.index, accessed[table])
        assert compare.scanned_bytes(tables, accessed) == total


def test_a_miscounted_request_is_caught():
    config, mix, _ = smallcell.small("tpch-sf10-narrow-p01.scan")
    tables = harness.make_tables(config, 17)
    layout = compare.Layout(tables, config)
    acc = mix["accessed"]["Q1"]
    good = layout.stored("lineitem", 3, acc["lineitem"])
    d = harness.Done("Q1", 0.01, good + 48, 2, [("lineitem", 3, good)],
                     [("lineitem", 1, 48)], {})
    assert compare.bytes_fault(d, acc, layout) is None
    d.pushback = [("lineitem", 3, good - 1)]
    assert "pushed back" in compare.bytes_fault(d, acc, layout)
    d.pushback, d.real_net_bytes = [("lineitem", 3, good)], good
    assert "real_net_bytes" in compare.bytes_fault(d, acc, layout)
