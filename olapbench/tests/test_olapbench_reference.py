"""The plain reference against the program's own CPU path
(``compile_and_run(device="cpu")``) for every query of both mixes, on
both configurations' storage, and its control."""
import pytest

import smallcell
from olapbench import compare, control, harness
from repro_torch.core.engine import compile_and_run

CASES = [("tpch-sf10-wide-p1.join", q) for q in
         ("Q18", "Q8", "Q3", "Q10", "Q5", "Q7")] + \
    [("tpch-sf10-narrow-p01.scan", q) for q in
     ("Q14", "Q6", "Q1", "Q19", "Q12")] + \
    [("tpch-sf10-narrow-p01.join", q) for q in ("Q18", "Q3", "Q7")] + \
    [("tpch-sf10-wide-p1.scan", q) for q in ("Q1", "Q19")]


@pytest.fixture(scope="module")
def cells():
    out = {}
    for cell in {c for c, _ in CASES} | {"tpch-sf10-wide-p1.throughput"}:
        config, mix, _ = smallcell.small(cell)
        tables = harness.make_tables(config, 2 ** 31 + 1)
        out[cell] = (tables, harness.make_catalog(tables, config, "cpu"),
                     harness.engine_config(config, mix, "cpu"),
                     compare.Layout(tables, config), mix)
    return out


@pytest.mark.parametrize("cell,qid", CASES)
def test_reference_equals_the_program(cells, cell, qid):
    tables, cat, cfg, layout, mix = cells[cell]
    run = compile_and_run(qid, cat, cfg)
    got = {k: v.numpy() for k, v in run.result.cols.items()}
    want = harness.references(tables, [qid], "cpu")[qid]
    fault, gap = compare.compare_result(got, want)
    assert fault is None
    assert gap <= compare.LIMITS["result_rel_err"]
    assert len(next(iter(want.values()))) > 0   # every query has rows


@pytest.mark.parametrize("cell", ["tpch-sf10-wide-p1.join",
                                  "tpch-sf10-narrow-p01.scan",
                                  "tpch-sf10-wide-p1.throughput"])
def test_the_float32_control_is_not_correct(cells, cell):
    tables, _, _, _, mix = cells[cell]
    worst, wrong, _ = control.readings(tables, mix)
    assert worst > compare.LIMITS["result_rel_err"] or wrong > 0
