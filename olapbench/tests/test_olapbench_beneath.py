"""The readings beneath the ``query`` span: the residual's operators, the
uncosted compiler, the simulator's counters and host waits on the
card."""
import pytest

import smallcell
from olapbench import beneath, harness

JOIN_CELLS = ["tpch-sf10-wide-p1.join", "tpch-sf10-narrow-p01.join"]
NEW = ["compile.ms_per_query.join", "arbitrate.rerates_per_query.join",
       "arbitrate.us_per_rerate.join", "residual_join.ms_per_query.join",
       "residual_agg.ms_per_query.join", "split.syncs_per_query.join",
       "residual.syncs_per_query.join", "residual_other.ms_per_query.join",
       "arbitrate.events_per_query.join"]


def _run(spans, n_done=2):
    done = [harness.Done(f"Q{i}", 0.01, 0, 1, [], [], {})
            for i in range(n_done)]
    return harness.Run({}, {}, {}, {}, 1.0, 1.0, done, n_done, 0,
                       list(spans))


@pytest.mark.parametrize("cell", JOIN_CELLS)
def test_a_traced_cpu_run_reads_every_new_metric(cell):
    line = smallcell.run(cell, trace=True)
    assert line["correct"] is True, line["compared"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(got)
    # no CUDA here: no host waits on the card
    assert got["split.syncs_per_query.join"] == 0
    assert got["residual.syncs_per_query.join"] == 0
    assert got["arbitrate.rerates_per_query.join"] > 0
    assert 0 < got["arbitrate.events_per_query.join"] <= \
        got["arbitrate.rerates_per_query.join"]
    assert got["arbitrate.us_per_rerate.join"] > 0
    assert got["compile.ms_per_query.join"] > 0
    assert 0 < got["residual_join.ms_per_query.join"] + \
        got["residual_agg.ms_per_query.join"] + \
        got["residual_other.ms_per_query.join"] <= \
        got["residual.ms_per_query.join"]


def test_syncs_go_to_their_nearest_split_or_residual_ancestor():
    spans = [(0, 10, "query", 0, None),
             (1, 4, "execute_split", 1, 0),
             (2, 3, "storage_execute", 2, 1),
             (2, 2, "device_sync", 3, 2),       # split, two levels down
             (3, 3, "device_sync", 4, 1),       # split
             (5, 9, "residual_compute", 5, 0),
             (6, 7, "op.join", 6, 5),
             (6, 6, "device_sync", 7, 6),       # residual
             (9, 9, "device_sync", 8, 0)]       # neither: not counted
    assert beneath.syncs_by_layer(_run(spans)) == \
        {"execute_split": 2, "residual_compute": 1}
    assert harness.reader("split.syncs_per_query.join")(_run(spans)) == 1.0
    assert harness.reader("residual.syncs_per_query.join")(_run(spans)) \
        == 0.5


def test_other_operators_are_filters_maps_sorts_and_top_ks():
    ms = 1_000_000
    spans = [(0, 1 * ms, "op.filter", 1, None), (1 * ms, 2 * ms, "op.map", 2,
                                                  None),
             (2 * ms, 5 * ms, "op.join", 3, None),
             (5 * ms, 6 * ms, "op.sort", 4, None),
             (6 * ms, 8 * ms, "op.topk", 5, None)]
    assert harness.reader("residual_other.ms_per_query.join")(_run(spans)) \
        == pytest.approx(2.5)


def test_operator_and_compile_spans_per_query():
    ms = 1_000_000
    spans = [(0, 2 * ms, "op.join", 1, None),
             (2 * ms, 3 * ms, "op.semijoin", 2, None),
             (3 * ms, 7 * ms, "op.aggregate", 3, None),
             (9 * ms, 10 * ms, "compile", 4, None)]
    run = _run(spans)
    assert harness.reader("residual_join.ms_per_query.join")(run) == \
        pytest.approx(1.5)
    assert harness.reader("residual_agg.ms_per_query.join")(run) == \
        pytest.approx(2.0)
    assert harness.reader("compile.ms_per_query.join")(run) == \
        pytest.approx(0.5)


def test_counter_readers_read_the_traced_window(monkeypatch):
    from repro_torch.obs import trace
    monkeypatch.setattr(trace, "_last_counters",
                        {"sim.rerates": 500.0, "sim.events": 30.0})
    ms = 1_000_000
    run = _run([(0, 4 * ms, "arbitrate", 1, None)], n_done=2)
    assert harness.reader("arbitrate.rerates_per_query.join")(run) == 250.0
    assert harness.reader("arbitrate.events_per_query.join")(run) == 15.0
    assert harness.reader("arbitrate.us_per_rerate.join")(run) == \
        pytest.approx(8.0)


def test_an_older_program_or_an_untraced_run_reads_nothing(monkeypatch):
    from repro_torch.obs import trace
    assert all(harness.reader(m)(_run([])) is None for m in NEW)
    monkeypatch.delattr(trace, "last_counters")
    run = _run([(0, 10, "query", 0, None), (1, 2, "residual_compute", 1, 0)])
    assert all(harness.reader(m)(run) is None for m in NEW)
