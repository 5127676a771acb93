"""A mix of several streams: rounds of one query from each stream through
``run_stream`` (``harness.drive_streams``), checked query by query as the
one-client cells are, and a mix with one ``order`` left on its own path.
CPU, a small configuration: about a minute in one process."""
import numpy as np
import pytest
import torch

import smallcell
from olapbench import compare, harness
from repro_torch.core import engine, runtime

CELL = smallcell.THROUGHPUT["name"]
SEED = 2 ** 31 + 7
ONE_ROUND = 1e-9   # a window that closes during its first round


@pytest.fixture(scope="module")
def small():
    config, mix, _ = smallcell.small(CELL)
    tables = harness.make_tables(config, SEED)
    cat = harness.make_catalog(tables, config, "cpu")
    return (tables, cat, harness.engine_config(config, mix, "cpu"),
            compare.Layout(tables, config), mix)


def _round(small, position):
    _, cat, cfg, _, mix = small
    _, done, attempted, failed = harness.drive_streams(
        mix["streams"], position, cat, cfg, ONE_ROUND, lambda: None)
    assert (attempted, failed) == (3, 0)
    return done


def test_a_throughput_run_reads_correct():
    line = smallcell.run(CELL, seed=SEED)
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] >= 6 and line["failed"] == 0


def test_a_round_takes_one_position_of_every_stream(small):
    mix = small[4]
    done = _round(small, 13)          # 13 mod 11: position 2
    assert [d.qid for d in done] == [s[2] for s in mix["streams"]]
    assert len({d.called_ns for d in done}) == 1
    assert len({d.latency_s for d in done}) == 1


@pytest.mark.parametrize("position,twice", [(3, "Q7"), (10, "Q3")])
def test_a_duplicate_runs_twice_and_both_are_checked(small, position,
                                                     twice):
    tables, _, _, layout, mix = small
    done = _round(small, position)
    assert [d.qid for d in done].count(twice) == 2
    want = harness.references(tables, [twice], "cpu")[twice]
    a, b = [d for d in done if d.qid == twice]
    assert a.n_requests == b.n_requests > 0
    for d in (a, b):
        d.result = {k: v.numpy() for k, v in d.result.items()}
        fault, gap = compare.compare_result(d.result, want)
        assert fault is None and gap <= compare.LIMITS["result_rel_err"]
        assert compare.bytes_fault(d, mix["accessed"][twice], layout) is None


@pytest.mark.parametrize("position", range(11))
def test_the_bytes_of_every_round_reconcile(small, position):
    layout, mix = small[3], small[4]
    for d in _round(small, position):
        assert len(d.pushback) + len(d.pushdown) == d.n_requests
        assert sum(b for *_, b in d.pushback + d.pushdown) == \
            d.real_net_bytes
        assert compare.bytes_fault(d, mix["accessed"][d.qid], layout) is None


def test_a_round_honours_the_compile_keys(small):
    tables, cat, cfg, layout, mix = small
    _, done, _, failed = harness.drive_streams(
        mix["streams"], 0, cat, cfg, ONE_ROUND, lambda: None,
        {"cost_based": True})
    assert failed == 0 and [d.qid for d in done] == \
        [s[0] for s in mix["streams"]]
    want = harness.references(tables, [d.qid for d in done], "cpu")
    for d in done:
        got = {k: v.numpy() for k, v in d.result.items()}
        assert compare.compare_result(got, want[d.qid])[0] is None
        assert compare.bytes_fault(d, mix["accessed"][d.qid], layout) is None


def _alter_answer(monkeypatch, exact: bool):
    orig = runtime.run_stream

    def broken(*a, **k):   # the first column of the kind in the round
        out = orig(*a, **k)
        for key, table in out.results.items():
            cols = dict(table.cols)
            for name, v in cols.items():
                if exact != v.is_floating_point():
                    cols[name] = (torch.from_numpy(v.numpy() + 1) if exact
                                  else v * (1 + 1e-6))
                    out.results[key] = type(table)(cols)
                    return out
        return out
    monkeypatch.setattr(runtime, "run_stream", broken)


def _half_left_out(monkeypatch):
    orig = runtime.run_residual

    def broken(query, merged, *a, **k):
        merged = {t: tab.take(torch.arange(len(tab) // 2))
                  for t, tab in merged.items()}
        return orig(query, merged, *a, **k)
    monkeypatch.setattr(runtime, "run_residual", broken)


def _pushback_miscounted(monkeypatch):
    orig = runtime.pushback_bytes
    monkeypatch.setattr(runtime, "pushback_bytes",
                        lambda cplan, data: orig(cplan, data) // 2)


def _no_answer(monkeypatch):
    orig, calls = runtime.run_stream, []

    def broken(*a, **k):  # answers the warm-up's 11 rounds, then the
        calls.append(1)   # window's first round raises
        if len(calls) == 12:
            raise RuntimeError("a round that never answers")
        return orig(*a, **k)
    monkeypatch.setattr(runtime, "run_stream", broken)


FAULTS = {
    "float_altered": lambda mp: _alter_answer(mp, exact=False),
    "key_altered": lambda mp: _alter_answer(mp, exact=True),
    "half_the_rows_left_out": _half_left_out,
    "pushback_bytes_halved": _pushback_miscounted,
    "no_answer": _no_answer,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_round_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    line = smallcell.run(CELL, seed=SEED, seconds=0.5)
    assert line["correct"] is False, line["compared"]


def test_an_order_mix_keeps_its_records(monkeypatch):
    """The join cell's records: ``drive``'s, built as before streams
    existed, from ``compile_and_run``'s own run; ``run_stream`` untouched."""
    config, mix, _ = smallcell.small("tpch-sf10-wide-p1.join")
    tables = harness.make_tables(config, SEED)
    cat = harness.make_catalog(tables, config, "cpu")
    cfg = harness.engine_config(config, mix, "cpu")

    def refused(*a, **k):
        raise AssertionError("an order mix went through run_stream")
    monkeypatch.setattr(runtime, "run_stream", refused)
    start = SEED % len(mix["order"])
    _, done, attempted, failed = harness.drive(
        mix["order"], start, cat, cfg, ONE_ROUND, lambda: None)
    assert (attempted, failed, len(done)) == (1, 0, 1)
    got = done[0]
    run = engine.compile_and_run(mix["order"][start], cat, cfg)
    by_id = {r.req_id: r for r in run.requests}
    pb = [(o.table, by_id[o.req_id].part.index, int(o.shipped_bytes))
          for o in run.outcomes if o.replayed]
    pd = [(o.table, int(o.rows_out), int(o.shipped_bytes))
          for o in run.outcomes if not o.replayed]
    assert (got.qid, got.real_net_bytes, got.n_requests, got.pushback,
            got.pushdown) == (mix["order"][start], int(run.real_net_bytes),
                              len(run.requests), pb, pd)
    assert sorted(got.result) == sorted(run.result.cols)
    for k, v in run.result.cols.items():
        assert np.array_equal(np.sort(got.result[k].numpy()),
                              np.sort(v.numpy()))
