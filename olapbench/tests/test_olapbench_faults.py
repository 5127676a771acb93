"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (CPU, a small configuration) and the
rest of a run is driven as on the card."""
import pytest
import torch

import smallcell
from repro_torch.core import engine, runtime


def _alter_answer(monkeypatch, exact: bool):
    orig = engine.compile_and_run

    def broken(qid, cat, cfg, *a, **k):
        run = orig(qid, cat, cfg, *a, **k)
        cols = dict(run.result.cols)
        for name, v in cols.items():
            if exact != v.is_floating_point():
                cols[name] = (torch.from_numpy(v.numpy() + 1) if exact
                              else v * (1 + 1e-6))
                break
        run.result = type(run.result)(cols)
        return run
    monkeypatch.setattr(engine, "compile_and_run", broken)


def _half_left_out(monkeypatch):
    orig = runtime.execute_split

    def broken(*a, **k):
        split = orig(*a, **k)
        split.merged = {t: tab.take(torch.arange(len(tab) // 2))
                        for t, tab in split.merged.items()}
        return split
    monkeypatch.setattr(runtime, "execute_split", broken)


def _pushback_miscounted(monkeypatch):
    orig = runtime.pushback_bytes
    monkeypatch.setattr(runtime, "pushback_bytes",
                        lambda cplan, data: orig(cplan, data) // 2)


def _pushdown_miscounted(monkeypatch):
    orig = runtime.result_bytes
    monkeypatch.setattr(runtime, "result_bytes",
                        lambda res, aux: orig(res, aux) + 8)


def _raises(monkeypatch, cell):
    _, mix, _ = smallcell.small(cell)
    warm = mix["warmup_passes"] * len(mix["order"])
    orig, calls = engine.compile_and_run, []

    def broken(*a, **k):  # answers the warm-up, then the window's first
        calls.append(1)   # query raises
        if len(calls) == warm + 1:
            raise RuntimeError("a query that never answers")
        return orig(*a, **k)
    monkeypatch.setattr(engine, "compile_and_run", broken)


FAULTS = {
    "float_altered": lambda mp, _: _alter_answer(mp, exact=False),
    "key_altered": lambda mp, _: _alter_answer(mp, exact=True),
    "half_the_rows_left_out": lambda mp, _: _half_left_out(mp),
    "pushback_bytes_halved": lambda mp, _: _pushback_miscounted(mp),
    "pushdown_bytes_padded": lambda mp, _: _pushdown_miscounted(mp),
    "no_answer": _raises,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tpch-sf10-narrow-p01.join",
                                  "tpch-sf10-narrow-p01.scan"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch, cell)
    line = smallcell.run(cell, seconds=0.5)
    assert line["correct"] is False, line["compared"]


def test_the_unbroken_path_is_correct():
    assert smallcell.run("tpch-sf10-narrow-p01.join", seconds=0.5)["correct"]
