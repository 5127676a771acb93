"""The metric arithmetic: tails over all queries, rates over the whole
window, bytes and shares over every completed query."""
import math

import pytest

from olapbench import harness, readings


def _run(latencies, window_s=10.0, net=(), spans=()):
    done = [harness.Done(f"Q{i}", t, net[i] if net else 0, 4,
                         [("lineitem", i, 0)], [], {})
            for i, t in enumerate(latencies)]
    return harness.Run({}, {}, {}, {}, 1.0, window_s, done, len(done), 0,
                       list(spans))


@pytest.mark.parametrize("n", [1, 19, 20, 100, 401])
def test_p95_is_the_nearest_rank_over_all_queries(n):
    lat = [(i + 1) / 1000 for i in range(n)][::-1]   # 1..n ms, any order
    want = math.ceil(0.95 * n)                        # the rank, in ms
    assert readings.latency_p95_ms(_run(lat)) == pytest.approx(want)


def test_p95_sees_one_slow_query_past_the_rank():
    lat = [0.01] * 94 + [0.5] * 6                    # 6 of 100 slow
    assert readings.latency_p95_ms(_run(lat)) == pytest.approx(500.0)
    lat = [0.01] * 95 + [0.5] * 5                    # 5 of 100: not the p95
    assert readings.latency_p95_ms(_run(lat)) == pytest.approx(10.0)


def test_rate_is_over_the_whole_window():
    run = _run([0.05] * 300, window_s=15.2)
    assert readings.queries_per_s(run) == pytest.approx(300 / 15.2)
    assert readings.queries_per_s(_run([], window_s=1.0)) is None


def test_shipped_mb_and_pushback_share_are_over_every_query():
    run = _run([0.01, 0.02, 0.03], net=[1e6, 2e6, 6e6])
    assert harness.reader("shipped_MB_per_query")(run) == pytest.approx(3.0)
    assert readings.pushback_share(run) == pytest.approx(25.0)


def test_span_readers_divide_by_completed_queries():
    spans = [(0, 2_000_000, "residual_compute", 1, None),
             (5_000_000, 9_000_000, "residual_compute", 2, None),
             (0, 1_000_000, "plan_requests", 3, None),
             (1_000_000, 4_000_000, "arbitrate", 4, None)]
    run = _run([0.01, 0.01], spans=spans)
    assert harness.reader("residual.ms_per_query.join")(run) == \
        pytest.approx(3.0)
    assert harness.reader("arbitrate.ms_per_query.join")(run) == \
        pytest.approx(2.0)


def test_compiler_time_runs_from_the_call_to_the_query_span():
    spans = [(3_000_000, 9_000_000, "query", 1, None),
             (12_000_000, 20_000_000, "query", 2, None)]
    run = _run([0.01, 0.01], spans=spans)
    run.done[0].called_ns, run.done[1].called_ns = 1_000_000, 11_000_000
    assert readings.compile_s(run) == pytest.approx(0.003)


def test_readers_without_a_trace_read_nothing():
    run = _run([0.01])
    for m in ("pushdown_roofline.join", "device.idle_share.scan",
              "split.ms_per_query.join"):
        assert harness.reader(m)(run) is None
