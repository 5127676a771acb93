"""The port's fluid simulation against the JAX package's, bit for bit.

``repro_torch.core.simulator`` runs the event loop as array passes over
the active set; ``repro.core.simulator`` is the reference's per-task
loop. Every case runs the same requests through both and asserts with
``==`` (no tolerance) that every decision, start, finish, per-query
figure, ``cpu_busy_by_node``, ``net_bytes`` and ``makespan`` agree, and
that ``on_decision`` heard the same assignments in the same order.

The requests are the compiled TPC-H queries' own, planned once on a small
catalog with the benchmark's layout: 4 storage nodes, lineitem in 100
partitions, the other tables in 4 objects a node. Both sides get fresh
metric registries for every test.
"""
import pytest

from repro.core import faults as rfaults
from repro.core.arbitrator import MeasuredLoad as RMeasuredLoad
from repro.core.cost import RequestCost as RRequestCost
from repro.core.cost import StorageResources as RResources
from repro.core.simulator import SimRequest as RSimRequest
from repro.core.simulator import simulate as r_simulate
from repro.obs import metrics as rmetrics
from repro_torch import compiler
from repro_torch.core import engine
from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN, MeasuredLoad
from repro_torch.core.cost import RequestCost, StorageResources
from repro_torch.core.faults import CircuitBreaker
from repro_torch.core.simulator import MODES, SimRequest, simulate
from repro_torch.obs import metrics
from repro_torch.queryproc import tpch

NODES = 4
JOIN_MIX = ("Q18", "Q8", "Q3", "Q10", "Q5", "Q7")
QIDS = JOIN_MIX + ("Q1", "Q6", "Q19")
POWERS = (1.0, 0.25, 0.1, 0.06)
ORACLE = "oracle"

# (resources, requests as (req_id, node, query, s_in, s_out, compute_in,
# arrival)) of the hand-made edge cases
_PAIR = [(0, 0, "q", 4_000_000, 100_000, 4_000_000, 0.0),
         (1, 0, "q", 4_000_000, 100_000, 4_000_000, 0.0)]
EDGES = {
    "empty": (StorageResources(), []),
    "one": (StorageResources(), [(0, 2, "q", 8_000_000, 500_000,
                                  8_000_000, 0.0)]),
    "s_out_zero": (StorageResources(storage_power=0.1),
                   [(i, i % 2, "q", 8_000_000, 0, 8_000_000, 0.0)
                    for i in range(6)]),
    "compute_in_zero": (StorageResources(storage_power=0.1),
                        [(i, i % 2, "q", 8_000_000, 200_000, 0, 0.0)
                         for i in range(6)]),
    "s_in_zero": (StorageResources(), [(0, 0, "q", 0, 64, 0, 0.0),
                                       (1, 0, "q", 1_000_000, 64, 0, 0.0)]),
    # identical requests on one node: their stages drain at one instant
    "same_instant": (StorageResources(), _PAIR),
    "same_instant_one_slot": (StorageResources(cores=1, net_streams=1),
                              _PAIR + [(2, 0, "q", 4_000_000, 100_000,
                                        4_000_000, 0.0)]),
    "arrival_at_a_drain": (StorageResources(),
                           _PAIR + [(2, 0, "r", 4_000_000, 100_000,
                                     4_000_000, 0.001)]),
}


@pytest.fixture(scope="module")
def planned():
    """qid -> [(req_id, node, s_in, s_out, compute_in)] of the compiled
    query's planned requests, on one small catalog for the module."""
    cat = tpch.build_catalog(sf=0.1, num_nodes=NODES, rows_per_partition=60,
                             device="cpu")
    assert len(cat.partitions_of("lineitem")) == 100
    out = {}
    for qid in QIDS:
        reqs = engine.plan_requests(compiler.compile_query(qid), cat)
        out[qid] = [(r.req_id, r.part.node_id, r.cost.s_in, r.cost.s_out,
                     r.cost.compute_in) for r in reqs]
    return out


@pytest.fixture(autouse=True)
def registries():
    """Fresh metric registries on both sides for every test."""
    prev = metrics.set_metrics(metrics.Metrics())
    rprev = rmetrics.set_metrics(rmetrics.Metrics())
    yield metrics.get_metrics(), rmetrics.get_metrics()
    metrics.set_metrics(prev)
    rmetrics.set_metrics(rprev)


def _rows(planned, qid):
    return [(rid, node, qid, s_in, s_out, c_in, 0.0)
            for rid, node, s_in, s_out, c_in in planned[qid]]


def _staggered(planned, gap):
    """Several queries' requests in one simulation, each query arriving
    ``gap`` seconds after the last, numbered as ``run_stream`` numbers
    them (one id space, in arrival order)."""
    rows = []
    for k, qid in enumerate(("Q3", "Q10", "Q5", "Q3", "Q6")):
        key = qid if k != 3 else f"{qid}#1"
        for _rid, node, s_in, s_out, c_in in planned[qid]:
            rows.append((len(rows), node, key, s_in, s_out, c_in, k * gap))
    return rows


def _oracle(rows):
    """A fixed decision vector: every third request pushed back."""
    return {r[0]: (PUSHBACK if r[0] % 3 == 0 else PUSHDOWN) for r in rows}


def _run_both(rows, power=1.0, mode="adaptive", res=None, decisions=None,
              measured=(None, None), breakers=(None, None)):
    """Simulate ``rows`` on the port and on the reference; returns both
    results and both ``on_decision`` sequences."""
    res = res or StorageResources(storage_power=power)
    rres = RResources(**{f: getattr(res, f) for f in (
        "cores", "core_bw", "disk_bw", "net_bw", "net_streams",
        "storage_power")})
    reqs = [SimRequest(rid, node, q, RequestCost(s_in=s_in, s_out=s_out,
                                                 compute_in=c_in), arrival)
            for rid, node, q, s_in, s_out, c_in, arrival in rows]
    rreqs = [RSimRequest(rid, node, q, RRequestCost(
        s_in=s_in, s_out=s_out, compute_in=c_in), arrival)
        for rid, node, q, s_in, s_out, c_in, arrival in rows]
    heard, rheard = [], []
    got = simulate(reqs, res, mode, decisions=decisions,
                   on_decision=lambda rid, p: heard.append((rid, p)),
                   measured=measured[0], breaker=breakers[0])
    want = r_simulate(rreqs, rres, mode=mode, decisions=decisions,
                      on_decision=lambda rid, p: rheard.append((rid, p)),
                      measured=measured[1], breaker=breakers[1])
    return got, want, heard, rheard


def _assert_same(got, want, heard, rheard, rows):
    assert got.per_request == want.per_request
    assert got.finish_by_query == want.finish_by_query
    assert got.admitted_by_query == want.admitted_by_query
    assert got.pushed_back_by_query == want.pushed_back_by_query
    assert got.net_bytes == want.net_bytes
    assert got.net_bytes_by_query == want.net_bytes_by_query
    assert got.cpu_busy_by_node == want.cpu_busy_by_node
    assert got.makespan == want.makespan
    assert heard == rheard
    assert sorted(got.per_request) == sorted(r[0] for r in rows)


def _cases():
    for qid in QIDS:
        for mode in MODES + (ORACLE,):
            for power in POWERS:
                yield pytest.param("query", qid, mode, power,
                                   id=f"{qid}-{mode}-{power}")
    for mode in MODES + (ORACLE,):
        for power in (1.0, 0.1):
            yield pytest.param("staggered", None, mode, power,
                               id=f"staggered-{mode}-{power}")
    for qid in ("Q8", "Q1"):
        yield pytest.param("measured", qid, "adaptive", 0.1,
                           id=f"measured-{qid}")
        yield pytest.param("breaker", qid, "adaptive", 1.0,
                           id=f"breaker-{qid}")
    for name in EDGES:
        for mode in MODES + (ORACLE,):
            yield pytest.param("edge", name, mode, None,
                               id=f"edge-{name}-{mode}")


@pytest.mark.parametrize("kind,which,mode,power", list(_cases()))
def test_simulation_equals_the_reference_bit_for_bit(planned, registries,
                                                     kind, which, mode,
                                                     power):
    res, kw = None, {}
    if kind == "query":
        rows = _rows(planned, which)
    elif kind == "staggered":
        rows = _rows(planned, "Q3")
        makespan = _run_both(rows, power)[1].makespan
        rows = _staggered(planned, makespan / 3)
    elif kind == "measured":
        rows = _rows(planned, which)
        m, rm = registries
        for n in range(NODES):
            for reg in (m, rm):
                reg.gauge(f"stream.node{n}.exec_queue").set(2.0 * n)
                reg.gauge(f"stream.node{n}.ship_queue").set(3.0 - n)
        kw["measured"] = (MeasuredLoad(m), RMeasuredLoad(rm))
    elif kind == "breaker":
        rows = _rows(planned, which)
        breakers = (CircuitBreaker(trip_after=1, probe_after=5),
                    rfaults.CircuitBreaker(trip_after=1, probe_after=5))
        for b in breakers:
            b.record_failure(1, PUSHDOWN)
            b.record_failure(3, PUSHDOWN)
        kw["breakers"] = breakers
    else:
        res, rows = EDGES[which]
    if mode == ORACLE:
        mode, kw["decisions"] = "adaptive", _oracle(rows)
    got, want, heard, rheard = _run_both(rows, power, mode, res, **kw)
    _assert_same(got, want, heard, rheard, rows)
    if kind in ("measured", "breaker"):
        # the gauges and the tripped routes move decisions: the case
        # exercises them
        assert got.decisions() != _run_both(rows, power, mode)[0].decisions()
    if kind == "breaker":
        b, rb = kw["breakers"]
        assert (b._state, b._denied) == (rb._state, rb._denied)
    if kind == "measured":
        assert (registries[0].epoch()["epoch"]
                == registries[1].epoch()["epoch"])


# The event loop's counts on three request sets, as the per-task loop
# before the array loop counted them: (events, re-rates).
COUNTS = {
    ("Q8", 1.0): (78, 9674),
    ("Q8", 0.1): (104, 8921),
    ("staggered", 0.1): (1141, 118305),
}


@pytest.mark.parametrize("which,power", list(COUNTS))
def test_event_loop_counters(planned, registries, which, power):
    rows = (_staggered(planned, 1e-5) if which == "staggered"
            else _rows(planned, which))
    sim = simulate([SimRequest(rid, node, q, RequestCost(s_in, s_out, c_in),
                               arrival)
                    for rid, node, q, s_in, s_out, c_in, arrival in rows],
                   StorageResources(storage_power=power), "adaptive")
    counters = registries[0].snapshot()["counters"]
    assert (counters["sim.events"], counters["sim.rerates"]) == \
        COUNTS[(which, power)]
    # each stage change handled one task at a time; a task has three
    # stages down pushdown and two down pushback
    n_stages = sum(3 if path == PUSHDOWN else 2
                   for path in sim.decisions().values())
    assert 0 < counters["sim.advances"] <= n_stages
