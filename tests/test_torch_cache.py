"""The port's pushed-result cache against the JAX package's, on the CPU.

Both sides run the compiled queries (``build_query``) on the sf=0.5,
2-node, 2,000-row catalog of ``tests/test_cache.py``: the reference's from
``repro.queryproc.tpch.build_catalog``, the port's from the same arrays
through ``catalog_from_arrays``. The reference runs with
``measured_feedback=False``. For every
query, cold, warm, containment-served and post-append cached runs must
give the port's own uncached result bitwise (dtypes included) and the
reference's result under ``results_equal``; the cache's hits, its
``cache.*`` counters and gauges, ``engine.cache_hits`` and
``ResultCache.stats()`` must equal the reference's. Each test reads
counters from fresh registries on both sides.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.core import result_cache as rrc
from repro.core.cost import RequestCost as RRequestCost
from repro.core.cost import StorageResources as RResources
from repro.core.cost import cut_score as r_cut_score
from repro.core.executor import compile_push_plan as r_compile
from repro.core.plan import PushPlan as RPushPlan
from repro.obs import metrics as rmetrics
from repro.queryproc import expressions as rex
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnTable as RTable
from repro_torch.core import engine, result_cache
from repro_torch.core.cost import RequestCost, StorageResources, cut_score
from repro_torch.core.executor import compile_push_plan
from repro_torch.core.plan import PushPlan
from repro_torch.core.result_cache import ResultCache, plan_keys
from repro_torch.obs import metrics as tmetrics
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc import queries
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays

SF, SEED, NODES, RPP = 0.5, 0, 2, 2000
CACHE_METRICS = ("cache.", "engine.cache_hits")


def _catalogs():
    """(port catalog on the CPU, reference catalog) over the same arrays."""
    arrays = {n: t.cols for n, t in rtpch.generate_tables(SF, SEED).items()}
    return (catalog_from_arrays(arrays, NODES, RPP, device="cpu"),
            rtpch.build_catalog(SF, SEED, NODES, RPP))


@pytest.fixture(scope="module")
def cats():
    """Read-only catalogs: nothing appends to these."""
    return _catalogs()


@pytest.fixture(autouse=True)
def registries():
    """(port registry, reference registry), fresh for every test."""
    prev = tmetrics.set_metrics(tmetrics.Metrics())
    rprev = rmetrics.set_metrics(rmetrics.Metrics())
    yield tmetrics.get_metrics(), rmetrics.get_metrics()
    tmetrics.set_metrics(prev)
    rmetrics.set_metrics(rprev)


def _cfg(cache=None, mode="eager", power=1.0):
    return engine.EngineConfig(res=StorageResources(storage_power=power),
                               mode=mode, device="cpu", result_cache=cache)


def _rcfg(cache=None, mode="eager", power=1.0):
    return reng.EngineConfig(res=RResources(storage_power=power), mode=mode,
                             measured_feedback=False, result_cache=cache)


def _cache_metrics(m):
    snap = m.snapshot()
    return ({k: v for k, v in snap["counters"].items()
             if k.startswith(CACHE_METRICS)},
            {k: v for k, v in snap["gauges"].items()
             if k.startswith(CACHE_METRICS)})


def _count(m, name):
    """A counter's value, without creating it."""
    return m.snapshot()["counters"].get(name, 0.0)


def _same_metrics(registries):
    m, rm = registries
    assert _cache_metrics(m) == _cache_metrics(rm)


def assert_identical(a: ColumnTable, b: ColumnTable, ctx=""):
    """Same columns in the same order, dtypes and values bitwise."""
    assert a.columns == b.columns, (ctx, a.columns, b.columns)
    for c in a.columns:
        x, y = a.cols[c], b.cols[c]
        assert x.dtype == y.dtype, (ctx, c, x.dtype, y.dtype)
        assert np.array_equal(x.numpy(), y.numpy(), equal_nan=True), (ctx, c)


def _matches_reference(got: ColumnTable, want: RTable, ctx=""):
    assert reng.results_equal(RTable(got.to_numpy()), want), ctx
    for c in want.columns:
        assert got.to_numpy()[c].dtype == np.asarray(want.cols[c]).dtype, \
            (ctx, c)


def _run(qid, cat, cfg):
    return engine.run_query(queries.build_query(qid), cat, cfg)


def _rrun(qid, rcat, cfg):
    return reng.run_query(rqueries.build_query(qid), rcat, cfg)


# ------------------------------------------------ cold / warm, all queries
@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_cold_and_warm_match_the_reference(qid, cats, registries):
    cat, rcat = cats
    m, rm = registries
    ref = _run(qid, cat, _cfg()).result
    _matches_reference(ref, _rrun(qid, rcat, _rcfg()).result, qid)
    cache, rcache = ResultCache(), rrc.ResultCache()
    cold = _run(qid, cat, _cfg(cache))
    rcold = _rrun(qid, rcat, _rcfg(rcache))
    assert_identical(ref, cold.result, (qid, "cold"))
    assert cold.cache_hits == rcold.cache_hits == 0
    _same_metrics(registries)
    assert cache.stats() == rcache.stats()
    hits0 = _count(m, "cache.hit")
    warm = _run(qid, cat, _cfg(cache))
    rwarm = _rrun(qid, rcat, _rcfg(rcache))
    assert_identical(ref, warm.result, (qid, "warm"))
    assert warm.cache_hits == rwarm.cache_hits > 0
    assert _count(m, "cache.hit") - hits0 == warm.cache_hits
    assert [o.cache for o in warm.outcomes] == \
        [o.cache for o in rwarm.outcomes]
    assert warm.real_net_bytes == rwarm.real_net_bytes
    _same_metrics(registries)
    assert cache.stats() == rcache.stats()


def _tightened(q, E, plan_keys_of, mins):
    """A variant of ``q`` whose containment-eligible plans carry their
    predicate ANDed with ``col >= column min``: tighter in syntax, the
    same rows in fact (``tests/test_cache.py``'s sweep)."""
    plans = {}
    for table, plan in q.plans.items():
        if plan_keys_of(plan).shape is None:
            plans[table] = plan
            continue
        col = sorted(E.columns_of(plan.predicate))[0]
        plans[table] = dataclasses.replace(
            plan, predicate=E.And(plan.predicate, E.Cmp(
                ">=", E.Col(col), mins[(table, col)])))
    return dataclasses.replace(q, plans=plans)


@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_containment_matches_the_reference(qid, cats, registries):
    """The tightened variant is served from the original's entries through
    ``implies`` and a re-filter, identical to its own uncached run."""
    cat, rcat = cats
    m, rm = registries
    q, rq = queries.build_query(qid), rqueries.build_query(qid)
    mins = {(t, c): rcat.scan_table(t).stats()[c].min
            for t, p in rq.plans.items() if p.predicate is not None
            for c in rex.columns_of(p.predicate)}
    variant = _tightened(q, ex, plan_keys, mins)
    rvariant = _tightened(rq, rex, rrc.plan_keys, mins)
    assert {t: repr(p.predicate) for t, p in variant.plans.items()} == \
        {t: repr(p.predicate) for t, p in rvariant.plans.items()}
    ref = engine.run_query(variant, cat, _cfg()).result
    cache, rcache = ResultCache(), rrc.ResultCache()
    engine.run_query(q, cat, _cfg(cache))
    reng.run_query(rq, rcat, _rcfg(rcache))
    got = engine.run_query(variant, cat, _cfg(cache))
    rgot = reng.run_query(rvariant, rcat, _rcfg(rcache))
    assert_identical(ref, got.result, (qid, "containment"))
    _matches_reference(got.result, rgot.result, qid)
    assert [o.cache for o in got.outcomes] == \
        [o.cache for o in rgot.outcomes]
    _same_metrics(registries)
    assert cache.stats() == rcache.stats()
    eligible = any(plan_keys(p).shape is not None for p in q.plans.values())
    assert (_count(m, "cache.hit.containment") > 0) == eligible


def test_containment_refilters_a_real_delta(cats):
    """A tighter predicate keeps strictly fewer rows than its donor, and
    the re-filtered serve equals the uncached run bit for bit."""
    cat, rcat = cats

    def plans(E, Plan):
        loose = Plan("lineitem", ("l_quantity", "l_extendedprice"),
                     predicate=E.Cmp("<", E.Col("l_quantity"), 40))
        return loose, dataclasses.replace(loose, predicate=E.And(
            loose.predicate, E.Cmp("<", E.Col("l_quantity"), 20)))
    loose, tight = (compile_push_plan(p) for p in plans(ex, PushPlan))
    rloose, rtight = (r_compile(p) for p in plans(rex, RPushPlan))
    cache = ResultCache()
    for part, rpart in zip(cat.partitions_of("lineitem"),
                           rcat.partitions_of("lineitem")):
        res, aux = loose.execute(part.data)
        cache.put(loose, part, res, aux)
        served = cache.serve(tight, part)
        assert served is not None and served[2] == "containment"
        assert_identical(tight.execute(part.data)[0], served[0], part.index)
        assert 0 < len(served[0]) < len(res)
        _matches_reference(served[0], rtight.execute(rpart.data)[0],
                           part.index)
    assert _count(tmetrics.get_metrics(), "cache.hit.containment") \
        == len(cat.partitions_of("lineitem"))


# ----------------------------------------------------------- invalidation
@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_append_invalidation_matches_the_reference(qid, registries):
    """After an append to one partition the cache never serves its old
    rows: the cached run equals an uncached run on the mutated catalog,
    and the refilled entry serves the new bytes afterwards."""
    cat, rcat = _catalogs()     # this test's own: it appends to them
    cache, rcache = ResultCache(), rrc.ResultCache()
    _run(qid, cat, _cfg(cache))
    _rrun(qid, rcat, _rcfg(rcache))
    table = sorted(queries.build_query(qid).plans)[0]
    part = cat.tables[table][0]
    last = ColumnTable({c: v[-1:] for c, v in part.data.cols.items()})
    rlast = RTable({c: np.asarray(v)[-1:]
                    for c, v in rcat.tables[table][0].data.cols.items()})
    cat.append_to_partition(table, 0, last)
    rcat.append_to_partition(table, 0, rlast)
    assert part.version == rcat.tables[table][0].version == 1
    assert part.data.stats()[next(iter(part.data.cols))].nbytes_raw == \
        rcat.tables[table][0].data.stats()[next(iter(part.data.cols))] \
        .nbytes_raw
    ref = _run(qid, cat, _cfg()).result
    for ctx in ("post-append", "refilled"):
        got = _run(qid, cat, _cfg(cache))
        rgot = _rrun(qid, rcat, _rcfg(rcache))
        assert_identical(ref, got.result, (qid, ctx))
        _matches_reference(got.result, rgot.result, (qid, ctx))
        assert got.cache_hits == rgot.cache_hits
        _same_metrics(registries)
        assert cache.stats() == rcache.stats()
    assert _count(tmetrics.get_metrics(), "cache.evict.stale") >= 1


def test_update_partition_bumps_version(cats):
    cat, _ = _catalogs()
    part = cat.tables["nation"][0]
    cat.update_partition("nation", 0, part.data)
    assert cat.tables["nation"][0].version == 1


# ------------------------------------------------------------------ keying
def test_plan_keys_shape_matches_the_reference():
    """Containment eligibility of every compiled plan, and of the plan
    shapes of ``tests/test_cache.py``'s eligibility test."""
    n = 0
    for qid in queries.QUERY_IDS:
        q, rq = queries.build_query(qid), rqueries.build_query(qid)
        for table, plan in q.plans.items():
            keys, rkeys = plan_keys(plan), rrc.plan_keys(rq.plans[table])
            assert (keys.shape is None) == (rkeys.shape is None), \
                (qid, table)
            assert keys.cacheable == rkeys.cacheable
            n += keys.shape is not None
    assert n > 0

    def shapes(E, Plan):
        pred = E.Cmp("<", E.Col("l_quantity"), 30)
        base = Plan("lineitem", ("l_quantity", "l_tax"), predicate=pred)
        rep = dataclasses.replace
        return [base, Plan("lineitem", ("l_quantity",)),
                rep(base, agg=((), (("n", "count", "l_quantity"),))),
                rep(base, top_k=("l_tax", 5, False)),
                rep(base, bitmap_only=True),
                Plan("lineitem", ("l_tax",), predicate=pred),
                rep(base, derive=(("l_quantity", ("l_tax",),
                                   lambda t: t * 2.0),)),
                rep(base, apply_bitmap=True)]
    for p, rp in zip(shapes(ex, PushPlan), shapes(rex, RPushPlan)):
        keys, rkeys = plan_keys(p), rrc.plan_keys(rp)
        assert (keys.shape is None) == (rkeys.shape is None), p
        assert keys.cacheable == rkeys.cacheable, p


def test_plan_key_is_semantic_across_objects():
    """Equal-semantics plan objects share a key; other constants, and
    captured tensors with other bytes, key apart."""
    def plan(fn):
        return PushPlan("lineitem", ("l_quantity",),
                        predicate=ex.Cmp("<", ex.Col("l_quantity"), 30),
                        derive=(("d", ("l_quantity",), fn),))
    key = result_cache.plan_cache_key
    assert key(plan(lambda v: v * 2.0)) == key(plan(lambda v: v * 2.0))
    assert key(plan(lambda v: v * 2.0)) != key(plan(lambda v: v * 3.0))

    def scaled(w):
        return lambda v: v * w
    a = torch.zeros(2000, dtype=torch.float64)
    b = a.clone()
    b[1000] = 1.0   # the tensors' reprs are the same (elided elements)
    assert repr(a) == repr(b)
    assert key(plan(scaled(a))) == key(plan(scaled(a.clone())))
    assert key(plan(scaled(a))) != key(plan(scaled(b)))
    assert key(plan(scaled(a))) != key(plan(scaled(a.to(torch.float32))))


# ------------------------------------------------------------- implication
def _truth_table(E):
    x, y = E.Col("x"), E.Col("y")
    lt30, lt40 = E.Cmp("<", x, 30), E.Cmp("<", x, 40)
    return [
        (lt30, lt40), (lt40, lt30), (E.Cmp("<=", x, 30), lt40),
        (E.Cmp("<=", x, 40), lt40), (E.Cmp(">", x, 40), E.Cmp(">=", x, 40)),
        (E.Cmp("==", x, 7), E.In(x, (5, 7))),
        (E.Cmp("==", x, 8), E.In(x, (5, 7))),
        (E.In(x, (5, 7)), E.In(x, (5, 7, 9))),
        (E.In(x, (5, 11)), E.In(x, (5, 7, 9))),
        (E.In(x, (5, 7)), E.Cmp("<", x, 8)),
        (E.And(lt30, E.Cmp(">", y, 0)), lt40),
        (lt30, E.Or(lt40, E.Cmp(">", y, 0))),
        (E.Or(lt30, E.Cmp("<", x, 20)), lt40),
        (E.Or(lt30, E.Cmp("<", y, 20)), lt40),
        (E.Cmp("<", y, 10), lt40), (lt30, None), (None, lt30), (None, None),
        (E.Cmp(">=", x, 2.5), E.Cmp(">", x, 2)),
        (E.Cmp("<", x, E.Col("y")), E.Cmp("<", x, E.Col("y"))),
        (E.Cmp("<", x, E.Col("y")), lt40),
    ]


def _predicates(build):
    """Every pushed predicate and HAVING of the compiled queries, and each
    of their And/Or operands, in a fixed order."""
    out = []

    def walk(e):
        out.append(e)
        if hasattr(e, "left"):
            walk(e.left)
            walk(e.right)
    for qid in queries.QUERY_IDS:
        for _table, plan in sorted(build(qid).plans.items()):
            for e in (plan.predicate, plan.having):
                if e is not None:
                    walk(e)
    return out


def test_implies_matches_the_reference():
    got = [ex.implies(a, b) for a, b in _truth_table(ex)]
    want = [rex.implies(a, b) for a, b in _truth_table(rex)]
    assert got == want
    assert want[:3] == [True, False, True]
    preds = _predicates(queries.build_query)
    rpreds = _predicates(rqueries.build_query)
    assert [repr(p) for p in preds] == [repr(p) for p in rpreds]
    got = [[ex.implies(a, b) for b in preds] for a in preds]
    want = [[rex.implies(a, b) for b in rpreds] for a in rpreds]
    assert got == want
    assert 0 < sum(map(sum, want)) < len(preds) ** 2


# ------------------------------------------------- decision flip (cost)
def test_warm_flip_matches_the_reference(cats, registries):
    """Q6 at storage power 0.01: cold adaptive pushes every partition
    back; after an eager fill, warm adaptive admits all of them, each
    served from the cache, with the reference's decision vectors."""
    cat, rcat = cats
    m, rm = registries
    n = len(engine.plan_requests(queries.build_query("Q6"), cat))
    ref = _run("Q6", cat, _cfg()).result
    cache, rcache = ResultCache(), rrc.ResultCache()
    for mode in ("adaptive", "eager", "adaptive"):
        hits0 = _count(m, "cache.hit")
        got = _run("Q6", cat, _cfg(cache, mode, 0.01))
        rgot = _rrun("Q6", rcat, _rcfg(rcache, mode, 0.01))
        assert got.sim.decisions() == rgot.sim.decisions()
        assert_identical(ref, got.result, mode)
        assert got.cache_hits == _count(m, "cache.hit") - hits0
        _same_metrics(registries)
    assert got.n_admitted == n and got.n_pushed_back == 0
    assert got.cache_hits == n


def test_cut_score_cache_hit_matches_the_reference():
    for power in (1.0, 0.1):
        res, rres = (StorageResources(storage_power=power),
                     RResources(storage_power=power))
        for c in ((1_000_000, 10_000, 1_000_000), (8_000, 64, 0)):
            cost, rcost = RequestCost(*c), RRequestCost(*c)
            for work in (True, False):
                for hit in (True, False):
                    assert cut_score(cost, res, work, cache_hit=hit) == \
                        r_cut_score(rcost, rres, work, cache_hit=hit)
            assert cut_score(cost, res, True, cache_hit=True) == \
                cost.s_out / res.stream_bw


def test_cost_hint_probe_is_silent(cats, registries):
    cat, _ = cats
    cplan = compile_push_plan(PushPlan(
        "nation", ("n_nationkey",),
        predicate=ex.Cmp("<", ex.Col("n_nationkey"), 20)))
    cache = ResultCache()
    part = cat.partitions_of("nation")[0]
    assert cache.cost_hint(cplan, part) is None
    res, aux = cplan.execute(part.data)
    cache.put(cplan, part, res, aux)
    before = registries[0].snapshot()["counters"]
    hint = cache.cost_hint(cplan, part)
    assert hint is not None and hint >= 64
    assert registries[0].snapshot()["counters"] == before


# --------------------------------------------------------- entries, budget
def test_entries_own_their_bytes(cats):
    """An entry is a copy, not a view into the batch's tensors, and its
    byte count is its tensors' bytes."""
    cat, _ = cats
    cplan = compile_push_plan(PushPlan(
        "lineitem", ("l_quantity", "l_orderkey"),
        predicate=ex.Cmp("<", ex.Col("l_quantity"), 30),
        shuffle=("l_orderkey", 3)))
    parts = cat.partitions_of("lineitem")[:3]
    got, aux = cplan.execute_batch_parts([p.data for p in parts])
    cache = ResultCache()
    for p, r, a in zip(parts, got, aux):
        cache.put(cplan, p, r, a)
    total = 0
    for p, r, a in zip(parts, got, aux):
        e = cache._entries[(p.table, p.index, plan_keys(cplan.plan).exact)]
        tensors = [*e.result.cols.values(), e.aux["position_vector"],
                   *(v for s in e.aux["shuffle_parts"]
                     for v in s.cols.values())]
        for t in tensors:
            assert t.untyped_storage().nbytes() == t.numel() * \
                t.element_size()
        assert e.nbytes == sum(t.numel() * t.element_size()
                               for t in tensors)
        assert_identical(r, e.result)
        total += e.nbytes
    assert cache.stats()["bytes"] == total


def _eviction(Cache, execute, plan, parts):
    """tests/test_cache.py's scenario: a budget for two entries, partition
    0 made hot, then a third put. Returns which partitions still serve."""
    outs = [execute(plan, p) for p in parts]
    one = sum(int(np.asarray(v).nbytes) for v in outs[0][0].cols.values())
    cache = Cache(budget_bytes=int(one * 2.5))
    for p, (res, aux) in zip(parts[:2], outs[:2]):
        cache.put(plan, p, res, aux)
    for _ in range(3):
        assert cache.serve(plan, parts[0]) is not None
    cache.put(plan, parts[2], *outs[2])
    assert cache.bytes <= cache.budget_bytes
    stats = cache.stats()
    return stats, [cache.serve(plan, p) is not None for p in parts]


def test_budget_eviction_is_hit_weighted_as_the_reference(cats, registries):
    cat, rcat = cats

    def plan(E, Plan):
        return Plan("lineitem", ("l_quantity",),
                    predicate=E.Cmp("<", E.Col("l_quantity"), 100))
    got = _eviction(ResultCache, lambda c, p: c.execute(p.data),
                    compile_push_plan(plan(ex, PushPlan)),
                    cat.partitions_of("lineitem")[:3])
    want = _eviction(rrc.ResultCache, lambda c, p: c.execute(p.data),
                     r_compile(plan(rex, RPushPlan)),
                     rcat.partitions_of("lineitem")[:3])
    assert got == want
    assert got[1] == [True, False, True]   # the cold entry went first
    _same_metrics(registries)
    assert _count(registries[0], "cache.evict") >= 1


def test_oversized_entry_is_not_cached(cats):
    cat, _ = cats
    cplan = compile_push_plan(PushPlan("lineitem", ("l_quantity",)))
    part = cat.partitions_of("lineitem")[0]
    cache = ResultCache(budget_bytes=128)
    cache.put(cplan, part, *cplan.execute(part.data))
    assert cache.stats()["entries"] == 0 and cache.bytes == 0


def test_cache_threadsafe_under_direct_hammering(cats):
    """Serve/put races on one hot partition from 16 threads with a short
    switch interval: every serve returns the exact bytes, and the byte
    count stays one entry's."""
    import sys
    cat, _ = cats
    cplan = compile_push_plan(PushPlan(
        "lineitem", ("l_quantity",),
        predicate=ex.Cmp("<", ex.Col("l_quantity"), 50)))
    part = cat.partitions_of("lineitem")[0]
    ref, aux = cplan.execute(part.data)
    cache = ResultCache()
    errors = []

    def worker():
        try:
            for _ in range(50):
                got = cache.serve(cplan, part)
                if got is None:
                    cache.put(cplan, part, ref, aux)
                else:
                    assert_identical(ref, got[0], "hammer")
        except Exception as exc:  # pragma: no cover - the failure path
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert cache.stats()["entries"] == 1
    assert cache.bytes == sum(v.numel() * v.element_size()
                              for v in ref.cols.values())


# --------------------------------------------------- the reference executor
@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_reference_executor_matches_the_batched_one(qid, cats):
    """``EngineConfig(executor="reference")`` runs ``execute_push_plan``
    per partition: the batched executor's results and bytes, and the JAX
    package's reference executor's result."""
    cat, rcat = cats
    got = _run(qid, cat, dataclasses.replace(_cfg(), executor="reference"))
    want = _run(qid, cat, _cfg())
    assert reng.results_equal(RTable(got.result.to_numpy()),
                              RTable(want.result.to_numpy()))
    assert got.real_net_bytes == want.real_net_bytes
    rgot = _rrun(qid, rcat, dataclasses.replace(_rcfg(),
                                                executor="reference"))
    assert reng.results_equal(RTable(got.result.to_numpy()), rgot.result)
    merged = engine.execute_requests(
        engine.plan_requests(queries.build_query(qid), cat), "reference")
    batched = engine.execute_requests(
        engine.plan_requests(queries.build_query(qid), cat))
    assert sorted(merged) == sorted(batched)
    for t in merged:
        assert reng.results_equal(RTable(merged[t].to_numpy()),
                                  RTable(batched[t].to_numpy())), t
