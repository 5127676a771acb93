"""The port's engine end to end against the JAX package's, on the CPU.

Q1, Q3, Q6, Q12 and Q19 run through ``repro_torch.core.engine.run_query``
in all four modes at storage_power 1.0 and 0.1, over a catalog made by the
port's generator and over one fed the reference's arrays through
``catalog_from_arrays``. The reference runs the same hand-built queries
(``build_query_legacy``) with ``measured_feedback=False``, so no gauge left
by another test can move its decisions. The result must equal the
reference's under ``repro.core.engine.results_equal``; the decision vector,
the simulated and the real bytes must be identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.core.cost import StorageResources as RResources
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnTable as RTable
from repro_torch.core import engine, runtime
from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN
from repro_torch.core.cost import StorageResources
from repro_torch.core.engine import EngineConfig, plan_requests, run_query
from repro_torch.queryproc import queries, tpch
from repro_torch.storage.catalog import catalog_from_arrays

SF, SEED, NODES, RPP = 0.5, 0, 2, 2000
POWERS = (1.0, 0.1)


@pytest.fixture(scope="module")
def ref_catalog():
    return rtpch.build_catalog(SF, SEED, NODES, RPP)


@pytest.fixture(scope="module")
def catalogs():
    return {"port_generator": tpch.build_catalog(SF, SEED, NODES, RPP,
                                                 device="cpu"),
            "from_arrays": catalog_from_arrays(
                {n: t.cols for n, t in rtpch.generate_tables(SF, SEED).items()},
                NODES, RPP, device="cpu")}


@pytest.fixture(scope="module")
def ref_runs(ref_catalog):
    runs = {}

    def get(qid, mode, power):
        key = (qid, mode, power)
        if key not in runs:
            runs[key] = reng.run_query(
                rqueries.build_query_legacy(qid), ref_catalog,
                reng.EngineConfig(res=RResources(storage_power=power),
                                  mode=mode, measured_feedback=False))
        return runs[key]
    return get


@pytest.mark.parametrize("source", ("port_generator", "from_arrays"))
@pytest.mark.parametrize("power", POWERS)
@pytest.mark.parametrize("mode", engine.MODES)
@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_query_matches_reference(qid, mode, power, source, catalogs,
                                 ref_runs):
    want = ref_runs(qid, mode, power)
    got = run_query(queries.build_query(qid), catalogs[source],
                    EngineConfig(res=StorageResources(storage_power=power),
                                 mode=mode, device="cpu"))
    assert reng.results_equal(RTable(got.result.to_numpy()), want.result)
    assert got.sim.decisions() == want.sim.decisions()
    assert (got.n_admitted, got.n_pushed_back) == \
        (want.n_admitted, want.n_pushed_back)
    assert got.net_bytes == want.net_bytes
    assert got.real_net_bytes == want.real_net_bytes
    recon, want_recon = got.net_bytes_recon, want.net_bytes_recon
    assert recon == {k: want_recon[k] for k in recon}
    assert got.t_nonpushable == want.t_nonpushable


@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_plans_cost_and_sign_as_the_reference(qid, catalogs, ref_catalog):
    from repro.core.executor import compile_push_plan as r_compile
    from repro.core.plan import estimate_cost as r_estimate_cost
    from repro.core.plan import plan_signature as r_signature
    from repro_torch.core.executor import compile_push_plan
    from repro_torch.core.plan import estimate_cost, plan_signature
    tq, rq = queries.build_query(qid), rqueries.build_query_legacy(qid)
    for table, plan in tq.plans.items():
        rplan = rq.plans[table]
        assert plan_signature(plan) == r_signature(rplan)
        assert plan.accessed_columns() == rplan.accessed_columns()
        cplan, rcplan = compile_push_plan(plan), r_compile(rplan)
        for part, rpart in zip(catalogs["from_arrays"].partitions_of(table),
                               ref_catalog.partitions_of(table)):
            want = dataclasses.astuple(rcplan.estimate_cost(rpart))
            assert dataclasses.astuple(cplan.estimate_cost(part)) == want
            # the uncompiled path walks estimate_selectivity instead
            assert dataclasses.astuple(estimate_cost(plan, part)) == want
            assert dataclasses.astuple(r_estimate_cost(rplan, rpart)) == want


@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_any_decision_vector_merges_to_the_all_pushdown_tables(qid, catalogs):
    """Pushback replays the same plan over shipped projections, so a random
    split merges to the same tables, dtypes and bytes as all-pushdown."""
    reqs = plan_requests(queries.build_query(qid), catalogs["from_arrays"])
    rng = np.random.default_rng(len(qid))
    mixed = {r.req_id: (PUSHBACK if rng.random() < 0.5 else PUSHDOWN)
             for r in reqs}
    base = runtime.execute_split(reqs, {})
    split = runtime.execute_split(reqs, mixed)
    assert split.n_pushback == sum(p == PUSHBACK for p in mixed.values())
    for table, t in base.merged.items():
        got = split.merged[table]
        assert list(got.cols) == list(t.cols)
        for c, v in t.cols.items():
            assert got.cols[c].dtype == v.dtype
            if v.is_floating_point():
                torch.testing.assert_close(got.cols[c], v, rtol=1e-12, atol=0)
            else:
                assert torch.equal(got.cols[c], v), (table, c)


@pytest.mark.parametrize("plan_field, value", (
        ("top_k", ("l_orderkey", 10, False)), ("having", None),
        ("shuffle", ("l_orderkey", 4)), ("bitmap_only", True),
        ("apply_bitmap", True)))
def test_plans_of_later_slices_raise(plan_field, value):
    from repro_torch.core.executor import compile_push_plan
    from repro_torch.queryproc.expressions import Col
    if plan_field == "having":
        value = Col("sum_qty") > 1
    plan = dataclasses.replace(queries.build_query("Q3").plans["lineitem"],
                               **{plan_field: value})
    with pytest.raises(NotImplementedError):
        compile_push_plan(plan)
