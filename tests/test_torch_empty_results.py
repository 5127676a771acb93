"""Empty query results against the JAX package's, dtypes and column order
included, on the CPU.

``results_equal`` accepts any two empty tables, so it cannot see the dtype
of an empty column. At sf=0.01 (seed 0, 3 nodes, 1,500 rows a lineitem
partition) compiled Q3, Q5, Q7 and Q22 return no rows; their results must
carry the reference's dtypes in the reference's column order in every mode
at storage power 1.0 and 0.1. A keyed sum over zero rows is int64 there
(numpy's ``bincount`` of an empty array, weights or not).
"""
import numpy as np
import pytest
import torch

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.core.cost import StorageResources as RResources
from repro.queryproc import operators as rops
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnTable as RTable
from repro_torch.core import engine
from repro_torch.core.cost import StorageResources
from repro_torch.queryproc import operators as ops
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays

SF, SEED, NODES, RPP = 0.01, 0, 3, 1500
EMPTY_QUERIES = ("Q3", "Q5", "Q7", "Q22")
POWERS = (1.0, 0.1)


@pytest.fixture(scope="module")
def ref_catalog():
    return rtpch.build_catalog(SF, SEED, NODES, RPP)


@pytest.fixture(scope="module")
def catalog():
    arrays = {n: t.cols for n, t in rtpch.generate_tables(SF, SEED).items()}
    return catalog_from_arrays(arrays, NODES, RPP, device="cpu")


def _schema(cols) -> list:
    """(name, numpy dtype) of every column, in the table's order."""
    return [(name, np.asarray(v).dtype) for name, v in cols.items()]


@pytest.mark.parametrize("power", POWERS)
@pytest.mark.parametrize("mode", engine.MODES)
@pytest.mark.parametrize("qid", EMPTY_QUERIES)
def test_empty_results_carry_the_reference_dtypes(qid, mode, power, catalog,
                                                  ref_catalog):
    got = engine.compile_and_run(
        qid, catalog, engine.EngineConfig(
            res=StorageResources(storage_power=power), mode=mode,
            device="cpu"))
    want = reng.compile_and_run(
        qid, ref_catalog, reng.EngineConfig(
            res=RResources(storage_power=power), mode=mode,
            measured_feedback=False))
    assert len(want.result) == 0 and len(got.result) == 0
    assert reng.results_equal(RTable(got.result.to_numpy()), want.result)
    assert _schema(got.result.to_numpy()) == _schema(want.result.cols)


@pytest.mark.parametrize("fn", ("sum", "mean", "count", "min", "max"))
@pytest.mark.parametrize("vdtype", (np.int64, np.float64))
def test_keyed_aggregate_of_an_empty_table_matches_the_reference(fn, vdtype):
    cols = {"k": np.zeros(0, np.int64), "v": np.zeros(0, vdtype)}
    aggs = {"s": (fn, "v")}
    got = ops.grouped_agg(ColumnTable({n: torch.from_numpy(a)
                                       for n, a in cols.items()}), ["k"], aggs)
    want = rops.grouped_agg(RTable(dict(cols)), ["k"], aggs)
    assert _schema(got.to_numpy()) == _schema(want.cols)
    assert all(len(v) == 0 for v in got.to_numpy().values())
