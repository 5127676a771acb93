"""The port's data layer against the numpy reference, on the CPU.

The TPC-H generator must give bitwise-identical columns; the catalog built
by the port's generator and the one fed the reference's arrays through
``catalog_from_arrays`` must partition as the reference does, with
``ColumnStats`` equal field by field (the cost model, and through it the
decision vector, reads them). The operators are held against
``repro.queryproc.operators``: bitmaps, keys, counts and row orders
bitwise, float sums to rtol=1e-12 (the same f64 values summed in another
order).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.engine  # noqa: F401  (before repro.queryproc.queries)
from repro.queryproc import operators as rops
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnTable as RTable
from repro_torch.queryproc import operators as tops
from repro_torch.queryproc import tpch as ttpch
from repro_torch.queryproc.table import ColumnStats, ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays

SF, SEED, NODES, RPP = 0.5, 0, 2, 2000
TABLES = ("region", "nation", "supplier", "part", "partsupp", "customer",
          "orders", "lineitem")


@pytest.fixture(scope="module")
def ref_tables():
    return rtpch.generate_tables(SF, SEED)


@pytest.fixture(scope="module")
def ref_catalog():
    return rtpch.build_catalog(SF, SEED, NODES, RPP)


@pytest.mark.parametrize("seed", (SEED, 7))
@pytest.mark.parametrize("table", TABLES)
def test_generated_columns_are_bitwise_identical(table, seed):
    port = ttpch.generate_tables(SF, seed)[table]
    ref = rtpch.generate_tables(SF, seed)[table].cols
    assert list(port) == list(ref)
    for c, v in ref.items():
        assert port[c].dtype == v.dtype, c
        np.testing.assert_array_equal(port[c], v, err_msg=c)


@pytest.mark.parametrize("source", ("port_generator", "from_arrays"))
def test_catalog_partitions_and_stats_match(source, ref_tables, ref_catalog):
    if source == "port_generator":
        cat = ttpch.build_catalog(SF, SEED, NODES, RPP, device="cpu")
    else:
        cat = catalog_from_arrays({n: t.cols for n, t in ref_tables.items()},
                                  NODES, RPP, device="cpu")
    assert list(cat.tables) == list(ref_catalog.tables)
    for table, rparts in ref_catalog.tables.items():
        parts = cat.partitions_of(table)
        assert len(parts) == len(rparts)
        for p, rp in zip(parts, rparts):
            assert (p.index, p.node_id, len(p.data)) == \
                (rp.index, rp.node_id, len(rp.data))
            st, rst = p.data.stats(), rp.data.stats()
            assert list(st) == list(rst)
            for c in rst:
                assert dataclasses.astuple(st[c]) == \
                    dataclasses.astuple(rst[c]), (table, p.index, c)
                np.testing.assert_array_equal(p.data.cols[c].numpy(),
                                              rp.data.cols[c])
    # partitions are views of one tensor per column
    li = cat.partitions_of("lineitem")
    base = li[0].data.cols["l_orderkey"]
    assert all(p.data.cols["l_orderkey"].untyped_storage().data_ptr()
               == base.untyped_storage().data_ptr() for p in li)


def test_column_stats_of_empty_and_constant_columns():
    assert dataclasses.astuple(ColumnStats.of(torch.zeros(0))) == \
        (0.0, 0.0, 0, 0, 0)
    from repro.queryproc.table import ColumnStats as RStats
    for arr in (np.full(10_000, 3, np.int32), np.arange(9000.0),
                np.random.default_rng(0).integers(0, 7, 50_000)):
        assert dataclasses.astuple(ColumnStats.of(torch.from_numpy(arr))) \
            == dataclasses.astuple(RStats.of(arr))


def test_column_table_numpy_round_trip(ref_tables):
    cols = ref_tables["orders"].cols
    t = ColumnTable.from_numpy(cols, "cpu")
    back = t.to_numpy()
    for c, v in cols.items():
        assert back[c].dtype == v.dtype
        np.testing.assert_array_equal(back[c], v)


# ------------------------------------------------------------ operators
def _assert_tables(port: ColumnTable, ref: RTable, rtol: float = 0.0):
    got = port.to_numpy()
    assert list(got) == list(ref.cols)
    for c, v in ref.cols.items():
        assert got[c].dtype == v.dtype, c
        if v.dtype.kind == "f" and rtol:
            np.testing.assert_allclose(got[c], v, rtol=rtol, atol=0, err_msg=c)
        else:
            np.testing.assert_array_equal(got[c], v, err_msg=c)


@pytest.mark.parametrize("R", (0, 1, 31, 32, 33, 1029))
def test_pack_unpack_bitmap_match(R):
    mask = np.random.default_rng(R).random(R) < 0.4
    words = tops.pack_bitmap(torch.from_numpy(mask))
    ref_words = rops.pack_bitmap(mask)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), ref_words)
    np.testing.assert_array_equal(tops.unpack_bitmap(words, R).numpy(),
                                  rops.unpack_bitmap(ref_words, R))


def _agg_table(R, seed=0):
    rng = np.random.default_rng(seed)
    return {"k1": rng.integers(0, 4, R).astype(np.int32),
            "k2": rng.integers(-3, 3, R).astype(np.int32),
            "f": rng.integers(0, 5, R).astype(np.float64) / 4,
            "v": rng.uniform(-10, 100, R),
            "w": rng.integers(0, 1000, R).astype(np.int64)}


AGGS = {"s": ("sum", "v"), "c": ("count", ""), "m": ("mean", "v"),
        "lo": ("min", "w"), "hi": ("max", "v"), "si": ("sum", "w")}


@pytest.mark.parametrize("keys", (("k1",), ("k1", "k2"), ("f", "k2"), ()))
@pytest.mark.parametrize("R", (1, 500))
def test_grouped_agg_matches(keys, R):
    cols = _agg_table(R)
    got = tops.grouped_agg(ColumnTable.from_numpy(cols, "cpu"), list(keys),
                           AGGS)
    want = rops.grouped_agg(RTable(cols), list(keys), AGGS)
    _assert_tables(got, want, rtol=1e-12)


def test_keyless_grouped_agg_of_no_rows_keeps_the_placeholder():
    cols = _agg_table(0)
    aggs = {"s": ("sum", "v"), "c": ("count", "")}
    got = tops.grouped_agg(ColumnTable.from_numpy(cols, "cpu"), [], aggs)
    _assert_tables(got, rops.grouped_agg(RTable(cols), [], aggs))


def test_hash_join_matches(ref_tables):
    rng = np.random.default_rng(3)
    left = {"lk": rng.integers(0, 300, 2000).astype(np.int32),
            "x": rng.uniform(size=2000)}
    right = {"rk": rng.integers(0, 400, 600).astype(np.int32),   # duplicates
             "x": rng.integers(0, 9, 600).astype(np.int32)}
    got = tops.hash_join(ColumnTable.from_numpy(left, "cpu"),
                         ColumnTable.from_numpy(right, "cpu"), "lk", "rk")
    want = rops.hash_join(RTable(left), RTable(right), "lk", "rk")
    _assert_tables(got, want)
    o, c = ref_tables["orders"].cols, ref_tables["customer"].cols
    got = tops.hash_join(ColumnTable.from_numpy(o, "cpu"),
                         ColumnTable.from_numpy(c, "cpu"), "o_custkey",
                         "c_custkey")
    _assert_tables(got, rops.hash_join(RTable(o), RTable(c), "o_custkey",
                                       "c_custkey"))


@pytest.mark.parametrize("ascending", (False, True))
@pytest.mark.parametrize("k", (0, 1, 10, 5000))
def test_top_k_matches(k, ascending):
    cols = {"v": np.random.default_rng(k).permutation(3000).astype(np.float64),
            "i": np.arange(3000, dtype=np.int32)}
    got = tops.top_k(ColumnTable.from_numpy(cols, "cpu"), "v", k, ascending)
    want = rops.top_k(RTable(cols), "v", k, ascending)
    _assert_tables(got, want)


@pytest.mark.parametrize("ascending", (True, False))
def test_sort_table_matches(ascending):
    cols = _agg_table(800, seed=5)
    by = ["k1", "f", "k2"]
    got = tops.sort_table(ColumnTable.from_numpy(cols, "cpu"), by, ascending)
    want = rops.sort_table(RTable(cols), by, ascending)
    _assert_tables(got, want)


def test_filter_table_matches(ref_tables):
    from repro.queryproc import expressions as rex
    from repro_torch.queryproc import expressions as tex
    cols = ref_tables["lineitem"].cols
    got = tops.filter_table(ColumnTable.from_numpy(cols, "cpu"),
                            tex.Col("l_discount").between(0.05, 0.0701)
                            & (tex.Col("l_quantity") < 24))
    want = rops.filter_table(RTable(cols),
                             rex.Col("l_discount").between(0.05, 0.0701)
                             & (rex.Col("l_quantity") < 24))
    _assert_tables(got, want)
