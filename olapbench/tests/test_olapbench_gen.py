"""The generator against the program's, and the narrow widths.

The benchmark's generator draws with ``torch.Generator`` and the
program's with numpy, so their numbers differ; what has to agree is
every table, column, dtype and row count, the range of every column, and
the relations between columns."""
import numpy as np
import pytest
import torch

from olapbench import gen, harness
from repro_torch.queryproc import tpch


def _host(sf, seed):
    return gen.to_host(gen.generate_tables(sf, seed))


@pytest.mark.parametrize("sf,seed", [(4.0, 0), (8.0, 2 ** 31 + 5),
                                     (4.0, 4_000_000_007)])
def test_generator_gives_the_programs_columns(sf, seed):
    a, b = _host(sf, seed), tpch.generate_tables(sf, seed)
    assert a.keys() == b.keys()
    for t in a:
        assert list(a[t]) == list(b[t])
        for c in a[t]:
            x, y = a[t][c], b[t][c]
            assert x.dtype == y.dtype and x.shape == y.shape, (t, c)
            span = max(float(y.max() - y.min()), 1.0)
            # uniform draws of 400 rows or more reach within 2% of either
            # end of their range, and so do the program's; two means of n
            # uniform draws lie within five of their standard errors
            for f in (np.min, np.max):
                assert abs(float(f(x)) - float(f(y))) <= 0.02 * span, (t, c)
            assert abs(float(x.mean()) - float(y.mean())) <= \
                5 * span * (2 / (12 * len(x))) ** 0.5, (t, c)


def test_derived_columns_keep_their_relations():
    T = _host(4.0, 9)
    o, li = T["orders"], T["lineitem"]
    odate = o["o_orderdate"][li["l_orderkey"]]
    ship = li["l_shipdate"] - odate
    assert ship.min() >= 1 and ship.max() <= 121
    commit = li["l_commitdate"] - odate
    assert commit.min() >= 30 and commit.max() <= 90
    receipt = li["l_receiptdate"] - li["l_shipdate"]
    assert receipt.min() >= 1 and receipt.max() <= 30
    assert set(np.unique(li["l_discount"] * 100).round()) <= set(range(11))
    assert np.array_equal(o["o_orderkey"], np.arange(len(o["o_orderkey"])))
    assert o["o_custkey"].max() < (2 * len(T["customer"]["c_custkey"])) // 3


def test_the_seed_fixes_the_tables():
    a, b, c = _host(4.0, 2 ** 31 + 7), _host(4.0, 2 ** 31 + 7), \
        _host(4.0, 2 ** 31 + 8)
    for t in a:
        for k in a[t]:
            assert np.array_equal(a[t][k], b[t][k]), (t, k)
    assert not np.array_equal(a["lineitem"]["l_partkey"],
                              c["lineitem"]["l_partkey"])


def test_narrow_widths_keep_every_value():
    _, config, _, _ = harness.cell_parts("tpch-sf10-narrow-p01.scan")
    wide = gen.generate_tables(1.0, 3)
    narrow = gen.to_host(gen.cast_widths(wide, config["widths"]))
    assert narrow["lineitem"]["l_shipmode"].dtype == np.uint8
    assert narrow["lineitem"]["l_shipdate"].dtype == np.int16
    assert narrow["partsupp"]["ps_availqty"].dtype == np.uint16
    assert narrow["lineitem"]["l_orderkey"].dtype == np.uint32
    assert narrow["lineitem"]["l_extendedprice"].dtype == np.float64
    host = gen.to_host(wide)
    for t in host:
        for c in host[t]:
            assert np.array_equal(narrow[t][c].astype(host[t][c].dtype),
                                  host[t][c])


@pytest.mark.parametrize("dtype,value", [("uint8", 256), ("uint8", -1),
                                         ("int16", 2 ** 15)])
def test_a_width_that_cannot_hold_the_data_is_refused(dtype, value):
    wide = gen.generate_tables(1.0, 3)
    wide["lineitem"]["l_orderkey"][7] = value
    with pytest.raises(ValueError, match="l_orderkey"):
        gen.cast_widths(wide, {"columns": {dtype: ["l_orderkey"]},
                               "other_integers": "int32"})


def test_narrow_tables_reach_the_host_through_signed_views():
    v = torch.tensor([0, 1, 2 ** 32 - 1], dtype=torch.int64)
    t = gen.to_host({"t": {"c": v.to(torch.uint32)}})["t"]["c"]
    assert t.dtype == np.uint32 and t.tolist() == [0, 1, 2 ** 32 - 1]
