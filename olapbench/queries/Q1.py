"""Q1, pricing summary: lineitem shipped by 1998-08-02 less 90 days,
grouped by return flag and line status."""
from olapbench.gen import date
from olapbench.refops import F64, col, dense_key, group_sums, split_key


def reference(T, F=F64):
    m = col(T, "lineitem", "l_shipdate") <= date(1998, 8, 2) - 90
    e, d, t, q = (col(T, "lineitem", c, F, m) for c in (
        "l_extendedprice", "l_discount", "l_tax", "l_quantity"))
    key, sizes = dense_key(col(T, "lineitem", "l_returnflag", rows=m),
                           col(T, "lineitem", "l_linestatus", rows=m))
    disc_price = e * (1 - d)
    keys, cnt, s = group_sums(key, {"sum_qty": q, "sum_base": e,
                                    "sum_disc": disc_price,
                                    "sum_charge": disc_price * (1 + t)}, F)
    rf, ls = split_key(keys, sizes)
    return {"l_returnflag": rf, "l_linestatus": ls, **s, "cnt": cnt}
