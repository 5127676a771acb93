"""Q7, volume shipping: 1995-1996 lines between nations 5 and 7 (either
way round), revenue by supplier nation, customer nation and year."""
from olapbench.gen import date
from olapbench.refops import (F64, col, dense_key, group_sums, pk_lookup,
                              split_key)


def reference(T, F=F64):
    d0, d1 = date(1995, 1, 1), date(1996, 12, 31)
    sd = col(T, "lineitem", "l_shipdate")
    m = (sd >= d0) & (sd < d1 + 1)
    s = pk_lookup(col(T, "supplier", "s_suppkey"))(
        col(T, "lineitem", "l_suppkey", rows=m))
    o = pk_lookup(col(T, "orders", "o_orderkey"))(
        col(T, "lineitem", "l_orderkey", rows=m))
    c = pk_lookup(col(T, "customer", "c_custkey"))(
        col(T, "orders", "o_custkey")[o.clamp(min=0)])
    j = (s >= 0) & (o >= 0) & (c >= 0)
    sn = col(T, "supplier", "s_nationkey")[s[j]]
    cn = col(T, "customer", "c_nationkey")[c[j]]
    k = ((sn == 5) & (cn == 7)) | ((sn == 7) & (cn == 5))
    year = sd[m][j][k] // 365
    vol = (col(T, "lineitem", "l_extendedprice", F, m)[j][k]
           * (1 - col(T, "lineitem", "l_discount", F, m)[j][k]))
    key, sizes = dense_key(sn[k], cn[k], year)
    keys, _, g = group_sums(key, {"revenue": vol}, F)
    a, b, y = split_key(keys, sizes)
    return {"s_nationkey": a, "c_nationkey": b, "l_year": y,
            "revenue": g["revenue"]}
