"""Q8, national market share: nation 3's share of part type 42's volume
sold to region 1 in 1995-1996, by year."""
import torch

from olapbench.gen import date
from olapbench.refops import F64, col, group_sums, pk_lookup


def reference(T, F=F64):
    d0, d1 = date(1995, 1, 1), date(1996, 12, 31)
    p = pk_lookup(col(T, "part", "p_partkey"),
                  col(T, "part", "p_type") == 42)(
        col(T, "lineitem", "l_partkey"))
    od = col(T, "orders", "o_orderdate")
    o = pk_lookup(col(T, "orders", "o_orderkey"), (od >= d0) & (od < d1 + 1))(
        col(T, "lineitem", "l_orderkey"))
    j = (p >= 0) & (o >= 0)
    o = o[j]
    c = pk_lookup(col(T, "customer", "c_custkey"))(
        col(T, "orders", "o_custkey")[o])
    cn = torch.where(c >= 0, col(T, "customer", "c_nationkey")[c.clamp(min=0)],
                     -1)
    n = pk_lookup(col(T, "nation", "n_nationkey"),
                  col(T, "nation", "n_regionkey") == 1)(cn)
    s = pk_lookup(col(T, "supplier", "s_suppkey"))(
        col(T, "lineitem", "l_suppkey", rows=j))
    k = (c >= 0) & (n >= 0) & (s >= 0)
    year = od[o[k]] // 365
    vol = (col(T, "lineitem", "l_extendedprice", F, j)[k]
           * (1 - col(T, "lineitem", "l_discount", F, j)[k]))
    nat = (col(T, "supplier", "s_nationkey")[s[k]] == 3).to(F) * vol
    keys, _, g = group_sums(year, {"nat": nat, "total": vol}, F)
    return {"o_year": keys,
            "mkt_share": g["nat"] / torch.clamp(g["total"], min=1e-9)}
