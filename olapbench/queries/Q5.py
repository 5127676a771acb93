"""Q5, local supplier volume: 1994's orders whose customer and supplier
share a nation of region 2, revenue by nation."""
import torch

from olapbench.gen import date
from olapbench.refops import F64, col, group_sums, pk_lookup


def reference(T, F=F64):
    D = date(1994, 1, 1)
    cust = pk_lookup(col(T, "customer", "c_custkey"))(
        col(T, "orders", "o_custkey"))
    od = col(T, "orders", "o_orderdate")
    keep = (od >= D) & (od < D + 365) & (cust >= 0)
    o = pk_lookup(col(T, "orders", "o_orderkey"), keep)(
        col(T, "lineitem", "l_orderkey"))
    s = pk_lookup(col(T, "supplier", "s_suppkey"))(
        col(T, "lineitem", "l_suppkey"))
    j = (o >= 0) & (s >= 0)
    c_nat = col(T, "customer", "c_nationkey")[cust[o[j]]]
    s_nat = col(T, "supplier", "s_nationkey")[s[j]]
    nat = pk_lookup(col(T, "nation", "n_nationkey"),
                    col(T, "nation", "n_regionkey") == 2)(s_nat)
    k = (c_nat == s_nat) & (nat >= 0)
    rev = (col(T, "lineitem", "l_extendedprice", F, j)[k]
           * (1 - col(T, "lineitem", "l_discount", F, j)[k]))
    keys, _, g = group_sums(s_nat[k], {"revenue": rev}, F)
    order = torch.argsort(-g["revenue"], stable=True)
    return {"s_nationkey": keys[order], "revenue": g["revenue"][order]}
