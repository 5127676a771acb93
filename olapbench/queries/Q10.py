"""Q10, returned item reporting: orders of 1993-10 to 1993-12 with lines
returned (flag 2), the twenty customers of most lost revenue."""
from olapbench.gen import date
from olapbench.refops import F64, col, group_sums, pk_lookup, top_k


def reference(T, F=F64):
    D = date(1993, 10, 1)
    od = col(T, "orders", "o_orderdate")
    m = col(T, "lineitem", "l_returnflag") == 2
    o = pk_lookup(col(T, "orders", "o_orderkey"), (od >= D) & (od < D + 92))(
        col(T, "lineitem", "l_orderkey", rows=m))
    ck = col(T, "orders", "o_custkey")[o.clamp(min=0)]
    c = pk_lookup(col(T, "customer", "c_custkey"))(ck)
    j = (o >= 0) & (c >= 0)
    rev = (col(T, "lineitem", "l_extendedprice", F, m)[j]
           * (1 - col(T, "lineitem", "l_discount", F, m)[j]))
    keys, _, g = group_sums(ck[j], {"revenue": rev}, F)
    best = top_k(g["revenue"], 20)
    return {"o_custkey": keys[best], "revenue": g["revenue"][best]}
