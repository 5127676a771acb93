"""Q3, shipping priority: building-segment customers' orders before
1995-03-15 with lines shipped after it, the ten of most revenue."""
from olapbench.gen import date
from olapbench.refops import F64, col, group_sums, pk_lookup, top_k


def reference(T, F=F64):
    D = date(1995, 3, 15)
    cust = pk_lookup(col(T, "customer", "c_custkey"),
                     col(T, "customer", "c_mktsegment") == 1)
    keep = ((col(T, "orders", "o_orderdate") < D)
            & (cust(col(T, "orders", "o_custkey")) >= 0))
    okey = col(T, "orders", "o_orderkey")
    m = col(T, "lineitem", "l_shipdate") > D
    lk = col(T, "lineitem", "l_orderkey", rows=m)
    j = pk_lookup(okey, keep)(lk) >= 0
    rev = (col(T, "lineitem", "l_extendedprice", F, m)[j]
           * (1 - col(T, "lineitem", "l_discount", F, m)[j]))
    # o_orderdate and o_shippriority follow from l_orderkey = o_orderkey,
    # the orders' primary key: grouping by the key groups by all three
    keys, _, s = group_sums(lk[j], {"revenue": rev}, F)
    best = top_k(s["revenue"], 10)
    row = pk_lookup(okey)(keys[best])
    return {"l_orderkey": keys[best],
            "o_orderdate": col(T, "orders", "o_orderdate")[row],
            "o_shippriority": col(T, "orders", "o_shippriority")[row],
            "revenue": s["revenue"][best]}
