"""Q18, large volume customer: orders of more than 150 units, the hundred
of highest total price."""
from olapbench.refops import F64, col, group_sums, pk_lookup, top_k


def reference(T, F=F64):
    keys, _, g = group_sums(col(T, "lineitem", "l_orderkey"),
                            {"sum_qty": col(T, "lineitem", "l_quantity", F)},
                            F)
    big = g["sum_qty"] > 150
    keys, qty = keys[big], g["sum_qty"][big]
    o = pk_lookup(col(T, "orders", "o_orderkey"))(keys)
    j = o >= 0
    keys, qty, o = keys[j], qty[j], o[j]
    best = top_k(col(T, "orders", "o_totalprice", F)[o], 100)
    o = o[best]
    return {"l_orderkey": keys[best], "sum_qty": qty[best],
            "o_orderkey": col(T, "orders", "o_orderkey")[o],
            "o_custkey": col(T, "orders", "o_custkey")[o],
            "o_orderdate": col(T, "orders", "o_orderdate")[o],
            "o_totalprice": col(T, "orders", "o_totalprice", F)[o]}
