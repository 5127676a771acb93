"""Q12, shipping modes and order priority: 1994's lines received on time
by ship modes 0 and 4, counted by high and low order priority."""
from olapbench.gen import date
from olapbench.refops import F64, col, group_sums, isin, pk_lookup


def reference(T, F=F64):
    D = date(1994, 1, 1)
    sd, cd, rd = (col(T, "lineitem", c) for c in (
        "l_shipdate", "l_commitdate", "l_receiptdate"))
    mode = col(T, "lineitem", "l_shipmode")
    m = (isin(mode, (0, 4)) & (rd >= D) & (rd < D + 365)
         & (sd < cd) & (cd < rd))
    o = pk_lookup(col(T, "orders", "o_orderkey"))(
        col(T, "lineitem", "l_orderkey", rows=m))
    j = o >= 0
    high = isin(col(T, "orders", "o_orderpriority")[o[j]], (0, 1))
    keys, _, g = group_sums(mode[m][j], {"high_cnt": high.to(F),
                                         "low_cnt": (~high).to(F)}, F)
    return {"l_shipmode": keys, **g}
