"""Q6, forecasting revenue change: 1994's lines at a discount of 0.05 to
0.07 and a quantity under 24."""
from olapbench.gen import date
from olapbench.refops import F64, col, fsum


def reference(T, F=F64):
    D = date(1994, 1, 1)
    sd = col(T, "lineitem", "l_shipdate")
    d = col(T, "lineitem", "l_discount", F)
    m = ((sd >= D) & (sd < D + 365) & (d >= 0.05) & (d < 0.0701)
         & (col(T, "lineitem", "l_quantity", F) < 24))
    e = col(T, "lineitem", "l_extendedprice", F, m)
    return {"revenue": fsum(e * d[m], F)}
