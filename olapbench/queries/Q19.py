"""Q19, discounted revenue: lines by ship modes 0 and 1 with instruction
2, matched to three brand, container, quantity and size brackets."""
from olapbench.refops import F64, col, fsum, isin, pk_lookup


def reference(T, F=F64):
    q = col(T, "lineitem", "l_quantity", F)
    m = (isin(col(T, "lineitem", "l_shipmode"), (0, 1))
         & (col(T, "lineitem", "l_shipinstruct") == 2)
         & (((q >= 1) & (q < 12)) | ((q >= 10) & (q < 21))
            | ((q >= 20) & (q < 31))))
    p = pk_lookup(col(T, "part", "p_partkey"))(
        col(T, "lineitem", "l_partkey", rows=m))
    j = p >= 0
    b, c, s = (col(T, "part", k)[p[j]] for k in (
        "p_brand", "p_container", "p_size"))
    q = q[m][j]
    k = (((b == 3) & (c < 10) & (q < 12) & (s <= 5))
         | ((b == 5) & (c < 20) & (q < 21) & (s <= 10))
         | ((b == 9) & (c < 40) & (q < 31) & (s <= 15)))
    rev = (col(T, "lineitem", "l_extendedprice", F, m)[j][k]
           * (1 - col(T, "lineitem", "l_discount", F, m)[j][k]))
    return {"revenue": fsum(rev, F)}
