"""Q14, promotion effect: the promotional share (part types under 15) of
the revenue of lines shipped in 1995-09."""
import torch

from olapbench.gen import date
from olapbench.refops import F64, col, fsum, pk_lookup


def reference(T, F=F64):
    D = date(1995, 9, 1)
    sd = col(T, "lineitem", "l_shipdate")
    m = (sd >= D) & (sd < D + 30)
    p = pk_lookup(col(T, "part", "p_partkey"))(
        col(T, "lineitem", "l_partkey", rows=m))
    j = p >= 0
    rev = (col(T, "lineitem", "l_extendedprice", F, m)[j]
           * (1 - col(T, "lineitem", "l_discount", F, m)[j]))
    promo = (col(T, "part", "p_type")[p[j]] < 15).to(F) * rev
    num, den = fsum(promo, F), fsum(rev, F)
    return {"promo_revenue": 100.0 * num / torch.clamp(den, min=1e-9)}
