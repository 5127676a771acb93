"""TPC-H queries: the compiled entry point and the hand-built reference.

Port of ``repro.queryproc.queries``: 15 of the 22 TPC-H queries (every
query named in the paper's figures). ``build_query`` compiles a query from
its logical-plan IR (``repro_torch.compiler``), which derives the storage
frontier with the §4.1 amenability splitter. The hand-built builders below
(``q1`` .. ``q22``, through ``build_query_legacy``) are the seed's
reference: a per-table ``PushPlan`` plus a ``compute`` residual written
over device tensors, with the split decided by hand. Either way the same
plan runs at storage (pushdown) or at the compute layer over shipped raw
partitions (pushback), so every mode returns the same result.

``build_query(qid, fact_selectivity)`` compiles a query with the
fact-table predicate replaced by ``l_quantity <= ceil(50*sel)`` (uniform
1..50, so a selectivity of about ``sel``), the knob of the bitmap
evaluation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.plan import PushPlan
from repro_torch.queryproc import operators as ops
from repro_torch.queryproc.expressions import Col
from repro_torch.queryproc.table import ColumnTable, gather
from repro_torch.queryproc.tpch import date

C = Col  # terse alias

REV = ("revenue", ("l_extendedprice", "l_discount"), lambda e, d: e * (1 - d))
DISC_PRICE = ("disc_price", ("l_extendedprice", "l_discount"),
              lambda e, d: e * (1 - d))
CHARGE = ("charge", ("l_extendedprice", "l_discount", "l_tax"),
          lambda e, d, t: e * (1 - d) * (1 + t))


@dataclasses.dataclass
class Query:
    qid: str
    plans: Dict[str, PushPlan]
    compute: Callable[[Dict[str, ColumnTable]], ColumnTable]
    # table -> redistribution key of the downstream join (the §4.2 shuffle)
    shuffle_keys: Dict[str, str] = dataclasses.field(default_factory=dict)
    # the residual IR of a compiled query (None for the hand-built ones);
    # ``compute`` interprets it
    residual: Optional[object] = None


def _scalar_table(name: str, value: torch.Tensor) -> ColumnTable:
    return ColumnTable({name: value.reshape(1)})


def _isin(v: torch.Tensor, values) -> torch.Tensor:
    return ops.isin(v, torch.as_tensor(values, device=v.device))


def q1() -> Query:
    cutoff = date(1998, 8, 2) - 90
    li = PushPlan(
        "lineitem", ("l_returnflag", "l_linestatus"),
        predicate=C("l_shipdate") <= cutoff,
        derive=(DISC_PRICE, CHARGE),
        agg=(("l_returnflag", "l_linestatus"),
             (("sum_qty", "sum", "l_quantity"),
              ("sum_base", "sum", "l_extendedprice"),
              ("sum_disc", "sum", "disc_price"),
              ("sum_charge", "sum", "charge"),
              ("cnt", "count", ""))))

    def compute(t):
        out = ops.grouped_agg(t["lineitem"], ["l_returnflag", "l_linestatus"],
                              {"sum_qty": ("sum", "sum_qty"),
                               "sum_base": ("sum", "sum_base"),
                               "sum_disc": ("sum", "sum_disc"),
                               "sum_charge": ("sum", "sum_charge"),
                               "cnt": ("sum", "cnt")})
        return ops.sort_table(out, ["l_returnflag", "l_linestatus"])

    return Query("Q1", {"lineitem": li}, compute)


def q3() -> Query:
    D = date(1995, 3, 15)
    cu = PushPlan("customer", ("c_custkey",), predicate=C("c_mktsegment").eq(1))
    od = PushPlan("orders", ("o_orderkey", "o_custkey", "o_orderdate",
                             "o_shippriority"), predicate=C("o_orderdate") < D)
    li = PushPlan("lineitem", ("l_orderkey", "revenue"),
                  predicate=C("l_shipdate") > D, derive=(REV,))

    def compute(t):
        j = ops.hash_join(t["orders"], t["customer"], "o_custkey", "c_custkey")
        j = ops.hash_join(t["lineitem"], j, "l_orderkey", "o_orderkey")
        g = ops.grouped_agg(j, ["l_orderkey", "o_orderdate", "o_shippriority"],
                            {"revenue": ("sum", "revenue")})
        return ops.top_k(g, "revenue", 10)

    return Query("Q3", {"customer": cu, "orders": od, "lineitem": li}, compute,
                 shuffle_keys={"lineitem": "l_orderkey", "orders": "o_orderkey"})


def q4() -> Query:
    D = date(1993, 7, 1)
    od = PushPlan("orders", ("o_orderkey", "o_orderpriority"),
                  predicate=C("o_orderdate").between(D, D + 92))
    # l_commitdate < l_receiptdate is a column-column compare: evaluated at
    # storage as a derived flag
    li = PushPlan("lineitem", ("l_orderkey", "_late"),
                  derive=(("_late", ("l_commitdate", "l_receiptdate"),
                           lambda c, r: (c < r).to(torch.int32)),))

    def compute(t):
        lt = t["lineitem"]
        lk = gather(lt.cols["l_orderkey"], lt.cols["_late"] == 1)
        o = t["orders"]
        mask = ops.isin(o.cols["o_orderkey"], lk)
        return ops.grouped_agg(o.filter(mask), ["o_orderpriority"],
                               {"cnt": ("count", "")})

    return Query("Q4", {"orders": od, "lineitem": li}, compute,
                 shuffle_keys={"lineitem": "l_orderkey", "orders": "o_orderkey"})


def q5() -> Query:
    D = date(1994, 1, 1)
    cu = PushPlan("customer", ("c_custkey", "c_nationkey"))
    od = PushPlan("orders", ("o_orderkey", "o_custkey"),
                  predicate=C("o_orderdate").between(D, D + 365))
    li = PushPlan("lineitem", ("l_orderkey", "l_suppkey", "revenue"),
                  derive=(REV,))
    su = PushPlan("supplier", ("s_suppkey", "s_nationkey"))
    na = PushPlan("nation", ("n_nationkey", "n_regionkey"))

    def compute(t):
        na_r = t["nation"].filter(t["nation"].cols["n_regionkey"] == 2)
        j = ops.hash_join(t["orders"], t["customer"], "o_custkey", "c_custkey")
        j = ops.hash_join(t["lineitem"], j, "l_orderkey", "o_orderkey")
        j = ops.hash_join(j, t["supplier"], "l_suppkey", "s_suppkey")
        j = j.filter(j.cols["c_nationkey"] == j.cols["s_nationkey"])
        j = ops.hash_join(j, na_r, "s_nationkey", "n_nationkey")
        g = ops.grouped_agg(j, ["s_nationkey"], {"revenue": ("sum", "revenue")})
        return ops.sort_table(g, ["revenue"], ascending=False)

    return Query("Q5", {"customer": cu, "orders": od, "lineitem": li,
                        "supplier": su, "nation": na}, compute,
                 shuffle_keys={"lineitem": "l_orderkey", "orders": "o_orderkey"})


def q6() -> Query:
    D = date(1994, 1, 1)
    li = PushPlan(
        "lineitem", ("disc_rev",),
        predicate=(C("l_shipdate").between(D, D + 365)
                   & C("l_discount").between(0.05, 0.0701)
                   & (C("l_quantity") < 24)),
        derive=(("disc_rev", ("l_extendedprice", "l_discount"),
                 lambda e, d: e * d),),
        agg=((), (("revenue", "sum", "disc_rev"),)))

    def compute(t):
        return _scalar_table("revenue", t["lineitem"].cols["revenue"].sum())

    return Query("Q6", {"lineitem": li}, compute)


def q7() -> Query:
    d0, d1 = date(1995, 1, 1), date(1996, 12, 31)
    li = PushPlan("lineitem", ("l_orderkey", "l_suppkey", "l_shipdate",
                               "volume"),
                  predicate=C("l_shipdate").between(d0, d1 + 1), derive=(
                      ("volume", ("l_extendedprice", "l_discount"),
                       lambda e, d: e * (1 - d)),))
    od = PushPlan("orders", ("o_orderkey", "o_custkey"))
    cu = PushPlan("customer", ("c_custkey", "c_nationkey"))
    su = PushPlan("supplier", ("s_suppkey", "s_nationkey"))

    def compute(t):
        j = ops.hash_join(t["lineitem"], t["supplier"], "l_suppkey",
                          "s_suppkey")
        j = ops.hash_join(j, t["orders"], "l_orderkey", "o_orderkey")
        j = ops.hash_join(j, t["customer"], "o_custkey", "c_custkey")
        s, c = j.cols["s_nationkey"], j.cols["c_nationkey"]
        j = j.filter(((s == 5) & (c == 7)) | ((s == 7) & (c == 5)))
        yr = (j.cols["l_shipdate"] // 365).to(torch.int32)
        j = ColumnTable({**j.cols, "l_year": yr})
        g = ops.grouped_agg(j, ["s_nationkey", "c_nationkey", "l_year"],
                            {"revenue": ("sum", "volume")})
        return ops.sort_table(g, ["s_nationkey", "c_nationkey", "l_year"])

    return Query("Q7", {"lineitem": li, "orders": od, "customer": cu,
                        "supplier": su}, compute,
                 shuffle_keys={"lineitem": "l_orderkey", "orders": "o_orderkey"})


def q8() -> Query:
    d0, d1 = date(1995, 1, 1), date(1996, 12, 31)
    od = PushPlan("orders", ("o_orderkey", "o_custkey", "o_orderdate"),
                  predicate=C("o_orderdate").between(d0, d1 + 1))
    li = PushPlan("lineitem", ("l_orderkey", "l_partkey", "l_suppkey",
                               "volume"),
                  derive=(("volume", ("l_extendedprice", "l_discount"),
                           lambda e, d: e * (1 - d)),))
    pa = PushPlan("part", ("p_partkey",), predicate=C("p_type").eq(42))
    cu = PushPlan("customer", ("c_custkey", "c_nationkey"))
    su = PushPlan("supplier", ("s_suppkey", "s_nationkey"))
    na = PushPlan("nation", ("n_nationkey", "n_regionkey"))

    def compute(t):
        j = ops.hash_join(t["lineitem"], t["part"], "l_partkey", "p_partkey")
        j = ops.hash_join(j, t["orders"], "l_orderkey", "o_orderkey")
        j = ops.hash_join(j, t["customer"], "o_custkey", "c_custkey")
        j = ops.hash_join(j, t["nation"], "c_nationkey", "n_nationkey")
        j = j.filter(j.cols["n_regionkey"] == 1)
        j = ops.hash_join(j, t["supplier"], "l_suppkey", "s_suppkey")
        yr = (j.cols["o_orderdate"] // 365).to(torch.int32)
        nat = (j.cols["s_nationkey"] == 3).to(torch.float64) * j.cols["volume"]
        j = ColumnTable({**j.cols, "o_year": yr, "nat_volume": nat})
        g = ops.grouped_agg(j, ["o_year"], {"nat": ("sum", "nat_volume"),
                                            "total": ("sum", "volume")})
        share = g.cols["nat"] / torch.clamp(
            g.cols["total"].to(torch.float64), min=1e-9)
        return ColumnTable({"o_year": g.cols["o_year"], "mkt_share": share})

    return Query("Q8", {"orders": od, "lineitem": li, "part": pa,
                        "customer": cu, "supplier": su, "nation": na}, compute,
                 shuffle_keys={"lineitem": "l_orderkey", "orders": "o_orderkey"})


def q10() -> Query:
    D = date(1993, 10, 1)
    cu = PushPlan("customer", ("c_custkey", "c_nationkey", "c_acctbal"))
    od = PushPlan("orders", ("o_orderkey", "o_custkey"),
                  predicate=C("o_orderdate").between(D, D + 92))
    li = PushPlan("lineitem", ("l_orderkey", "revenue"),
                  predicate=C("l_returnflag").eq(2), derive=(REV,))

    def compute(t):
        j = ops.hash_join(t["lineitem"], t["orders"], "l_orderkey",
                          "o_orderkey")
        j = ops.hash_join(j, t["customer"], "o_custkey", "c_custkey")
        g = ops.grouped_agg(j, ["o_custkey"], {"revenue": ("sum", "revenue")})
        return ops.top_k(g, "revenue", 20)

    return Query("Q10", {"customer": cu, "orders": od, "lineitem": li},
                 compute,
                 shuffle_keys={"lineitem": "l_orderkey", "orders": "o_orderkey"})


def q12() -> Query:
    D = date(1994, 1, 1)
    li = PushPlan("lineitem", ("l_orderkey", "l_shipmode", "_ontime"),
                  predicate=(C("l_shipmode").isin((0, 4))
                             & C("l_receiptdate").between(D, D + 365)),
                  derive=(("_ontime",
                           ("l_shipdate", "l_commitdate", "l_receiptdate"),
                           lambda s, c, r: ((s < c) & (c < r)).to(torch.int32)),))
    od = PushPlan("orders", ("o_orderkey", "o_orderpriority"))

    def compute(t):
        li_t = t["lineitem"]
        li_t = li_t.filter(li_t.cols["_ontime"] == 1)
        j = ops.hash_join(li_t, t["orders"], "l_orderkey", "o_orderkey")
        hi = _isin(j.cols["o_orderpriority"], (0, 1)).to(torch.int64)
        j = ColumnTable({**j.cols, "high": hi, "low": 1 - hi})
        g = ops.grouped_agg(j, ["l_shipmode"], {"high_cnt": ("sum", "high"),
                                                "low_cnt": ("sum", "low")})
        return ops.sort_table(g, ["l_shipmode"])

    return Query("Q12", {"lineitem": li, "orders": od}, compute,
                 shuffle_keys={"lineitem": "l_orderkey", "orders": "o_orderkey"})


def q14() -> Query:
    D = date(1995, 9, 1)
    li = PushPlan("lineitem", ("l_partkey", "revenue"),
                  predicate=C("l_shipdate").between(D, D + 30), derive=(REV,))
    pa = PushPlan("part", ("p_partkey", "p_type"))

    def compute(t):
        j = ops.hash_join(t["lineitem"], t["part"], "l_partkey", "p_partkey")
        promo = (j.cols["p_type"] < 15).to(torch.float64) * j.cols["revenue"]
        num, den = promo.sum(), j.cols["revenue"].sum()
        return _scalar_table("promo_revenue",
                             100.0 * num / torch.clamp(den, min=1e-9))

    return Query("Q14", {"lineitem": li, "part": pa}, compute,
                 shuffle_keys={"lineitem": "l_partkey", "part": "p_partkey"})


def q15() -> Query:
    D = date(1996, 1, 1)
    li = PushPlan("lineitem", ("l_suppkey",),
                  predicate=C("l_shipdate").between(D, D + 92), derive=(REV,),
                  agg=(("l_suppkey",), (("total_rev", "sum", "revenue"),)))
    su = PushPlan("supplier", ("s_suppkey", "s_nationkey"))

    def compute(t):
        g = ops.grouped_agg(t["lineitem"], ["l_suppkey"],
                            {"total_rev": ("sum", "total_rev")})
        mx = g.cols["total_rev"].max() if len(g) else 0.0
        top = g.filter(g.cols["total_rev"] >= mx - 1e-9)
        return ops.hash_join(top, t["supplier"], "l_suppkey", "s_suppkey")

    return Query("Q15", {"lineitem": li, "supplier": su}, compute,
                 shuffle_keys={"lineitem": "l_suppkey"})


def q17() -> Query:
    li = PushPlan("lineitem", ("l_partkey", "l_quantity", "l_extendedprice"))
    pa = PushPlan("part", ("p_partkey",),
                  predicate=C("p_brand").eq(3) & C("p_container").eq(7))

    def compute(t):
        j = ops.hash_join(t["lineitem"], t["part"], "l_partkey", "p_partkey")
        g = ops.grouped_agg(j, ["l_partkey"],
                            {"avg_qty": ("mean", "l_quantity")})
        j = ops.hash_join(j, g, "l_partkey", "l_partkey")
        m = j.cols["l_quantity"] < 0.2 * j.cols["avg_qty"]
        return _scalar_table("avg_yearly",
                             j.cols["l_extendedprice"][m].sum() / 7.0)

    return Query("Q17", {"lineitem": li, "part": pa}, compute,
                 shuffle_keys={"lineitem": "l_partkey", "part": "p_partkey"})


def q18(threshold: float = 150.0) -> Query:
    li = PushPlan("lineitem", ("l_orderkey",),
                  agg=(("l_orderkey",), (("sum_qty", "sum", "l_quantity"),)))
    od = PushPlan("orders", ("o_orderkey", "o_custkey", "o_orderdate",
                             "o_totalprice"))

    def compute(t):
        g = ops.grouped_agg(t["lineitem"], ["l_orderkey"],
                            {"sum_qty": ("sum", "sum_qty")})
        big = g.filter(g.cols["sum_qty"] > threshold)
        j = ops.hash_join(big, t["orders"], "l_orderkey", "o_orderkey")
        return ops.top_k(j, "o_totalprice", 100)

    return Query("Q18", {"lineitem": li, "orders": od}, compute,
                 shuffle_keys={"lineitem": "l_orderkey", "orders": "o_orderkey"})


def q19() -> Query:
    # OR-of-ANDs over brand/container/quantity/size — the composite-predicate
    # showcase for fine-grained bitmap pushdown
    li = PushPlan(
        "lineitem", ("l_partkey", "l_quantity", "revenue"),
        predicate=(C("l_shipmode").isin((0, 1))
                   & C("l_shipinstruct").eq(2)
                   & ((C("l_quantity").between(1, 12)
                       | C("l_quantity").between(10, 21))
                      | C("l_quantity").between(20, 31))),
        derive=(REV,))
    pa = PushPlan("part", ("p_partkey", "p_brand", "p_container", "p_size"))

    def compute(t):
        j = ops.hash_join(t["lineitem"], t["part"], "l_partkey", "p_partkey")
        c = j.cols
        m = (((c["p_brand"] == 3) & (c["p_container"] < 10)
              & (c["l_quantity"] < 12) & (c["p_size"] <= 5))
             | ((c["p_brand"] == 5) & (c["p_container"] < 20)
                & (c["l_quantity"] < 21) & (c["p_size"] <= 10))
             | ((c["p_brand"] == 9) & (c["p_container"] < 40)
                & (c["l_quantity"] < 31) & (c["p_size"] <= 15)))
        return _scalar_table("revenue", c["revenue"][m].sum())

    return Query("Q19", {"lineitem": li, "part": pa}, compute,
                 shuffle_keys={"lineitem": "l_partkey", "part": "p_partkey"})




def q22() -> Query:
    cu = PushPlan("customer", ("c_custkey", "c_nationkey", "c_acctbal"),
                  predicate=C("c_acctbal") > 0.0)
    od = PushPlan("orders", ("o_custkey",))

    def compute(t):
        c = t["customer"]
        c = c.filter(_isin(c.cols["c_nationkey"], (13, 17, 19, 21, 23)))
        avg = c.cols["c_acctbal"].mean() if len(c) else 0.0
        rich = c.filter(c.cols["c_acctbal"] > avg)
        has_order = ops.isin(rich.cols["c_custkey"],
                             t["orders"].cols["o_custkey"])
        g = ops.grouped_agg(rich.filter(~has_order), ["c_nationkey"],
                            {"numcust": ("count", ""),
                             "totacctbal": ("sum", "c_acctbal")})
        return ops.sort_table(g, ["c_nationkey"])

    return Query("Q22", {"customer": cu, "orders": od}, compute,
                 shuffle_keys={"orders": "o_custkey"})


_BUILDERS = {f.__name__.upper(): f for f in (
    q1, q3, q4, q5, q6, q7, q8, q10, q12, q14, q15, q17, q18, q19, q22)}
QUERY_IDS: List[str] = sorted(_BUILDERS, key=lambda q: int(q[1:]))


def build_query(qid: str, fact_selectivity: Optional[float] = None) -> Query:
    """Compile ``qid`` (one of ``QUERY_IDS``) from its logical-plan IR."""
    from repro_torch.compiler import compile_query  # deferred: a cycle
    return compile_query(qid, fact_selectivity)


def build_query_legacy(qid: str) -> Query:
    """The hand-built query ``qid``: the reference the compiled plans are
    held equal to."""
    return _BUILDERS[qid.upper()]()
