"""The TPC-H workload as logical-plan IR constructions.

Port of ``repro.compiler.tpch_ir``: the same IR, with the row-wise derive
bodies and the two ``PyOp`` bodies written over device tensors. Same 15
queries as the seed's hand-built ``queryproc/queries.py`` (every
query named in the paper's figures), but expressed as relational IR: the
amenability split is *derived* by the compiler instead of frozen at
authoring time. Filters are written at their natural relational position —
on the branch that owns their columns — which lets the splitter push
dimension-table predicates the hand-built plans evaluated at the compute
layer, with identical results: strictly larger storage frontiers on Q5/Q8
(a new filter stage on ``nation``) and a strictly stronger pushed
predicate on Q22 (the nation-list conjunct, same stage count).

``Shuffle`` markers mirror the seed's ``shuffle_keys`` declarations (the
Fig-15 distributed-shuffle evaluation). ``PyOp`` appears exactly twice —
Q15's having-max and Q22's data-dependent balance threshold — the only
logic in the workload with no relational encoding.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from repro_torch.compiler import ir
from repro_torch.queryproc.expressions import Col
from repro_torch.queryproc.queries import CHARGE, DISC_PRICE, REV
from repro_torch.queryproc.table import ColumnTable
from repro_torch.queryproc.tpch import date

C = Col


# --------------------------------------------------------------------- Q1
def q1_ir() -> ir.Node:
    cutoff = date(1998, 8, 2) - 90
    n: ir.Node = ir.Scan("lineitem", ("l_returnflag", "l_linestatus"))
    n = ir.Filter(n, C("l_shipdate") <= cutoff)
    n = ir.Map(n, (DISC_PRICE, CHARGE))
    n = ir.Aggregate(n, ("l_returnflag", "l_linestatus"),
                     (("sum_qty", "sum", "l_quantity"),
                      ("sum_base", "sum", "l_extendedprice"),
                      ("sum_disc", "sum", "disc_price"),
                      ("sum_charge", "sum", "charge"),
                      ("cnt", "count", "")))
    return ir.Sort(n, ("l_returnflag", "l_linestatus"))


# --------------------------------------------------------------------- Q3
def q3_ir() -> ir.Node:
    D = date(1995, 3, 15)
    cu: ir.Node = ir.Filter(ir.Scan("customer", ("c_custkey",)),
                            C("c_mktsegment").eq(1))
    od: ir.Node = ir.Scan("orders", ("o_orderkey", "o_custkey", "o_orderdate",
                                     "o_shippriority"))
    od = ir.Shuffle(ir.Filter(od, C("o_orderdate") < D), "o_orderkey")
    li: ir.Node = ir.Scan("lineitem", ("l_orderkey",))
    li = ir.Map(ir.Filter(li, C("l_shipdate") > D), (REV,))
    li = ir.Shuffle(li, "l_orderkey")
    j = ir.Join(od, cu, "o_custkey", "c_custkey")
    j = ir.Join(li, j, "l_orderkey", "o_orderkey")
    g = ir.Aggregate(j, ("l_orderkey", "o_orderdate", "o_shippriority"),
                     (("revenue", "sum", "revenue"),))
    return ir.TopK(g, "revenue", 10)


# --------------------------------------------------------------------- Q4
def q4_ir() -> ir.Node:
    D = date(1993, 7, 1)
    od: ir.Node = ir.Scan("orders", ("o_orderkey", "o_orderpriority"))
    od = ir.Shuffle(ir.Filter(od, C("o_orderdate").between(D, D + 92)),
                    "o_orderkey")
    li: ir.Node = ir.Scan("lineitem", ("l_orderkey",))
    li = ir.Map(li, (("_late", ("l_commitdate", "l_receiptdate"),
                      lambda c, r: (c < r).to(torch.int32)),))
    li = ir.Shuffle(li, "l_orderkey")
    late = ir.Filter(li, C("_late").eq(1))  # derived col: stays residual
    semi = ir.SemiJoin(od, late, "o_orderkey", "l_orderkey")
    return ir.Aggregate(semi, ("o_orderpriority",), (("cnt", "count", ""),))


# --------------------------------------------------------------------- Q5
def q5_ir() -> ir.Node:
    D = date(1994, 1, 1)
    cu: ir.Node = ir.Scan("customer", ("c_custkey", "c_nationkey"))
    od: ir.Node = ir.Scan("orders", ("o_orderkey", "o_custkey"))
    od = ir.Shuffle(ir.Filter(od, C("o_orderdate").between(D, D + 365)),
                    "o_orderkey")
    li: ir.Node = ir.Map(ir.Scan("lineitem", ("l_orderkey", "l_suppkey")),
                         (REV,))
    li = ir.Shuffle(li, "l_orderkey")
    su: ir.Node = ir.Scan("supplier", ("s_suppkey", "s_nationkey"))
    # region filter at its natural position: pushed to storage (the seed's
    # hand-built plan ships all 25 nations and filters at compute)
    na: ir.Node = ir.Filter(ir.Scan("nation", ("n_nationkey",)),
                            C("n_regionkey").eq(2))
    j = ir.Join(od, cu, "o_custkey", "c_custkey")
    j = ir.Join(li, j, "l_orderkey", "o_orderkey")
    j = ir.Join(j, su, "l_suppkey", "s_suppkey")
    j = ir.Filter(j, C("c_nationkey").eq(C("s_nationkey")))
    j = ir.Join(j, na, "s_nationkey", "n_nationkey")
    g = ir.Aggregate(j, ("s_nationkey",), (("revenue", "sum", "revenue"),))
    return ir.Sort(g, ("revenue",), ascending=False)


# --------------------------------------------------------------------- Q6
def q6_ir() -> ir.Node:
    D = date(1994, 1, 1)
    n: ir.Node = ir.Scan("lineitem", ())
    n = ir.Filter(n, (C("l_shipdate").between(D, D + 365)
                      & C("l_discount").between(0.05, 0.0701)
                      & (C("l_quantity") < 24)))
    n = ir.Map(n, (("disc_rev", ("l_extendedprice", "l_discount"),
                    lambda e, d: e * d),))
    return ir.Aggregate(n, (), (("revenue", "sum", "disc_rev"),))


# --------------------------------------------------------------------- Q7
def q7_ir() -> ir.Node:
    d0, d1 = date(1995, 1, 1), date(1996, 12, 31)
    li: ir.Node = ir.Scan("lineitem",
                          ("l_orderkey", "l_suppkey", "l_shipdate"))
    li = ir.Filter(li, C("l_shipdate").between(d0, d1 + 1))
    li = ir.Map(li, (("volume", ("l_extendedprice", "l_discount"),
                      lambda e, d: e * (1 - d)),))
    li = ir.Shuffle(li, "l_orderkey")
    od: ir.Node = ir.Shuffle(ir.Scan("orders", ("o_orderkey", "o_custkey")),
                             "o_orderkey")
    cu: ir.Node = ir.Scan("customer", ("c_custkey", "c_nationkey"))
    su: ir.Node = ir.Scan("supplier", ("s_suppkey", "s_nationkey"))
    j = ir.Join(li, su, "l_suppkey", "s_suppkey")
    j = ir.Join(j, od, "l_orderkey", "o_orderkey")
    j = ir.Join(j, cu, "o_custkey", "c_custkey")
    j = ir.Filter(j, (C("s_nationkey").eq(5) & C("c_nationkey").eq(7))
                  | (C("s_nationkey").eq(7) & C("c_nationkey").eq(5)))
    j = ir.Map(j, (("l_year", ("l_shipdate",),
                    lambda s: (s // 365).to(torch.int32)),))
    g = ir.Aggregate(j, ("s_nationkey", "c_nationkey", "l_year"),
                     (("revenue", "sum", "volume"),))
    return ir.Sort(g, ("s_nationkey", "c_nationkey", "l_year"))


# --------------------------------------------------------------------- Q8
def q8_ir() -> ir.Node:
    d0, d1 = date(1995, 1, 1), date(1996, 12, 31)
    od: ir.Node = ir.Scan("orders", ("o_orderkey", "o_custkey",
                                     "o_orderdate"))
    od = ir.Shuffle(ir.Filter(od, C("o_orderdate").between(d0, d1 + 1)),
                    "o_orderkey")
    li: ir.Node = ir.Scan("lineitem", ("l_orderkey", "l_partkey",
                                       "l_suppkey"))
    li = ir.Map(li, (("volume", ("l_extendedprice", "l_discount"),
                      lambda e, d: e * (1 - d)),))
    li = ir.Shuffle(li, "l_orderkey")
    pa: ir.Node = ir.Filter(ir.Scan("part", ("p_partkey",)),
                            C("p_type").eq(42))
    cu: ir.Node = ir.Scan("customer", ("c_custkey", "c_nationkey"))
    su: ir.Node = ir.Scan("supplier", ("s_suppkey", "s_nationkey"))
    # region filter pushed (seed joins all nations, filters at compute)
    na: ir.Node = ir.Filter(ir.Scan("nation", ("n_nationkey",)),
                            C("n_regionkey").eq(1))
    j = ir.Join(li, pa, "l_partkey", "p_partkey")
    j = ir.Join(j, od, "l_orderkey", "o_orderkey")
    j = ir.Join(j, cu, "o_custkey", "c_custkey")
    j = ir.Join(j, na, "c_nationkey", "n_nationkey")
    j = ir.Join(j, su, "l_suppkey", "s_suppkey")
    j = ir.Map(j, (("o_year", ("o_orderdate",),
                    lambda d: (d // 365).to(torch.int32)),
                   ("nat_volume", ("s_nationkey", "volume"),
                    lambda s, v: (s == 3).to(torch.float64) * v)))
    g = ir.Aggregate(j, ("o_year",), (("nat", "sum", "nat_volume"),
                                      ("total", "sum", "volume")))
    g = ir.Map(g, (("mkt_share", ("nat", "total"),
                    lambda n, t: n / torch.clamp(t.to(torch.float64),
                                                 min=1e-9)),))
    return ir.Project(g, ("o_year", "mkt_share"))


# -------------------------------------------------------------------- Q10
def q10_ir() -> ir.Node:
    D = date(1993, 10, 1)
    cu: ir.Node = ir.Scan("customer", ("c_custkey", "c_nationkey",
                                       "c_acctbal"))
    od: ir.Node = ir.Scan("orders", ("o_orderkey", "o_custkey"))
    od = ir.Shuffle(ir.Filter(od, C("o_orderdate").between(D, D + 92)),
                    "o_orderkey")
    li: ir.Node = ir.Scan("lineitem", ("l_orderkey",))
    li = ir.Map(ir.Filter(li, C("l_returnflag").eq(2)), (REV,))
    li = ir.Shuffle(li, "l_orderkey")
    j = ir.Join(li, od, "l_orderkey", "o_orderkey")
    j = ir.Join(j, cu, "o_custkey", "c_custkey")
    g = ir.Aggregate(j, ("o_custkey",), (("revenue", "sum", "revenue"),))
    return ir.TopK(g, "revenue", 20)


# -------------------------------------------------------------------- Q12
def q12_ir() -> ir.Node:
    D = date(1994, 1, 1)
    li: ir.Node = ir.Scan("lineitem", ("l_orderkey", "l_shipmode"))
    li = ir.Filter(li, C("l_shipmode").isin((0, 4))
                   & C("l_receiptdate").between(D, D + 365))
    li = ir.Map(li, (("_ontime",
                      ("l_shipdate", "l_commitdate", "l_receiptdate"),
                      lambda s, c, r: ((s < c) & (c < r)).to(torch.int32)),))
    li = ir.Shuffle(li, "l_orderkey")
    li = ir.Filter(li, C("_ontime").eq(1))  # derived col: stays residual
    od: ir.Node = ir.Shuffle(
        ir.Scan("orders", ("o_orderkey", "o_orderpriority")), "o_orderkey")
    j = ir.Join(li, od, "l_orderkey", "o_orderkey")
    j = ir.Map(j, (("high", ("o_orderpriority",),
                    lambda p: ((p == 0) | (p == 1)).to(torch.int64)),
                   ("low", ("high",), lambda h: 1 - h)))
    g = ir.Aggregate(j, ("l_shipmode",), (("high_cnt", "sum", "high"),
                                          ("low_cnt", "sum", "low")))
    return ir.Sort(g, ("l_shipmode",))


# -------------------------------------------------------------------- Q14
def q14_ir() -> ir.Node:
    D = date(1995, 9, 1)
    li: ir.Node = ir.Scan("lineitem", ("l_partkey",))
    li = ir.Map(ir.Filter(li, C("l_shipdate").between(D, D + 30)), (REV,))
    li = ir.Shuffle(li, "l_partkey")
    pa: ir.Node = ir.Shuffle(ir.Scan("part", ("p_partkey", "p_type")),
                             "p_partkey")
    j = ir.Join(li, pa, "l_partkey", "p_partkey")
    j = ir.Map(j, (("promo", ("p_type", "revenue"),
                    lambda t, r: (t < 15).to(torch.float64) * r),))
    g = ir.Aggregate(j, (), (("num", "sum", "promo"),
                             ("den", "sum", "revenue")))
    g = ir.Map(g, (("promo_revenue", ("num", "den"),
                    lambda n, d: 100.0 * n / torch.clamp(d, min=1e-9)),))
    return ir.Project(g, ("promo_revenue",))


# -------------------------------------------------------------------- Q15
def _q15_top(g: ColumnTable) -> ColumnTable:
    mx = g.cols["total_rev"].max() if len(g) else 0.0
    return g.filter(g.cols["total_rev"] >= mx - 1e-9)


def q15_ir() -> ir.Node:
    D = date(1996, 1, 1)
    li: ir.Node = ir.Scan("lineitem", ())
    li = ir.Map(ir.Filter(li, C("l_shipdate").between(D, D + 92)), (REV,))
    li = ir.Aggregate(li, ("l_suppkey",), (("total_rev", "sum", "revenue"),))
    li = ir.Shuffle(li, "l_suppkey")
    su: ir.Node = ir.Scan("supplier", ("s_suppkey", "s_nationkey"))
    top = ir.PyOp((li,), _q15_top, note="having total_rev == max(total_rev)")
    return ir.Join(top, su, "l_suppkey", "s_suppkey")


# -------------------------------------------------------------------- Q17
def q17_ir() -> ir.Node:
    li: ir.Node = ir.Shuffle(
        ir.Scan("lineitem", ("l_partkey", "l_quantity", "l_extendedprice")),
        "l_partkey")
    pa: ir.Node = ir.Filter(ir.Scan("part", ("p_partkey",)),
                            C("p_brand").eq(3) & C("p_container").eq(7))
    pa = ir.Shuffle(pa, "p_partkey")
    j = ir.Join(li, pa, "l_partkey", "p_partkey")
    g = ir.Aggregate(j, ("l_partkey",), (("avg_qty", "mean", "l_quantity"),))
    jj = ir.Join(j, g, "l_partkey", "l_partkey")  # shared subtree: j reused
    jj = ir.Map(jj, (("qty_thresh", ("avg_qty",), lambda a: 0.2 * a),))
    jj = ir.Filter(jj, C("l_quantity") < C("qty_thresh"))
    s = ir.Aggregate(jj, (), (("total", "sum", "l_extendedprice"),))
    s = ir.Map(s, (("avg_yearly", ("total",), lambda t: t / 7.0),))
    return ir.Project(s, ("avg_yearly",))


# -------------------------------------------------------------------- Q18
def q18_ir(threshold: float = 150.0) -> ir.Node:
    li: ir.Node = ir.Scan("lineitem", ())
    li = ir.Aggregate(li, ("l_orderkey",), (("sum_qty", "sum", "l_quantity"),))
    li = ir.Shuffle(li, "l_orderkey")
    big = ir.Filter(li, C("sum_qty") > threshold)
    od: ir.Node = ir.Shuffle(
        ir.Scan("orders", ("o_orderkey", "o_custkey", "o_orderdate",
                           "o_totalprice")), "o_orderkey")
    j = ir.Join(big, od, "l_orderkey", "o_orderkey")
    return ir.TopK(j, "o_totalprice", 100)


# -------------------------------------------------------------------- Q19
def q19_ir() -> ir.Node:
    li: ir.Node = ir.Scan("lineitem", ("l_partkey", "l_quantity"))
    li = ir.Filter(li, (C("l_shipmode").isin((0, 1))
                        & C("l_shipinstruct").eq(2)
                        & ((C("l_quantity").between(1, 12)
                            | C("l_quantity").between(10, 21))
                           | C("l_quantity").between(20, 31))))
    li = ir.Shuffle(ir.Map(li, (REV,)), "l_partkey")
    pa: ir.Node = ir.Shuffle(
        ir.Scan("part", ("p_partkey", "p_brand", "p_container", "p_size")),
        "p_partkey")
    j = ir.Join(li, pa, "l_partkey", "p_partkey")
    j = ir.Filter(j, ((C("p_brand").eq(3) & (C("p_container") < 10)
                       & (C("l_quantity") < 12) & (C("p_size") <= 5))
                      | (C("p_brand").eq(5) & (C("p_container") < 20)
                         & (C("l_quantity") < 21) & (C("p_size") <= 10))
                      | (C("p_brand").eq(9) & (C("p_container") < 40)
                         & (C("l_quantity") < 31) & (C("p_size") <= 15))))
    return ir.Aggregate(j, (), (("revenue", "sum", "revenue"),))


# -------------------------------------------------------------------- Q22
def _q22_rich(c: ColumnTable) -> ColumnTable:
    avg = c.cols["c_acctbal"].mean() if len(c) else 0.0
    return c.filter(c.cols["c_acctbal"] > avg)


def q22_ir() -> ir.Node:
    cu: ir.Node = ir.Scan("customer", ("c_custkey", "c_nationkey",
                                       "c_acctbal"))
    # both conjuncts pushed (seed pushes only the balance predicate and
    # evaluates the nation list at compute)
    cu = ir.Filter(cu, (C("c_acctbal") > 0.0)
                   & C("c_nationkey").isin((13, 17, 19, 21, 23)))
    od: ir.Node = ir.Shuffle(ir.Scan("orders", ("o_custkey",)), "o_custkey")
    rich = ir.PyOp((cu,), _q22_rich, note="acctbal above segment average")
    noord = ir.SemiJoin(rich, od, "c_custkey", "o_custkey", anti=True)
    g = ir.Aggregate(noord, ("c_nationkey",),
                     (("numcust", "count", ""),
                      ("totacctbal", "sum", "c_acctbal")))
    return ir.Sort(g, ("c_nationkey",))


IR_BUILDERS: Dict[str, Callable[[], ir.Node]] = {
    f.__name__[:-3].upper(): f for f in (
        q1_ir, q3_ir, q4_ir, q5_ir, q6_ir, q7_ir, q8_ir, q10_ir, q12_ir,
        q14_ir, q15_ir, q17_ir, q18_ir, q19_ir, q22_ir)}
QUERY_IDS: List[str] = sorted(IR_BUILDERS, key=lambda q: int(q[1:]))


def build_ir(qid: str) -> ir.Node:
    return IR_BUILDERS[qid.upper()]()
