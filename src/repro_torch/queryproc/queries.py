"""Hand-built TPC-H queries of this slice: Q1, Q3, Q6, Q12 and Q19.

Port of the seed builders of ``repro.queryproc.queries`` (the queries
``build_query_legacy`` returns): each query is a per-table ``PushPlan``
plus a ``compute`` residual, written here over device tensors. The same
plan runs at storage (pushdown) or at the compute layer over shipped raw
partitions (pushback), so every mode returns the same result.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from repro_torch.core.plan import PushPlan
from repro_torch.queryproc import operators as ops
from repro_torch.queryproc.expressions import Col
from repro_torch.queryproc.table import ColumnTable
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


def _scalar_table(name: str, value: torch.Tensor) -> ColumnTable:
    return ColumnTable({name: value.reshape(1)})


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
        pri = j.cols["o_orderpriority"]
        hi = torch.isin(pri, torch.tensor([0, 1], dtype=pri.dtype,
                                          device=pri.device)).to(torch.int64)
        j = ColumnTable({**j.cols, "high": hi, "low": 1 - hi})
        g = ops.grouped_agg(j, ["l_shipmode"], {"high_cnt": ("sum", "high"),
                                                "low_cnt": ("sum", "low")})
        return ops.sort_table(g, ["l_shipmode"])

    return Query("Q12", {"lineitem": li, "orders": od}, compute,
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


_BUILDERS = {f.__name__.upper(): f for f in (q1, q3, q6, q12, q19)}
QUERY_IDS: List[str] = sorted(_BUILDERS, key=lambda q: int(q[1:]))


def build_query(qid: str) -> Query:
    """The hand-built query ``qid`` (one of ``QUERY_IDS``)."""
    return _BUILDERS[qid.upper()]()
