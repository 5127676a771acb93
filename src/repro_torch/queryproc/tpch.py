"""TPC-H-style dataset generator (numpy) and the device catalog over it.

Port of ``repro.queryproc.tpch``: ``generate_tables`` is a numpy copy of
the reference generator, so the same ``(sf, seed)`` gives bitwise-identical
columns; ``build_catalog`` then copies each column to the device once.
``sf=1`` is 1/100 of the real SF1 row counts (``sf=1000`` holds TPC-H
SF10's 60M lineitem rows). Strings are dictionary-encoded to int codes and
dates are int days since 1992-01-01.
"""
from __future__ import annotations

import datetime
from typing import Dict

import numpy as np

from repro_torch.storage.catalog import Catalog, catalog_from_arrays

_EPOCH = datetime.date(1992, 1, 1)


def date(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - _EPOCH).days


BASE_ROWS = dict(lineitem=60_000, orders=15_000, customer=1_500,
                 part=2_000, supplier=100, partsupp=8_000,
                 nation=25, region=5)

N_RETURNFLAG, N_LINESTATUS, N_SHIPMODE, N_SHIPINSTRUCT = 3, 2, 7, 4
N_MKTSEGMENT, N_ORDERPRIORITY, N_BRAND, N_TYPE, N_CONTAINER = 5, 5, 25, 150, 40


def generate_tables(sf: float = 1.0, seed: int = 0
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = {k: max(1, int(v * sf)) for k, v in BASE_ROWS.items()}
    n["nation"], n["region"] = 25, 5

    region = {"r_regionkey": np.arange(5, dtype=np.int32)}
    nation = {
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_regionkey": (np.arange(25) % 5).astype(np.int32),
    }
    supplier = {
        "s_suppkey": np.arange(n["supplier"], dtype=np.int32),
        "s_nationkey": rng.integers(0, 25, n["supplier"], np.int32),
        "s_acctbal": rng.uniform(-999, 9999, n["supplier"]).astype(np.float64),
    }
    part = {
        "p_partkey": np.arange(n["part"], dtype=np.int32),
        "p_brand": rng.integers(0, N_BRAND, n["part"], np.int32),
        "p_type": rng.integers(0, N_TYPE, n["part"], np.int32),
        "p_size": rng.integers(1, 51, n["part"], np.int32),
        "p_container": rng.integers(0, N_CONTAINER, n["part"], np.int32),
        "p_retailprice": rng.uniform(900, 2000, n["part"]).astype(np.float64),
    }
    partsupp = {
        "ps_partkey": rng.integers(0, n["part"], n["partsupp"], np.int32),
        "ps_suppkey": rng.integers(0, n["supplier"], n["partsupp"], np.int32),
        "ps_availqty": rng.integers(1, 10_000, n["partsupp"], np.int32),
        "ps_supplycost": rng.uniform(1, 1000, n["partsupp"]).astype(np.float64),
    }
    customer = {
        "c_custkey": np.arange(n["customer"], dtype=np.int32),
        "c_mktsegment": rng.integers(0, N_MKTSEGMENT, n["customer"], np.int32),
        "c_nationkey": rng.integers(0, 25, n["customer"], np.int32),
        "c_acctbal": rng.uniform(-999, 9999, n["customer"]).astype(np.float64),
    }
    o_orderdate = rng.integers(0, date(1998, 8, 2) - 121, n["orders"], np.int32)
    # ~1/3 of customers have no orders (TPC-H's 3:2 customer:order-customer
    # ratio — keeps Q22's NOT EXISTS anti-join non-empty)
    orders = {
        "o_orderkey": np.arange(n["orders"], dtype=np.int32),
        "o_custkey": rng.integers(0, max(1, (2 * n["customer"]) // 3),
                                  n["orders"], np.int32),
        "o_orderdate": o_orderdate,
        "o_orderpriority": rng.integers(0, N_ORDERPRIORITY, n["orders"], np.int32),
        "o_shippriority": np.zeros(n["orders"], np.int32),
        "o_totalprice": rng.uniform(1000, 400_000, n["orders"]).astype(np.float64),
    }
    # lineitem rows reference a random order; dates derive from the order's
    lo = rng.integers(0, n["orders"], n["lineitem"], np.int32)
    odate = o_orderdate[lo]
    shipdate = odate + rng.integers(1, 122, n["lineitem"], np.int32)
    lineitem = {
        "l_orderkey": lo,
        "l_partkey": rng.integers(0, n["part"], n["lineitem"], np.int32),
        "l_suppkey": rng.integers(0, n["supplier"], n["lineitem"], np.int32),
        "l_quantity": rng.integers(1, 51, n["lineitem"], np.int32).astype(np.float64),
        "l_extendedprice": rng.uniform(900, 100_000, n["lineitem"]).astype(np.float64),
        "l_discount": rng.integers(0, 11, n["lineitem"]).astype(np.float64) / 100.0,
        "l_tax": rng.integers(0, 9, n["lineitem"]).astype(np.float64) / 100.0,
        "l_returnflag": rng.integers(0, N_RETURNFLAG, n["lineitem"], np.int32),
        "l_linestatus": rng.integers(0, N_LINESTATUS, n["lineitem"], np.int32),
        "l_shipdate": shipdate,
        "l_commitdate": odate + rng.integers(30, 91, n["lineitem"], np.int32),
        "l_receiptdate": shipdate + rng.integers(1, 31, n["lineitem"], np.int32),
        "l_shipinstruct": rng.integers(0, N_SHIPINSTRUCT, n["lineitem"], np.int32),
        "l_shipmode": rng.integers(0, N_SHIPMODE, n["lineitem"], np.int32),
    }
    return {"region": region, "nation": nation, "supplier": supplier,
            "part": part, "partsupp": partsupp, "customer": customer,
            "orders": orders, "lineitem": lineitem}


def build_catalog(sf: float = 1.0, seed: int = 0, num_nodes: int = 1,
                  rows_per_partition: int = 6_000, device=None) -> Catalog:
    """The reference's partitioning: ``lineitem`` in ``rows_per_partition``
    rows (~10*sf requests per query), dimension tables in 4 objects per
    node."""
    return catalog_from_arrays(generate_tables(sf, seed), num_nodes,
                               rows_per_partition, device)
