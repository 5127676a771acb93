"""The benchmark's TPC-H tables, made from the seed on the card.

A rewrite in PyTorch of ``repro_torch.queryproc.tpch.generate_tables``
(commit e9a3657): the same tables, columns, dtypes, row counts and value
ranges, drawn by one ``torch.Generator`` on the device in one call a
column, so that SF10's 60M lineitem rows take well under a second, where
the host's numpy generator took 8-17 s of every run's set-up. The same
``(sf, seed)`` on the same kind of device gives the same columns, bit for
bit; the numbers differ from the numpy generator's. ``sf=1`` is 1/100 of
TPC-H SF1's row counts, so ``sf=1000`` holds SF10's 60M lineitem rows.
Strings are dictionary-encoded to int codes and dates are int days since
1992-01-01. ``cast_widths`` re-stores the tables at a configuration's
column widths (the narrow configuration's frozen copy of
``chip_smoke.py``'s ``NARROW`` table), and ``to_host`` hands them over as
the numpy arrays that the catalog and the reference are built from.
"""
from __future__ import annotations

import datetime
from typing import Dict, Optional

import numpy as np
import torch

Tables = Dict[str, Dict[str, torch.Tensor]]
HostTables = Dict[str, Dict[str, np.ndarray]]

_EPOCH = datetime.date(1992, 1, 1)


def date(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - _EPOCH).days


BASE_ROWS = dict(lineitem=60_000, orders=15_000, customer=1_500,
                 part=2_000, supplier=100, partsupp=8_000,
                 nation=25, region=5)

N_RETURNFLAG, N_LINESTATUS, N_SHIPMODE, N_SHIPINSTRUCT = 3, 2, 7, 4
N_MKTSEGMENT, N_ORDERPRIORITY, N_BRAND, N_TYPE, N_CONTAINER = 5, 5, 25, 150, 40


def generate_tables(sf: float = 1.0, seed: int = 0,
                    device="cpu") -> Tables:
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed % 2 ** 64)

    def ints(lo: int, hi: int, n: int) -> torch.Tensor:   # [lo, hi)
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    def uniform(lo: float, hi: float, n: int) -> torch.Tensor:
        return torch.rand(n, generator=g, device=dev,
                          dtype=torch.float64).mul_(hi - lo).add_(lo)

    def arange(n: int) -> torch.Tensor:
        return torch.arange(n, device=dev, dtype=torch.int32)

    n = {k: max(1, int(v * sf)) for k, v in BASE_ROWS.items()}
    n["nation"], n["region"] = 25, 5

    region = {"r_regionkey": arange(5)}
    nation = {"n_nationkey": arange(25), "n_regionkey": arange(25) % 5}
    supplier = {
        "s_suppkey": arange(n["supplier"]),
        "s_nationkey": ints(0, 25, n["supplier"]),
        "s_acctbal": uniform(-999, 9999, n["supplier"]),
    }
    part = {
        "p_partkey": arange(n["part"]),
        "p_brand": ints(0, N_BRAND, n["part"]),
        "p_type": ints(0, N_TYPE, n["part"]),
        "p_size": ints(1, 51, n["part"]),
        "p_container": ints(0, N_CONTAINER, n["part"]),
        "p_retailprice": uniform(900, 2000, n["part"]),
    }
    partsupp = {
        "ps_partkey": ints(0, n["part"], n["partsupp"]),
        "ps_suppkey": ints(0, n["supplier"], n["partsupp"]),
        "ps_availqty": ints(1, 10_000, n["partsupp"]),
        "ps_supplycost": uniform(1, 1000, n["partsupp"]),
    }
    customer = {
        "c_custkey": arange(n["customer"]),
        "c_mktsegment": ints(0, N_MKTSEGMENT, n["customer"]),
        "c_nationkey": ints(0, 25, n["customer"]),
        "c_acctbal": uniform(-999, 9999, n["customer"]),
    }
    o_orderdate = ints(0, date(1998, 8, 2) - 121, n["orders"])
    # ~1/3 of customers have no orders (TPC-H's 3:2 customer:order-customer
    # ratio)
    orders = {
        "o_orderkey": arange(n["orders"]),
        "o_custkey": ints(0, max(1, (2 * n["customer"]) // 3), n["orders"]),
        "o_orderdate": o_orderdate,
        "o_orderpriority": ints(0, N_ORDERPRIORITY, n["orders"]),
        "o_shippriority": torch.zeros(n["orders"], device=dev,
                                      dtype=torch.int32),
        "o_totalprice": uniform(1000, 400_000, n["orders"]),
    }
    # lineitem rows reference a random order; dates derive from the order's
    nl = n["lineitem"]
    lo = ints(0, n["orders"], nl)
    odate = o_orderdate[lo]
    shipdate = odate + ints(1, 122, nl)
    lineitem = {
        "l_orderkey": lo,
        "l_partkey": ints(0, n["part"], nl),
        "l_suppkey": ints(0, n["supplier"], nl),
        "l_quantity": ints(1, 51, nl).double(),
        "l_extendedprice": uniform(900, 100_000, nl),
        "l_discount": ints(0, 11, nl).double() / 100.0,
        "l_tax": ints(0, 9, nl).double() / 100.0,
        "l_returnflag": ints(0, N_RETURNFLAG, nl),
        "l_linestatus": ints(0, N_LINESTATUS, nl),
        "l_shipdate": shipdate,
        "l_commitdate": odate + ints(30, 91, nl),
        "l_receiptdate": shipdate + ints(1, 31, nl),
        "l_shipinstruct": ints(0, N_SHIPINSTRUCT, nl),
        "l_shipmode": ints(0, N_SHIPMODE, nl),
    }
    return {"region": region, "nation": nation, "supplier": supplier,
            "part": part, "partsupp": partsupp, "customer": customer,
            "orders": orders, "lineitem": lineitem}


_TORCH_OF = {"uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
             "uint16": torch.uint16, "int32": torch.int32,
             "uint32": torch.uint32, "int64": torch.int64}
# torch holds unsigned 16/32-bit columns but moves them to numpy through
# the signed type of their width
_SIGNED_VIEW = {torch.uint16: (torch.int16, np.uint16),
                torch.uint32: (torch.int32, np.uint32)}


def narrow_dtype(name: str, dtype: torch.dtype, widths: Dict) -> torch.dtype:
    """A column's stored dtype under a configuration's ``widths``: floats
    kept, a named integer column at its width, every other integer column
    at ``widths["other_integers"]``."""
    if dtype.is_floating_point:
        return dtype
    for dt, names in widths["columns"].items():
        if name in names:
            return _TORCH_OF[dt]
    return _TORCH_OF[widths["other_integers"]]


def cast_widths(tables: Tables, widths: Optional[Dict]) -> Tables:
    """The tables stored at ``widths`` (None: as generated). Every cast must
    keep each value: a column whose smallest or largest value lies outside
    its width is refused here, before any run."""
    if widths is None:
        return tables
    out: Tables = {}
    for t, cols in tables.items():
        out[t] = {}
        for c, v in cols.items():
            dt = narrow_dtype(c, v.dtype, widths)
            if dt != v.dtype and v.numel():
                lo, hi = (int(x) for x in torch.aminmax(v))
                info = np.iinfo(str(dt).removeprefix("torch."))
                if lo < info.min or hi > info.max:
                    raise ValueError(f"{c} does not fit {dt}")
            out[t][c] = v.to(dt)
    return out


def to_host(tables: Tables) -> HostTables:
    """The tables as numpy arrays on the host, each at its stored dtype."""
    out: HostTables = {}
    for t, cols in tables.items():
        out[t] = {}
        for c, v in cols.items():
            if v.dtype in _SIGNED_VIEW:
                signed, np_dt = _SIGNED_VIEW[v.dtype]
                out[t][c] = v.view(signed).cpu().numpy().view(np_dt)
            else:
                out[t][c] = v.cpu().numpy()
    return out
