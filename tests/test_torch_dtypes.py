"""The port's column domain against the JAX package's numpy engine, on the CPU.

The reference's engine runs any numpy column dtype. The port takes every
one torch can hold: bool, uint8, int8, int16, uint16, int32, uint32, int64,
uint64, float16, float32 and float64 (``queryproc.table.NP_OF``). Held here:

- the nine operator mismatches the port had, each on its smallest input,
  against ``repro.queryproc`` (values, dtypes and column order);
- ``compile_expr`` and the kernels' postfix programs (through the plain
  ``predicate_bitmap``) against ``repro.queryproc.expressions.compile_expr``
  bitwise, on drawn dtypes, values, operators and constants (numpy 2.0.2's
  comparison rules, out-of-range and negative constants included);
- the plain versions of the six kernels on a column of every dtype against
  ``repro.queryproc``'s numpy operators (not ``repro.kernels.ops``: with x64
  off JAX cuts uint64 to 32 bits);
- TPC-H stored at its narrowest widths (``narrow_tables``: uint8 codes,
  int16 dates, a uint16 quantity, uint32 keys), all fifteen compiled queries
  in the four modes at powers 1.0 and 0.1 and the cost-based compile, against
  the reference's runs on the same narrow catalog: rows, dtypes, column
  order, real network bytes, decisions and the admitted and pushed-back
  counts. The port runs them under ``NoWideKernels``, which refuses every
  torch call on a uint16/32/64 tensor that torch's CUDA build does not have
  (indexing, comparing, sorting, reducing them), so the CPU run shows that
  the port routes around those gaps on the card too.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from torch.overrides import TorchFunctionMode

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.core.cost import StorageResources as RResources
from repro.distributed import workers as RW
from repro.obs import metrics as rmetrics
from repro.queryproc import expressions as rex
from repro.queryproc import operators as rops
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro.queryproc.table import ColumnStats as RStats
from repro.queryproc.table import ColumnTable as RTable
from repro.storage.catalog import Catalog as RCatalog
from repro_torch.core import engine
from repro_torch.core.cost import StorageResources
from repro_torch.distributed import workers as W
from repro_torch.kernels import bitmap_apply as ba
from repro_torch.kernels import fused_scan_agg as fsa
from repro_torch.kernels import fused_scan_shuffle as fss
from repro_torch.kernels import grouped_agg as ga
from repro_torch.kernels import hash_partition as hp
from repro_torch.kernels import predicate_bitmap as pb
from repro_torch.kernels import ref
from repro_torch.kernels.program import compile_predicate
from repro_torch.obs import metrics as tmetrics
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc import operators as ops
from repro_torch.queryproc import queries
from repro_torch.queryproc.table import NP_OF, ColumnStats, ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays

DTYPES = tuple(NP_OF)
IDS = [str(d)[6:] for d in DTYPES]
WIDE = (torch.uint16, torch.uint32, torch.uint64)
SF, SEED, NODES, RPP = 0.01, 0, 3, 1500
POWERS = (1.0, 0.1)

# TPC-H's columns at their narrowest widths: dictionary codes and small
# keys in one byte, dates as int16 day numbers, the remaining keys uint32
U8 = ("r_regionkey", "n_nationkey", "n_regionkey", "s_nationkey",
      "c_nationkey", "c_mktsegment", "p_brand", "p_type", "p_size",
      "p_container", "o_orderpriority", "o_shippriority", "l_returnflag",
      "l_linestatus", "l_shipinstruct", "l_shipmode")
I16 = ("o_orderdate", "l_shipdate", "l_commitdate", "l_receiptdate")
U16 = ("ps_availqty",)


def narrow_tables(sf, seed):
    """The reference's ``generate_tables`` with every int32 column stored
    at its narrow width (float64 columns stay float64)."""
    def width(name, a):
        if a.dtype == np.float64:
            return a
        assert a.dtype == np.int32, name
        return a.astype(np.uint8 if name in U8 else np.int16 if name in I16
                        else np.uint16 if name in U16 else np.uint32)
    return {t: {c: width(c, v) for c, v in tab.cols.items()}
            for t, tab in rtpch.generate_tables(sf, seed).items()}


def ref_catalog(tables, nodes, rpp):
    """``rtpch.build_catalog``'s partitioning over given tables."""
    cat = RCatalog(nodes)
    for name, cols in tables.items():
        n = len(next(iter(cols.values())))
        cat.add_table(name, RTable(cols), rpp if name == "lineitem"
                      else max(n // max(1, nodes * 4), 1))
    return cat


class NoWideKernels(TorchFunctionMode):
    """Refuse what torch's CUDA build lacks for uint16/32/64 tensors: any
    call on one but a view, a copy, a cast, a concatenation, a slice or a
    query of its shape, bytes or dtype."""
    T = torch.Tensor
    ALLOWED = {T.view, T.to, T.cpu, T.clone, T.contiguous, T.detach,
               torch.cat, T.numel, T.size, T.dim, T.element_size,
               T.data_ptr, T.is_contiguous, T.stride, T.storage_offset,
               T.__len__, T.__repr__, T.__format__, T.tolist, T.numpy,
               T.reshape, T.copy_, T.pin_memory, torch.split, T.split,
               T.is_floating_point, T.is_complex, T.untyped_storage,
               T.new_empty, T.__iter__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") == "__get__" \
                or func in self.ALLOWED or (
                    func is self.T.__getitem__
                    and not any(isinstance(i, torch.Tensor) for i in (
                        args[1] if isinstance(args[1], tuple)
                        else (args[1],)))):
            return func(*args, **kwargs)
        if _has_wide((args, kwargs)):
            raise RuntimeError(f"{func.__name__} on a uint16/32/64 tensor: "
                               f"torch's CUDA build has no such kernel")
        return func(*args, **kwargs)


def _has_wide(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype in WIDE
    if isinstance(x, (list, tuple)):
        return any(_has_wide(y) for y in x)
    if isinstance(x, dict):
        return any(_has_wide(y) for y in x.values())
    return False


def test_the_guard_refuses_what_the_card_lacks():
    u = torch.tensor([3, 1], dtype=torch.uint32)
    with NoWideKernels():
        for bad in (lambda: u[torch.tensor([0])], lambda: u < 2,
                    lambda: torch.sort(u), lambda: u.amax(),
                    lambda: u.max()):
            with pytest.raises(RuntimeError, match="no such kernel"):
                bad()
        assert u[1:].tolist() == [1]
        # a dtype query, as is_floating_point: the card needs no kernel
        assert not u.is_complex() and not u.is_floating_point()
        assert u.view(torch.int32)[torch.tensor([0])].tolist() == [3]


def to_torch(cols):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            cols.items()}


def assert_same_table(got: ColumnTable, want: RTable, exact=True):
    """Values, dtypes and column order."""
    assert got.columns == list(want.cols)
    for c in want.cols:
        g, w = got.cols[c].numpy(), np.asarray(want.cols[c])
        assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=c)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=c)


# ------------------------------------------------------ mismatches 1 to 9
def test_1_join_on_bool_keys():
    left = {"k": np.array([True, False, True]), "a": np.int32([1, 2, 3])}
    right = {"k": np.array([True, False]), "b": np.int64([10, 20])}
    assert_same_table(
        ops.hash_join(ColumnTable(to_torch(left)),
                      ColumnTable(to_torch(right)), "k", "k"),
        rops.hash_join(RTable(left), RTable(right), "k", "k"))


def test_2_keyless_sum_of_uint8_is_uint64():
    t = {"u": np.uint8([200, 100])}
    agg = {"s": ("sum", "u")}
    assert_same_table(ops.grouped_agg(ColumnTable(to_torch(t)), [], agg),
                      rops.grouped_agg(RTable(t), [], agg))


def test_3_grouped_agg_keyed_on_uint64():
    t = {"k": np.uint64([2 ** 63 + 5, 1, 2 ** 63 + 5])}
    agg = {"c": ("count", "")}
    got = ops.grouped_agg(ColumnTable(to_torch(t)), ["k"], agg)
    assert_same_table(got, rops.grouped_agg(RTable(t), ["k"], agg))
    assert got.cols["k"].tolist() == [1, 2 ** 63 + 5]


@pytest.mark.parametrize("ldt,lk", [
    (np.int32, [5, 2, 7]), (np.int64, [2 ** 53 + 1, 3])])
def test_4_join_of_signed_and_uint64_keys_meets_in_float64(ldt, lk):
    """numpy's searchsorted promotes int32 or int64 against uint64 to
    float64, so 2**53 + 1 matches 2**53 and 2**53 + 1 alike."""
    left = {"k": np.asarray(lk, ldt), "a": np.arange(len(lk), dtype=np.int32)}
    right = {"k": np.uint64([2 ** 53, 5, 2 ** 53 + 1, 7, 3]),
             "b": np.float64([1.0, 2.0, 3.0, 4.0, 5.0])}
    assert_same_table(
        ops.hash_join(ColumnTable(to_torch(left)),
                      ColumnTable(to_torch(right)), "k", "k"),
        rops.hash_join(RTable(left), RTable(right), "k", "k"))


def test_5_join_with_nan_on_the_build_side():
    left = {"k": np.float64([1.0, 2.0])}
    right = {"k": np.float64([np.nan, 1.0, 2.0]), "b": np.int64([10, 20, 30])}
    got = ops.hash_join(ColumnTable(to_torch(left)),
                        ColumnTable(to_torch(right)), "k", "k")
    assert_same_table(got, rops.hash_join(RTable(left), RTable(right),
                                          "k", "k"))
    assert len(got) == 2
    # NaN meets NaN, as numpy's sort and searchsorted place it
    left = {"k": np.float64([np.nan, 1.0, -0.0])}
    right = {"k": np.float64([0.0, np.nan, 1.0, np.nan]),
             "b": np.int64([1, 2, 3, 4])}
    assert_same_table(
        ops.hash_join(ColumnTable(to_torch(left)),
                      ColumnTable(to_torch(right)), "k", "k"),
        rops.hash_join(RTable(left), RTable(right), "k", "k"))


@pytest.mark.parametrize("ascending", (False, True))
def test_6_top_k_puts_nan_last(ascending):
    t = {"v": np.float64([2.0, np.nan, 1.0, np.nan]),
         "i": np.int32([0, 1, 2, 3])}
    got = ops.top_k(ColumnTable(to_torch(t)), "v", 2, ascending)
    assert_same_table(got, rops.top_k(RTable(t), "v", 2, ascending))
    # sort_table too: NaN last, then every row reversed when descending
    assert_same_table(ops.sort_table(ColumnTable(to_torch(t)), ["v"],
                                     ascending),
                      rops.sort_table(RTable(t), ["v"], ascending))


@pytest.mark.parametrize("dtype", (np.uint16, np.uint32, np.uint64))
def test_7_column_stats_of_wide_unsigned(dtype):
    info = np.iinfo(dtype)
    a = np.random.default_rng(7).integers(0, info.max, 9000, dtype=dtype,
                                          endpoint=True)
    assert dataclasses.astuple(ColumnStats.of(torch.from_numpy(a))) == \
        dataclasses.astuple(RStats.of(a))


def test_8_hash_partition_ids_of_float_keys():
    keys = np.array([0.0, 1.5, 7.0, 2.0 ** 40 + 0.5, 3e9, 1e19], np.float64)
    for dt in (np.float64, np.float32, np.float16):
        k = keys.astype(dt) if dt != np.float16 else np.float16(
            [0.0, 1.5, 7.0, 60000.0, 2049.0])
        np.testing.assert_array_equal(
            ref.hash_partition_ids(torch.from_numpy(k), 7).numpy(),
            rops.hash_partition_ids(k, 7))
    for bad in (-1.0, np.nan, np.inf, 2.0 ** 64):
        with pytest.raises(ValueError, match="platform-defined"):
            ref.hash_partition_ids(torch.tensor([1.0, bad]), 4)


def test_9_wire_codec_ships_wide_unsigned_columns():
    cols = {"a": np.uint16([0, 65535, 7]), "b": np.uint32([2 ** 32 - 1, 0, 9]),
            "c": np.uint64([2 ** 64 - 1, 2 ** 63, 1])}
    bufs = []
    spec = W._enc(ColumnTable(to_torch(cols)), bufs)
    body = bytearray(b"".join(bytes(memoryview(x)) for x in bufs))
    got = W._dec(json.loads(json.dumps(spec)), W._Cursor(body),
                 torch.device("cpu"))
    rbufs = []
    rspec = RW._enc(RTable(cols), rbufs)
    want = RW._dec(rspec, RW._Cursor(bytearray(b"".join(rbufs))))
    assert_same_table(got, want)


# ------------------------------------------- comparisons, drawn (NEP 50)
def _column(draw, dtype, n):
    np_t = np.dtype(NP_OF[dtype])
    if np_t.kind == "b":
        vals = draw(st.lists(st.booleans(), min_size=n, max_size=n))
    elif np_t.kind in "iu":
        info = np.iinfo(np_t)
        edge = st.sampled_from([info.min, info.max, 0, 1,
                                max(info.min, -1), info.max // 2 + 1])
        vals = draw(st.lists(edge | st.integers(info.min, info.max),
                             min_size=n, max_size=n))
    else:
        bound = 6e4 if np_t.itemsize == 2 else 1e6
        vals = draw(st.lists(st.sampled_from(
            [np.nan, -0.0, 0.0, 0.1, -1.5, np.inf, 2049.0, 1e4])
            | st.floats(-bound, bound, width=16 if np_t.itemsize == 2
                        else 32), min_size=n, max_size=n))
    return np.asarray(vals).astype(np_t)


_CONST = (st.integers(-2 ** 66, 2 ** 66)
          | st.sampled_from([0, 1, -1, 255, 256, 300, -129, 2 ** 31, 2 ** 32,
                             2 ** 53 + 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1,
                             2 ** 64, -2 ** 63, True, False])
          | st.floats(-1e20, 1e20) | st.sampled_from([0.1, -0.0, 0.5, 2049.0])
          | st.sampled_from([np.int64(-3), np.uint64(2 ** 63 + 1),
                             np.float32(0.1), np.int8(-1), np.float64(1e10)]))


@st.composite
def predicates(draw):
    """(reference tree, port tree, numpy columns) of one leaf or a pair."""
    n = draw(st.integers(1, 24))
    dx = draw(st.sampled_from(DTYPES))
    cols = {"x": _column(draw, dx, n)}
    kind = draw(st.sampled_from(("cmp", "in", "colcol")))
    op = draw(st.sampled_from(ex.CMP_OPS))
    if kind == "colcol":
        cols["y"] = _column(draw, draw(st.sampled_from(DTYPES)), n)
        trees = (rex.Cmp(op, rex.Col("x"), rex.Col("y")),
                 ex.Cmp(op, ex.Col("x"), ex.Col("y")))
    elif kind == "in":
        vals = tuple(draw(st.lists(
            st.integers(-2 ** 63, 2 ** 63 - 1) | st.sampled_from(
                [0, 1, -1, 300, 2 ** 32]), min_size=1, max_size=5))
            if draw(st.booleans()) else
            draw(st.lists(st.floats(-1e6, 1e6) | st.sampled_from(
                [0.1, np.nan, 2.0]), min_size=1, max_size=5)))
        trees = rex.In(rex.Col("x"), vals), ex.In(ex.Col("x"), vals)
    else:
        c = draw(_CONST)
        trees = rex.Cmp(op, rex.Col("x"), c), ex.Cmp(op, ex.Col("x"), c)
    return trees[0], trees[1], cols


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(predicates())
def test_comparisons_follow_numpy_bitwise(case):
    rtree, tree, cols = case
    tcols = to_torch(cols)
    names = sorted(cols)
    try:
        with np.errstate(all="ignore"):
            want = rex.compile_expr(rtree)(cols)
    except OverflowError:  # numpy refuses the constant: so must the port
        with pytest.raises(OverflowError):
            ex.compile_expr(tree)(tcols)
        with pytest.raises(OverflowError):
            compile_predicate(tree, {c: tcols[c].dtype for c in names})
        return
    np.testing.assert_array_equal(ex.compile_expr(tree)(tcols).numpy(), want)
    prog = compile_predicate(tree, {c: tcols[c].dtype for c in names})
    words = pb.predicate_bitmap(prog, [tcols[c] for c in prog.columns])
    np.testing.assert_array_equal(
        ref.unpack_bitmap(words, len(want)).numpy(), want)


def test_pinned_comparisons():
    """The cases numpy 2.0.2 decides in its own way: out-of-range Python
    ints, uint64 against signed values (exactly, not through float64),
    float16 against a constant rounded to float16."""
    u8 = torch.tensor([0, 5, 255], dtype=torch.uint8)
    u64 = torch.from_numpy(np.uint64([2 ** 53 + 1, 2 ** 63 + 1]))
    i64 = torch.tensor([2 ** 53, -1])
    f16 = torch.tensor([0.1, 0.2], dtype=torch.float16)
    run = lambda e, **c: ex.compile_expr(e)(c).tolist()  # noqa: E731
    x, y = ex.Col("x"), ex.Col("y")
    assert run(x < 300, x=u8) == [True] * 3
    assert run(x.eq(-1), x=u8) == [False] * 3
    assert run(ex.Cmp("==", x, y), x=u64, y=i64) == [False, False]
    assert run(ex.Cmp("<", x, y), x=u64, y=i64) == [False, False]
    assert run(x.eq(0.1), x=f16) == [True, False]
    # a bool column meets a Python int in int64, and numpy refuses 2**63
    b = np.array([False, True])
    with pytest.raises(OverflowError):
        rex.compile_expr(rex.Col("x") <= 2 ** 63)({"x": b})
    with pytest.raises(OverflowError):
        run(x <= 2 ** 63, x=torch.from_numpy(b))
    assert run(x <= -1, x=torch.from_numpy(b)) == [False, False]


# ------------------------------------ the plain kernels, every dtype
def _values(dtype, n, seed):
    rng = np.random.default_rng(seed)
    np_t = np.dtype(NP_OF[dtype])
    if np_t.kind == "b":
        return rng.integers(0, 2, n).astype(bool)
    if np_t.kind in "iu":
        info = np.iinfo(np_t)
        return rng.integers(max(info.min, -50), min(info.max, 200), n,
                            dtype=np_t, endpoint=True)
    return (rng.standard_normal(n) * 50).astype(np_t)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_plain_kernels_take_every_dtype(dtype):
    """Each kernel's plain version on a column of ``dtype``: the
    predicate's words, the sums and counts over it, the gathered rows, the
    targets of its keys, against ``repro.queryproc``'s numpy operators."""
    n = 301
    v = _values(dtype, n, 1)
    g = np.random.default_rng(2).integers(0, 7, n).astype(np.int32)
    tab = {"v": v, "g": g}
    tv, tg = torch.from_numpy(v), torch.from_numpy(g)
    pred_r = (rex.Col("v") > 3) | rex.Col("v").isin((0, 1, 7))
    pred_t = (ex.Col("v") > 3) | ex.Col("v").isin((0, 1, 7))
    keep = rex.evaluate(pred_r, RTable(tab))
    prog = compile_predicate(pred_t, {"v": dtype})
    words = pb.predicate_bitmap(prog, [tv])
    want_words = rops.selection_bitmap(RTable(tab), pred_r)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want_words)
    # fused_scan_agg and grouped_agg: f64 sums of the stored values
    kept = RTable(tab).filter(keep)
    want = rops.grouped_agg(kept, ["g"], {"s": ("sum", "v"),
                                          "c": ("count", "")})
    sums, counts = fsa.fused_scan_agg(prog, [tv], tg, [tv], 7)
    present = want.cols["g"]
    np.testing.assert_array_equal(sums[0].numpy()[present], want.cols["s"])
    np.testing.assert_array_equal(counts.numpy()[present], want.cols["c"])
    want = rops.grouped_agg(RTable(tab), ["g"], {"s": ("sum", "v")})
    s2, _ = ga.grouped_agg(tg, tv, 7)
    np.testing.assert_array_equal(s2.numpy()[want.cols["g"]], want.cols["s"])
    # bitmap_apply: the kept rows, at the column's width
    masked, count = ba.bitmap_apply(words, tv)
    got_rows = masked.numpy()[keep]
    np.testing.assert_array_equal(
        got_rows, rops.apply_bitmap(RTable(tab), want_words).cols["v"])
    assert got_rows.dtype == v.dtype and int(count) == int(keep.sum())
    assert not masked.numpy()[~keep].view(np.uint8).any()
    if dtype.is_floating_point:
        return
    # hash_partition and fused_scan_shuffle over keys of this dtype
    pids, hist = hp.hash_partition(tv, 5)
    want_pids = rops.hash_partition_ids(v, 5)
    np.testing.assert_array_equal(pids.numpy(), want_pids)
    np.testing.assert_array_equal(hist.numpy(), np.bincount(want_pids,
                                                            minlength=5))
    w2, p2, h2 = fss.fused_scan_shuffle(prog, [tv], tv, 5)
    np.testing.assert_array_equal(w2.numpy().view(np.uint32), want_words)
    np.testing.assert_array_equal(p2.numpy(), want_pids)
    np.testing.assert_array_equal(h2.numpy(), np.bincount(want_pids[keep],
                                                          minlength=5))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_operators_take_every_dtype(dtype):
    """Group-by keys, min/max, keyless sums and means, sort, top-k, joins
    and semi-joins on a column of ``dtype``."""
    n = 200
    v = _values(dtype, n, 3)
    w = _values(dtype, 50, 4)
    if dtype.is_floating_point:
        v[::17] = np.nan
    tab = {"v": v, "x": np.arange(n, dtype=np.float64)}
    t, rt = ColumnTable(to_torch(tab)), RTable(tab)
    for fn in ("sum", "mean", "min", "max", "count"):
        agg = {"o": (fn, "v")}
        assert_same_table(ops.grouped_agg(t, [], agg),
                          rops.grouped_agg(rt, [], agg),
                          exact=not dtype.is_floating_point)
    # grouped by the column: each NaN is a group of its own, as numpy's
    # unique of a record array makes it, but numpy orders those groups by
    # an unstable sort, so they compare as a row multiset
    agg = {"n": ("count", ""), "s": ("sum", "x"), "lo": ("min", "x")}
    got, want = ops.grouped_agg(t, ["v"], agg), rops.grouped_agg(rt, ["v"],
                                                                 agg)
    if dtype.is_floating_point:
        nan = [np.isnan(np.asarray(x.cols["v"])) for x in (
            RTable(got.to_numpy()), want)]
        rows = [np.stack([np.asarray(x.cols[c])[m] for c in ("n", "s")], 1)
                for x, m in zip((RTable(got.to_numpy()), want), nan)]
        np.testing.assert_array_equal(*(r[np.lexsort(r.T)] for r in rows))
        got = ColumnTable({c: v[~torch.from_numpy(nan[0])]
                           for c, v in got.cols.items()})
        want = RTable({c: np.asarray(v)[~nan[1]]
                       for c, v in want.cols.items()})
    assert_same_table(got, want)
    agg = {"lo": ("min", "v"), "hi": ("max", "v")}
    tab2 = {"g": (np.arange(n) % 3).astype(np.int32), "v": v}
    assert_same_table(ops.grouped_agg(ColumnTable(to_torch(tab2)), ["g"],
                                      agg),
                      rops.grouped_agg(RTable(tab2), ["g"], agg))
    assert_same_table(ops.sort_table(t, ["v", "x"]),
                      rops.sort_table(rt, ["v", "x"]))
    ties = len(np.unique(v)) < n
    for asc in (True, False):
        if dtype == torch.bool and not asc:  # numpy has no -v of a bool
            with pytest.raises(TypeError):
                rops.top_k(rt, "v", 10, asc)
            with pytest.raises(TypeError):
                ops.top_k(t, "v", 10, asc)
            continue
        got = ops.top_k(t, "v", 10, asc)
        want = rops.top_k(rt, "v", 10, asc)
        if ties:  # argpartition orders ties at the k-th row freely
            np.testing.assert_array_equal(np.sort(got.cols["v"].numpy()),
                                          np.sort(want.cols["v"]))
        else:
            assert_same_table(got, want)
    right = {"v": w, "y": np.arange(50, dtype=np.int64)}
    assert_same_table(ops.hash_join(t, ColumnTable(to_torch(right)), "v", "v"),
                      rops.hash_join(rt, RTable(right), "v", "v"))
    np.testing.assert_array_equal(
        ops.isin(torch.from_numpy(v), torch.from_numpy(w)).numpy(),
        np.isin(v, w))


# ---------------------------- TPC-H at its narrowest widths, end to end
@pytest.fixture(scope="module")
def narrow():
    tables = narrow_tables(SF, SEED)
    return (catalog_from_arrays(tables, NODES, RPP, device="cpu"),
            ref_catalog(tables, NODES, RPP))


def _assert_run(got, want):
    g = got.result.to_numpy()
    assert list(g) == list(want.result.cols)
    assert [v.dtype for v in g.values()] == \
        [np.asarray(v).dtype for v in want.result.cols.values()]
    assert reng.results_equal(RTable(g), want.result)
    assert got.real_net_bytes == want.real_net_bytes
    assert got.sim.decisions() == want.sim.decisions()
    assert (got.n_admitted, got.n_pushed_back) == \
        (want.n_admitted, want.n_pushed_back)


def test_the_narrow_catalog_keeps_its_widths(narrow):
    cat, rcat = narrow
    for name, parts in cat.tables.items():
        for p, rp in zip(parts, rcat.partitions_of(name)):
            for c, v in p.data.cols.items():
                assert v.numpy().dtype == rp.data.cols[c].dtype
    assert cat.tables["lineitem"][0].data.cols["l_shipmode"].dtype == \
        torch.uint8


@pytest.mark.parametrize("power", POWERS)
@pytest.mark.parametrize("mode", engine.MODES)
@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_narrow_query_matches_reference(qid, mode, power, narrow):
    cat, rcat = narrow
    rmetrics.set_metrics(rmetrics.Metrics())
    tmetrics.set_metrics(tmetrics.Metrics())
    want = reng.run_query(rqueries.build_query(qid), rcat, reng.EngineConfig(
        res=RResources(storage_power=power), mode=mode,
        measured_feedback=False))
    with NoWideKernels():
        got = engine.run_query(queries.build_query(qid), cat,
                               engine.EngineConfig(
                                   res=StorageResources(storage_power=power),
                                   mode=mode, device="cpu"))
    _assert_run(got, want)


@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_narrow_costed_query_matches_reference(qid, narrow):
    cat, rcat = narrow
    rmetrics.set_metrics(rmetrics.Metrics())
    tmetrics.set_metrics(tmetrics.Metrics())
    want = reng.compile_and_run(qid, rcat, reng.EngineConfig(
        mode="adaptive", measured_feedback=False), cost_based=True)
    with NoWideKernels():
        got = engine.compile_and_run(qid, cat, engine.EngineConfig(
            mode="adaptive", device="cpu"), cost_based=True)
    _assert_run(got, want)


@pytest.mark.parametrize("qid", ("Q4", "Q12", "Q19", "Q22"))
def test_narrow_hand_built_query_matches_reference(qid, narrow):
    cat, rcat = narrow
    want = reng.run_query(rqueries.build_query_legacy(qid), rcat,
                          reng.EngineConfig(measured_feedback=False))
    with NoWideKernels():
        got = engine.run_query(queries.build_query_legacy(qid), cat,
                               engine.EngineConfig(device="cpu"))
    _assert_run(got, want)


def test_narrow_tables_cross_the_process_tier(narrow):
    """A narrow query on the process tier: its workers ship uint16/32/64
    and the other narrow columns back (mismatch 9, end to end)."""
    cat, rcat = narrow
    pool = W.WorkerPool(cat, pd_slots=1)
    try:
        for qid in ("Q3", "Q18"):
            want = reng.run_query(rqueries.build_query(qid), rcat,
                                  reng.EngineConfig(mode="eager",
                                                    measured_feedback=False))
            got = engine.run_query(queries.build_query(qid), cat,
                                   engine.EngineConfig(mode="eager",
                                                       device="cpu",
                                                       worker_pool=pool))
            _assert_run(got, want)
    finally:
        pool.close()
