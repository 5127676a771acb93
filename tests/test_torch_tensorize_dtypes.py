"""The residual's tensor backend over the whole column domain, against the
JAX package's, on the CPU.

``repro_torch.compiler.tensorize`` on columns of every dtype of
``queryproc.table.NP_OF`` at their stored widths, held to
``repro.compiler.tensorize`` (through the ``x64`` shim of
``tests/test_torch_tensorize.py``, set for each test and taken away
after). The port runs under ``NoWideKernels``, which refuses every torch
call on a uint16/32/64 tensor that torch's CUDA build lacks, so a stage
program that passes here routes around those gaps on the card too.

- TPC-H stored at its narrowest widths (``narrow_tables``: uint8 codes,
  int16 dates, a uint16 quantity, uint32 keys): all 15 compiled residuals,
  observe, cold and warm, against the reference's ``tensorize`` (tables
  with their dtypes, the port's in its interpreter's column order,
  ``TensorRun`` fields, ``residual.*`` counters, lowerings); Q3 through
  ``run_query``, which raised ``"max_all" not implemented for 'UInt32'``
  before the key ranges went through ``sort_key``; and ``run_query`` with
  ``residual="tensor"`` in every mode at powers 1.0 and 0.1 against the
  reference's runs (results, dtypes, real bytes, decisions).
- One small residual of each kind on a column of each dtype: keyed
  aggregates on the code and the lex path, min and max, keyless
  reductions, a LUT join and semi-join, a sorted join (float keys, and
  integer keys whose domain passes the LUT cap), an anti semi-join, top-k
  and sorts, each held to the reference's ``tensorize`` with
  ``fell_back`` and the ``residual.*`` counters. uint64 keys from 2**63 on
  make both backends' int64 codes and LUTs overflow: both replay the
  interpreter and count ``residual.errors``. Where the reference's own
  lowering raises (min/max of a bool or uint64 column on the code and
  keyless paths: ``jnp.iinfo(bool)`` and a uint64 sentinel past int64),
  the port's result is still the reference's, and only the port stays on
  the tensor path.

About 35 s on one worker.
"""
import numpy as np
import pytest
import torch

import jax
import jax.experimental

import repro.core.engine as reng  # before repro.queryproc.queries
from repro.compiler import compile as rcompile
from repro.compiler import ir as rir
from repro.compiler import tensorize as rtz
from repro.core.cost import StorageResources as RResources
from repro.obs import metrics as rmetrics
from repro.queryproc import queries as rqueries
from repro.queryproc.table import ColumnTable as RTable
from repro_torch import compiler
from repro_torch.compiler import interpreter, ir
from repro_torch.compiler import tensorize as tz
from repro_torch.core import engine
from repro_torch.core.cost import StorageResources
from repro_torch.obs import metrics
from repro_torch.queryproc import queries
from repro_torch.queryproc.table import NP_OF, ColumnTable
from repro_torch.storage.catalog import catalog_from_arrays
from test_torch_dtypes import (NODES, RPP, SEED, SF, NoWideKernels,
                               narrow_tables, ref_catalog)
from test_torch_tensorize import (assert_same_table, lowerings, merged_for,
                                  residual_counters, rmerged_for, run_fields)

DTYPES = tuple(NP_OF)
IDS = [str(d)[6:] for d in DTYPES]
POWERS = (1.0, 0.1)
STEPS = ("observe", "cold", "warm")


@pytest.fixture(autouse=True)
def x64(monkeypatch):
    """The reference's ``enable_x64`` import under JAX 0.9, for this test
    only."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@pytest.fixture(autouse=True)
def registries():
    """(port registry, reference registry), fresh for every test."""
    prev = metrics.set_metrics(metrics.Metrics())
    rprev = rmetrics.set_metrics(rmetrics.Metrics())
    yield metrics.get_metrics(), rmetrics.get_metrics()
    metrics.set_metrics(prev)
    rmetrics.set_metrics(rprev)


# (sf, nodes, lineitem rows a partition): the catalog of
# ``test_torch_dtypes``, and one where every query returns rows (five of
# the fifteen return none at sf=0.01)
SCALES = {"sf0.01": (SF, NODES, RPP), "sf0.2": (0.2, 2, 4_000)}
_CATALOGS = {}


def narrow_catalogs(scale):
    """(port catalog, reference catalog) of TPC-H stored narrow."""
    if scale not in _CATALOGS:
        sf, nodes, rpp = SCALES[scale]
        tables = narrow_tables(sf, SEED)
        _CATALOGS[scale] = (
            catalog_from_arrays(tables, nodes, rpp, device="cpu"),
            ref_catalog(tables, nodes, rpp))
    return _CATALOGS[scale]


@pytest.fixture(scope="module")
def narrow():
    return narrow_catalogs("sf0.01")


def guarded(fn, *args, **kwargs):
    with NoWideKernels():
        return fn(*args, **kwargs)


# ------------------------------------- TPC-H stored narrow, all 15 queries
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("qid", compiler.QUERY_IDS)
def test_narrow_tensor_residual_matches_the_reference(registries, qid,
                                                      scale):
    """observe -> cold -> warm on the narrow merged tables: each run's
    table (dtypes by name, rows), ``TensorRun`` fields, the counters and
    the lowerings are the reference's; the port's table is its
    interpreter's, in its column order and (where it has rows: an empty
    keyed sum is int64 in both interpreters, f64 in both tensor backends)
    its dtypes, and nothing falls back."""
    cat, rcat = narrow_catalogs(scale)
    cq = compiler.compile_query_detailed(qid)
    rq = rcompile.compile_query_detailed(qid)
    merged, rmerged = merged_for(cq, cat), rmerged_for(rq, rcat)
    oracle = guarded(interpreter.run, cq.residual, merged)
    for step in STEPS:
        got = guarded(tz.execute, cq.residual, merged)
        want = rtz.execute(rq.residual, rmerged)
        assert_same_table(got.table, want.table, (qid, step))
        assert run_fields(got) == run_fields(want), (qid, step)
        assert not got.fell_back, (qid, step)
        assert list(got.table.cols) == list(oracle.cols), (qid, step)
        assert len(oracle) == 0 or [v.dtype for v in got.table.cols.values()] \
            == [v.dtype for v in oracle.cols.values()], (qid, step)
        assert engine.results_equal(oracle, got.table), (qid, step)
    assert got.jit_misses == 0 and got.jit_hits >= 1
    m, rm = registries
    assert residual_counters(m) == residual_counters(rm), qid
    assert tz.lowerings(cq.residual) == \
        lowerings(rtz._artifact(rq.residual)), qid


def test_q3_on_narrow_keys_no_longer_raises(narrow, registries):
    """The repro of the fault this pins: Q3 compiled once and run eager
    with ``residual="tensor"`` on the narrow catalog raised
    ``NotImplementedError: "max_all" not implemented for 'UInt32'`` from
    the observe pass. Now the observe and the tensor run give the
    reference's rows, and the tensor run stays on the tensor path."""
    cat, rcat = narrow
    q, rq = queries.build_query("Q3"), rqueries.build_query("Q3")
    cfg = engine.EngineConfig(mode="eager", residual="tensor", device="cpu")
    rcfg = reng.EngineConfig(mode="eager", residual="tensor",
                             measured_feedback=False)
    for observed in (True, False):
        got = guarded(engine.run_query, q, cat, cfg)
        want = reng.run_query(rq, rcat, rcfg)
        assert got.residual_jit == want.residual_jit
        assert got.residual_jit["observed"] is observed
        assert not got.residual_jit["fell_back"]
        assert_same_table(got.result, want.result)
    assert got.result.cols["l_orderkey"].dtype == torch.uint32
    m, rm = registries
    assert residual_counters(m) == residual_counters(rm)
    assert residual_counters(m).get("residual.errors", 0) == 0


@pytest.mark.parametrize("mode", engine.MODES)
@pytest.mark.parametrize("qid", queries.QUERY_IDS)
def test_narrow_engine_runs_match_the_reference(narrow, registries, qid,
                                                mode):
    """``run_query`` with ``residual="tensor"``, each query compiled once:
    the observe pass and the tensor runs at powers 1.0 and 0.1 give the
    reference's results (dtypes by name), real bytes, decisions, admitted
    and pushed-back counts and ``residual_jit``; the tensor runs keep the
    observe pass's (the interpreter's) column order."""
    cat, rcat = narrow
    q, rq = queries.build_query(qid), rqueries.build_query(qid)
    first = None
    for power in (POWERS[0], *POWERS):
        got = guarded(engine.run_query, q, cat, engine.EngineConfig(
            res=StorageResources(storage_power=power), mode=mode,
            residual="tensor", device="cpu"))
        want = reng.run_query(rq, rcat, reng.EngineConfig(
            res=RResources(storage_power=power), mode=mode,
            residual="tensor", measured_feedback=False))
        label = (qid, mode, power)
        assert_same_table(got.result, want.result, label)
        first = first or list(got.result.cols)
        assert list(got.result.cols) == first, label
        assert got.real_net_bytes == want.real_net_bytes, label
        assert got.sim.decisions() == want.sim.decisions(), label
        assert (got.n_admitted, got.n_pushed_back) == \
            (want.n_admitted, want.n_pushed_back), label
        assert got.residual_backend == want.residual_backend == "tensor"
        assert got.residual_jit == want.residual_jit, label
        assert not got.residual_jit["fell_back"], label
    m, rm = registries
    assert residual_counters(m) == residual_counters(rm)


# ------------------------------------------ one residual a kind and dtype
N, N_RIGHT = 100, 60


def _column(dtype, n, seed, distinct=False, big=False):
    """``n`` values of ``dtype`` from ``seed``: small ones around 0 (ties
    among them), ``distinct`` ones, or (``big``) uint64 ones from 2**63."""
    rng = np.random.default_rng(seed)
    np_t = np.dtype(NP_OF[dtype])
    if np_t.kind == "b":
        return rng.integers(0, 2, n).astype(bool)
    if big:
        return (np.uint64(2 ** 63) + rng.permutation(n).astype(np.uint64)
                * np.uint64(3))
    if distinct:
        lo = 0 if np_t.kind == "u" else -n // 2
        return rng.permutation(np.arange(lo, lo + n)).astype(np_t)
    if np_t.kind in "iu":
        info = np.iinfo(np_t)
        return rng.integers(max(info.min, -50), min(info.max, 200), n,
                            dtype=np_t, endpoint=True)
    return (rng.standard_normal(n) * 50).astype(np_t)


def _tables(dtype, big=False, wide_domain=False):
    """``t``: keys ``k``, values ``v`` and distinct scores ``u`` of
    ``dtype``, a float64 row number ``x`` and an int32 group ``g``; ``r``:
    unique keys ``rk`` (spanning more than the LUT cap when
    ``wide_domain``), their copy ``w`` and an int64 ``y``."""
    k = _column(dtype, N, 1, big=big)
    rk = np.unique(_column(dtype, N_RIGHT, 3, big=big))
    if wide_domain:
        rk = np.unique(np.concatenate([rk, np.asarray(
            [rk.max() + np.asarray(1 << 24).astype(rk.dtype)])]))
    t = {"k": k, "v": _column(dtype, N, 2, big=big),
         "u": _column(dtype, N, 4, distinct=True, big=big),
         "x": np.arange(N, dtype=np.float64),
         "g": (np.arange(N) % 3).astype(np.int32)}
    r = {"rk": rk, "w": rk.copy(), "y": np.arange(len(rk), dtype=np.int64)}
    return ({"t": ColumnTable.from_numpy(t, "cpu"),
             "r": ColumnTable.from_numpy(r, "cpu")},
            {"t": RTable(t), "r": RTable(r)})


def _residuals(case, dtype):
    """(port residual, reference residual) of one kind."""
    bool_dt = dtype == torch.bool

    def build(m):
        t, r = m.Merged("t"), m.Merged("r")
        return {
            "code": m.Aggregate(t, ("k",), (
                ("s", "sum", "x"), ("c", "count", "x"), ("m", "mean", "v"),
                ("sv", "sum", "v"))),
            "code_minmax": m.Aggregate(t, ("g",), (
                ("lo", "min", "v"), ("hi", "max", "v"))),
            "lex": m.Aggregate(t, ("k", "x"), (
                ("c", "count", "v"), ("sv", "sum", "v"), ("lo", "min", "v"),
                ("hi", "max", "v"))),
            "keyless": m.Aggregate(t, (), (
                ("sv", "sum", "v"), ("m", "mean", "v"), ("c", "count", "v"))),
            "keyless_minmax": m.Aggregate(t, (), (
                ("lo", "min", "v"), ("hi", "max", "v"))),
            "join": m.Join(t, r, "k", "rk"),
            "semi": m.SemiJoin(t, r, "k", "rk", False),
            "anti": m.SemiJoin(t, r, "k", "rk", True),
            "topk": m.TopK(t, "x" if bool_dt else "u", 7),
            "topk_asc": m.TopK(t, "x" if bool_dt else "u", 7,
                               ascending=True),
            "sort": m.Sort(t, ("v", "x")),
            "sort_desc": m.Sort(t, ("k", "x"), ascending=False),
        }[case]
    return build(ir), build(rir)


CASES = ("code", "code_minmax", "lex", "keyless", "keyless_minmax", "join",
         "semi", "anti", "topk", "topk_asc", "sort", "sort_desc")
# the reference's lowering raises here (``jnp.iinfo(bool)``; the uint64 min
# sentinel 2**64 - 1 passed as a weak int64): it replays its interpreter
REFERENCE_RAISES = {(torch.bool, "code_minmax"), (torch.bool,
                                                  "keyless_minmax"),
                    (torch.uint64, "code_minmax"),
                    (torch.uint64, "keyless_minmax")}
ORDERED = ("topk", "topk_asc", "sort", "sort_desc")


def _hold(res, rres, merged, rmerged, registries, label, ordered=False,
          reference_raises=False):
    """observe -> cold -> warm on both sides: tables, ``TensorRun`` fields
    and counters (rows in order for ``ordered`` residuals, whose tensor
    runs order ties alike); with ``reference_raises`` the reference falls
    back with an error from its cold run on, and the port does not."""
    oracle = guarded(interpreter.run, res, merged)
    for step in STEPS:
        got = guarded(tz.execute, res, merged)
        want = rtz.execute(rres, rmerged)
        assert_same_table(got.table, want.table, (label, step))
        assert list(got.table.cols) == list(oracle.cols), (label, step)
        assert not got.fell_back, (label, step)
        if reference_raises and step != "observe":
            assert want.fell_back, (label, step)
        else:
            assert run_fields(got) == run_fields(want), (label, step)
        if ordered and step != "observe":
            g = got.table.to_numpy()
            for c in g:
                np.testing.assert_array_equal(g[c], np.asarray(
                    want.table.cols[c]), err_msg=f"{label} {step} {c}")
    m, rm = registries
    got_c, want_c = residual_counters(m), residual_counters(rm)
    if reference_raises:
        assert (want_c["residual.errors"], want_c["residual.fallbacks"]) == \
            (1, 2), label
        assert "residual.errors" not in got_c and \
            "residual.fallbacks" not in got_c, label
    else:
        assert got_c == want_c, label
        assert tz.lowerings(res) == lowerings(rtz._artifact(rres)), label
    return got


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_small_residuals_on_every_dtype(registries, dtype, case):
    res, rres = _residuals(case, dtype)
    merged, rmerged = _tables(dtype)
    got = _hold(res, rres, merged, rmerged, registries, (dtype, case),
                ordered=case in ORDERED,
                reference_raises=(dtype, case) in REFERENCE_RAISES)
    aggs, joins = tz.lowerings(res)
    if case in ("code", "code_minmax"):
        assert aggs[0][0] == ("code" if case == "code_minmax"
                              or not dtype.is_floating_point else "lex")
    if case == "lex":
        assert aggs == [("lex",)]
    if case in ("join", "semi", "anti"):
        assert joins[0][0] == ("sorted" if dtype.is_floating_point
                               else "lut")
    for c in ("k", "v", "u", "w", "lo", "hi"):
        if c in got.table.cols:
            assert got.table.cols[c].dtype == dtype, (case, c)


@pytest.mark.parametrize("dtype", [d for d in DTYPES if d.itemsize >= 4
                                   and not d.is_floating_point],
                         ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("anti", (False, True))
def test_integer_keys_past_the_lut_cap_take_the_sorted_probe(registries,
                                                             dtype, anti):
    merged, rmerged = _tables(dtype, wide_domain=True)
    res, rres = (
        (m.SemiJoin(m.Merged("t"), m.Merged("r"), "k", "rk", True) if anti
         else m.Join(m.Merged("t"), m.Merged("r"), "k", "rk"))
        for m in (ir, rir))
    _hold(res, rres, merged, rmerged, registries, (dtype, anti))
    assert tz.lowerings(res) == ([], [("sorted",)])


@pytest.mark.parametrize("case", ("code", "join", "lex", "sort"))
def test_uint64_keys_from_2_63(registries, case):
    """uint64 keys from 2**63 on: the code and LUT lowerings' int64
    offsets overflow on both sides (an error, which replays the
    interpreter and keeps the residual on it, counted in
    ``residual.errors``); the lex and sort lowerings order them right."""
    res, rres = _residuals(case, torch.uint64)
    merged, rmerged = _tables(torch.uint64, big=True)
    oracle = guarded(interpreter.run, res, merged)
    for step in STEPS:
        got = guarded(tz.execute, res, merged)
        want = rtz.execute(rres, rmerged)
        assert_same_table(got.table, want.table, (case, step))
        assert run_fields(got) == run_fields(want), (case, step)
        assert engine.results_equal(oracle, got.table), (case, step)
    overflows = case in ("code", "join")
    assert got.fell_back is overflows
    m, rm = registries
    assert residual_counters(m) == residual_counters(rm)
    assert residual_counters(m).get("residual.errors", 0) == int(overflows)
    assert tz.lowerings(res) == lowerings(rtz._artifact(rres))
