"""The port's kernel ops (plain versions, CPU) against the JAX package's.

``repro_torch.kernels.ops`` on CPU tensors runs each kernel's plain torch
version; ``repro.kernels.ops`` runs the Pallas kernels in interpret mode
with ``block=1024``, as ``tests/test_kernels.py`` does. Inputs are seeded
numpy arrays handed to both. Words and counts must match bitwise; f32 sums
are held to the JAX tests' own tolerance, ``rtol=1e-4, atol=1e-2``.

The second half holds the postfix predicate program (what the CUDA kernels
interpret, ``repro_torch.kernels.program``) against ``compile_expr``, the
port's and the numpy engine's, on every predicate of the ported queries and
on constants one ulp either side of stored values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.engine  # noqa: F401  (before repro.queryproc.queries)
from repro.kernels import ops as jops
from repro.queryproc import expressions as rex
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels.program import MAX_OPS, compile_program, program_for
from repro_torch.queryproc import expressions as tex
from repro_torch.queryproc import queries as tqueries

ROWS = (1, 31, 32, 33, 1024 + 5, 3 * 1024)
BLOCK = 1024
GROUPS = 37


def _inputs(R, seed=0):
    rng = np.random.default_rng(seed + R)
    return {"q": rng.uniform(0, 50, R).astype(np.float32),
            "r": rng.uniform(0, 50, R).astype(np.float32),
            "a": rng.integers(0, 50, R).astype(np.int32)}


def _expr(E):
    C = E.Col
    return (((C("q") <= 24.5) & ((C("a") > 5) | C("a").eq(7)))
            | (C("q") < C("r")) & C("a").isin((1, 3, 40)))


def _torch(cols):
    return {k: torch.from_numpy(v) for k, v in cols.items()}


def _jax(cols):
    return {k: jnp.asarray(v) for k, v in cols.items()}


@pytest.mark.parametrize("R", ROWS)
def test_predicate_bitmap_matches_jax(R):
    cols = _inputs(R)
    words = kops.predicate_bitmap(_torch(cols), _expr(tex))
    want = jops.predicate_bitmap(_jax(cols),
                                 jops.compile_predicate(_expr(rex)),
                                 block=BLOCK)
    assert words.dtype == torch.int32 and words.shape == (-(-R // 32),)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("with_predicate", (True, False))
@pytest.mark.parametrize("R", ROWS)
def test_fused_scan_agg_matches_jax(R, with_predicate):
    cols = _inputs(R)
    rng = np.random.default_rng(R)
    ids = rng.integers(0, GROUPS, R).astype(np.int32)
    vals = rng.uniform(0, 10, R).astype(np.float32)
    sums, counts = kops.fused_scan_agg(
        _torch(cols), _expr(tex) if with_predicate else None,
        torch.from_numpy(ids), torch.from_numpy(vals), GROUPS)
    js, jc = jops.fused_scan_agg(
        _jax(cols) if with_predicate else {},
        jops.compile_predicate(_expr(rex)) if with_predicate else None,
        jnp.asarray(ids), jnp.asarray(vals), GROUPS, block=BLOCK)
    assert sums.dtype == torch.float32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(js),
                               rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("R", ROWS)
def test_grouped_agg_matches_jax(R):
    rng = np.random.default_rng(R)
    ids = rng.integers(0, GROUPS, R).astype(np.int32)
    vals = rng.normal(size=R).astype(np.float32)
    sums, counts = kops.grouped_agg(torch.from_numpy(ids),
                                    torch.from_numpy(vals), GROUPS)
    js, jc = jops.grouped_agg(jnp.asarray(ids), jnp.asarray(vals), GROUPS,
                              block=BLOCK)
    assert sums.dtype == torch.float32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(js),
                               rtol=1e-4, atol=1e-2)


# ------------------------------------------------------ postfix program
@pytest.fixture(scope="module")
def tables():
    return {name: t.cols for name, t in
            rtpch.generate_tables(sf=0.5, seed=0).items()}


def _masks(t_expr, r_expr, cols):
    """(program interpreter, port compile_expr, numpy compile_expr)."""
    tcols = _torch(cols)
    prog = program_for(t_expr, tcols)
    return (ref.run_program(prog, [tcols[c] for c in prog.columns]).numpy(),
            tex.compile_expr(t_expr)(tcols).numpy(),
            rex.compile_expr(r_expr)(cols))


@pytest.mark.parametrize("qid", tqueries.QUERY_IDS)
def test_program_matches_compile_expr_on_query_predicates(qid, tables):
    tq, rq = tqueries.build_query(qid), rqueries.build_query_legacy(qid)
    n_pred = 0
    for table, plan in tq.plans.items():
        if plan.predicate is None:
            continue
        n_pred += 1
        prog_mask, torch_mask, np_mask = _masks(
            plan.predicate, rq.plans[table].predicate, tables[table])
        np.testing.assert_array_equal(prog_mask, np_mask)
        np.testing.assert_array_equal(torch_mask, np_mask)
    assert n_pred > 0


def _edge_cases():
    """(port expr, reference expr) pairs at the comparison type's edges."""
    d = 0.05  # a stored l_discount value (integers(0, 11) / 100)
    up, down = float(np.nextafter(d, 1.0)), float(np.nextafter(d, 0.0))
    f32 = float(np.float32(0.3))
    out = []
    for E in (tex, rex):
        C = E.Col
        out.append([
            C("d") <= up, C("d") < up, C("d") >= down, C("d") > down,
            C("d").eq(d), C("d").between(down, up), C("d") < C("e"),
            C("d").isin((d, up)),
            C("x") <= f32, C("x") < 0.3, C("x").eq(f32),   # f32 column
            C("a") < 24.5, C("a") <= 24, C("a").isin((1.0, 2.5)),
            C("b") >= -2, C("a") < C("b"), C("x") < C("d"),
            (C("a") > 3) | (C("d") > up),
        ])
    return list(zip(*out))


@pytest.mark.parametrize("case", range(18))
def test_program_edge_constants_match_numpy(case):
    t_expr, r_expr = _edge_cases()[case]
    rng = np.random.default_rng(case)
    R = 4000
    x = rng.uniform(0, 1, R).astype(np.float32)
    x[:50] = np.float32(0.3)
    x[50:100] = np.nextafter(np.float32(0.3), np.float32(1))
    cols = {"d": rng.integers(0, 11, R).astype(np.float64) / 100.0,
            "a": rng.integers(0, 50, R).astype(np.int32),
            "b": rng.integers(-5, 50, R).astype(np.int64),
            "x": x}
    cols["e"] = cols["d"][rng.permutation(R)]
    prog_mask, torch_mask, np_mask = _masks(t_expr, r_expr, cols)
    assert 0 < np_mask.sum() < R  # the case selects some rows, not all
    np.testing.assert_array_equal(prog_mask, np_mask)
    np.testing.assert_array_equal(torch_mask, np_mask)


def test_program_rejects_what_the_kernel_cannot_hold():
    C = tex.Col
    e = C("a") < 0
    for i in range(1, MAX_OPS):
        e = e | (C("a") < i)
    with pytest.raises(ValueError):
        compile_program(e, {"a": torch.int32})
