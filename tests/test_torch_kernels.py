"""The port's kernel ops (plain versions, CPU) against the JAX package's.

``repro_torch.kernels.ops`` on CPU tensors runs each kernel's plain torch
version; ``repro.kernels.ops`` runs the Pallas kernels in interpret mode
with ``block=1024``, as ``tests/test_kernels.py`` does. Inputs are seeded
numpy arrays handed to both. Words, pids, histograms, masked columns and
counts must match bitwise; f32 sums are held to the JAX tests' own
tolerance, ``rtol=1e-4, atol=1e-2``. Shuffle keys are int32 with negative
values, whose uint32 images pass 2**31; predicate operands are f32-exact,
since the JAX wrapper casts f64 columns to f32.

The second half holds the postfix predicate program (what the CUDA kernels
interpret, ``repro_torch.kernels.program``) against ``compile_expr``, the
port's and the numpy engine's, on every predicate of the ported queries and
on constants one ulp either side of stored values.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.engine  # noqa: F401  (before repro.queryproc.queries)
from repro.kernels import ops as jops
from repro.queryproc import expressions as rex
from repro.queryproc import operators as rops
from repro.queryproc import queries as rqueries
from repro.queryproc import tpch as rtpch
from repro_torch.kernels import bitmap_apply as ba
from repro_torch.kernels import fused_scan_agg as fsa
from repro_torch.kernels import grouped_agg as ga
from repro_torch.kernels import ops as kops
from repro_torch.kernels import predicate_bitmap as pb
from repro_torch.kernels import ref
from repro_torch.kernels.program import (MAX_CONSTS, MAX_OPS, Program,
                                         SplitProgram, compile_predicate,
                                         program_for)
from repro_torch.queryproc import expressions as tex
from repro_torch.queryproc import queries as tqueries

ROWS = (1, 31, 32, 33, 1024 + 5, 3 * 1024)
BLOCK = 1024
GROUPS = 37
TARGETS = (1, 4, 7)


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


@pytest.mark.parametrize("V", (0, 1, 4))
@pytest.mark.parametrize("with_predicate", (True, False))
@pytest.mark.parametrize("R", (1, 31, 33, 1024 + 5))
def test_fused_scan_agg_values_match_jax_column_by_column(R, with_predicate,
                                                          V):
    """The wrapper's V value columns in one call (its plain version on the
    CPU): sums row j against the JAX op over value column j, counts (also
    with no value column) against the JAX op's."""
    cols = _inputs(R)
    rng = np.random.default_rng(R + V)
    ids = rng.integers(0, GROUPS, R).astype(np.int32)
    vals = [rng.uniform(-10, 10, R).astype(np.float32 if j % 2 else np.float64)
            for j in range(V)]
    prog = program_for(_expr(tex), _torch(cols)) if with_predicate else None
    pcols = [_torch(cols)[c] for c in prog.columns] if prog else []
    sums, counts = fsa.fused_scan_agg(prog, pcols, torch.from_numpy(ids),
                                      [torch.from_numpy(v) for v in vals],
                                      GROUPS)
    assert sums.shape == (V, GROUPS) and sums.dtype == torch.float64
    assert counts.dtype == torch.int64

    def jax_op(v):
        return jops.fused_scan_agg(
            _jax(cols) if with_predicate else {},
            jops.compile_predicate(_expr(rex)) if with_predicate else None,
            jnp.asarray(ids), jnp.asarray(v), GROUPS, block=BLOCK)
    for j in range(V):
        js, jc = jax_op(vals[j].astype(np.float32))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
        np.testing.assert_allclose(sums[j].numpy(), np.asarray(js),
                                   rtol=1e-4, atol=1e-2)
    if V == 0:
        _, jc = jax_op(np.zeros(R, np.float32))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))


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


def _keys(R):
    rng = np.random.default_rng(R + 1)
    keys = rng.integers(-2 ** 31, 2 ** 31 - 1, R, dtype=np.int32)
    keys[:4] = np.asarray([-1, -2, 0, -(2 ** 31)], np.int32)[:R]
    return keys


@pytest.mark.parametrize("dtype", (np.int32, np.float32))
@pytest.mark.parametrize("R", ROWS)
def test_bitmap_apply_matches_jax(R, dtype):
    rng = np.random.default_rng(R)
    words = rops.pack_bitmap(rng.random(R) < 0.4)
    col = (rng.normal(size=R) * 1e3).astype(dtype)
    col[:2] = np.asarray([-0.0, 7], dtype)[:R]
    masked, count = kops.bitmap_apply(torch.from_numpy(words.view(np.int32)),
                                      torch.from_numpy(col))
    jm, jc = jops.bitmap_apply(jnp.asarray(words), jnp.asarray(col),
                               block=BLOCK)
    assert masked.numpy().dtype == dtype and count.dtype == torch.int32
    np.testing.assert_array_equal(masked.numpy().view(np.uint32),
                                  np.asarray(jm).view(np.uint32))
    assert int(count) == int(jc)


@pytest.mark.parametrize("seed", range(2))
def test_bitmap_apply_segments_match_jax_per_segment(seed):
    """The segmented wrapper (its plain version on the CPU) against the JAX
    op segment by segment: 6,000-row partitions (not 32-row aligned) with
    int32, int64, f32 and f64 columns, a partition of no rows, one whose
    words are all zero, and each partition's count from its first
    segment. The JAX op runs without 64-bit types, so an 8-byte column goes
    to it as its low and high 32-bit halves (the bits are what is
    compared)."""
    rng = np.random.default_rng(seed)

    def jax_apply(jw, col):
        if col.itemsize == 4:
            jm, jc = jops.bitmap_apply(jw, jnp.asarray(col), block=BLOCK)
            return np.asarray(jm).view(np.uint32), jc
        halves = col.view(np.uint32).reshape(-1, 2)
        out = [jops.bitmap_apply(jw, jnp.asarray(halves[:, h]), block=BLOCK)
               for h in (0, 1)]
        return (np.stack([np.asarray(m) for m, _ in out], 1).reshape(-1)
                .view(np.uint64), out[0][1])

    dtypes = (np.int32, np.int64, np.float32, np.float64)
    words, cols, part_of, want = [], [], [], []
    for p, (R, frac) in enumerate(((6000, 0.4), (0, 0.5), (6000, 0.0),
                                   (6000 - 17, 0.9))):
        packed = rops.pack_bitmap(rng.random(R) < frac)
        jw = jnp.asarray(packed)
        for k in range(2):
            dt = dtypes[(p + k + seed) % 4]
            col = (rng.normal(size=R) * 1e3).astype(dt)
            col[:2] = np.asarray([-0.0, 7], dt)[:R]
            words.append(torch.from_numpy(packed.view(np.int32)))
            cols.append(torch.from_numpy(col))
            part_of.append(p)
            want.append(jax_apply(jw, col) if R else (col, 0))
    outs, counts = ba.bitmap_apply_segments(words, cols, part_of)
    assert counts.dtype == torch.int64 and counts.shape == (4,)
    for i, (o, (jm, jc)) in enumerate(zip(outs, want)):
        assert o.dtype == cols[i].dtype and o.shape == cols[i].shape
        raw = {4: np.uint32, 8: np.uint64}[o.element_size()]
        np.testing.assert_array_equal(o.numpy().view(raw), jm.view(raw))
        if i % 2 == 0:  # a partition's first segment
            assert int(counts[part_of[i]]) == int(jc)
    assert int(counts[1]) == 0 and int(counts[2]) == 0


@pytest.mark.parametrize("P", TARGETS)
@pytest.mark.parametrize("R", ROWS)
def test_hash_partition_matches_jax(R, P):
    keys = _keys(R)
    pids, hist = kops.hash_partition(torch.from_numpy(keys), P)
    jp, jh = jops.hash_partition(jnp.asarray(keys), P, block=BLOCK)
    assert pids.dtype == torch.int32 and hist.dtype == torch.int32
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pids.numpy(), rops.hash_partition_ids(keys, P))


@pytest.mark.parametrize("with_predicate", (True, False))
@pytest.mark.parametrize("P", TARGETS)
@pytest.mark.parametrize("R", ROWS)
def test_fused_scan_shuffle_matches_jax(R, P, with_predicate):
    cols, keys = _inputs(R), _keys(R)
    words, pids, hist = kops.fused_scan_shuffle(
        _torch(cols), _expr(tex) if with_predicate else None,
        torch.from_numpy(keys), P)
    jw, jp, jh = jops.fused_scan_shuffle(
        _jax(cols), jops.compile_predicate(_expr(rex)) if with_predicate
        else None, jnp.asarray(keys), P, block=BLOCK)
    assert words.dtype == pids.dtype == hist.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jw))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))


def _and9_inputs(R):
    rng = np.random.default_rng(R + 9)
    return {f"c{i}": rng.integers(-1, 30, R).astype(np.int32)
            for i in range(9)}


def _and9(E):
    """Nine int32 columns, each ``>= 0``, ANDed: past the program's eight
    columns, so the port splits it into two programs."""
    e = E.Col("c0") >= 0
    for i in range(1, 9):
        e = e & (E.Col(f"c{i}") >= 0)
    return e


@pytest.mark.parametrize("R", ROWS)
def test_split_predicate_fused_scan_agg_matches_jax(R):
    cols = _and9_inputs(R)
    assert isinstance(program_for(_and9(tex), _torch(cols)), SplitProgram)
    rng = np.random.default_rng(R)
    ids = rng.integers(0, GROUPS, R).astype(np.int32)
    vals = rng.uniform(0, 10, R).astype(np.float32)
    sums, counts = kops.fused_scan_agg(_torch(cols), _and9(tex),
                                       torch.from_numpy(ids),
                                       torch.from_numpy(vals), GROUPS)
    js, jc = jops.fused_scan_agg(_jax(cols), jops.compile_predicate(
        _and9(rex)), jnp.asarray(ids), jnp.asarray(vals), GROUPS, block=BLOCK)
    assert sums.dtype == torch.float32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(js),
                               rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("P", TARGETS)
@pytest.mark.parametrize("R", ROWS)
def test_split_predicate_fused_scan_shuffle_matches_jax(R, P):
    cols, keys = _and9_inputs(R), _keys(R)
    words, pids, hist = kops.fused_scan_shuffle(
        _torch(cols), _and9(tex), torch.from_numpy(keys), P)
    jw, jp, jh = jops.fused_scan_shuffle(
        _jax(cols), jops.compile_predicate(_and9(rex)), jnp.asarray(keys), P,
        block=BLOCK)
    assert words.dtype == pids.dtype == hist.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jw))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))


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
    """Every pushed predicate of the hand-built and of the compiled query
    (Q18 pushes none)."""
    n_pred = n_ref = 0
    for tq, rq in ((tqueries.build_query_legacy(qid),
                    rqueries.build_query_legacy(qid)),
                   (tqueries.build_query(qid), rqueries.build_query(qid))):
        n_ref += sum(p.predicate is not None for p in rq.plans.values())
        for table, plan in tq.plans.items():
            if plan.predicate is None:
                continue
            n_pred += 1
            prog_mask, torch_mask, np_mask = _masks(
                plan.predicate, rq.plans[table].predicate, tables[table])
            np.testing.assert_array_equal(prog_mask, np_mask)
            np.testing.assert_array_equal(torch_mask, np_mask)
    assert n_pred == n_ref and (n_pred > 0 or qid == "Q18")


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
    """A predicate past the by-value limits is no one program: it splits
    into parts that each fit, a kernel wrapper refuses the split, and the
    split's words are the predicate's."""
    C = tex.Col
    e = C("a") < 0
    for i in range(1, MAX_OPS):
        e = e | (C("a") < i)
    split = compile_predicate(e, {"a": torch.int32})
    assert isinstance(split, SplitProgram)

    def parts(p):
        return ([p] if isinstance(p, Program)
                else parts(p.left) + parts(p.right))

    assert len(parts(split)) > 1
    assert all(p.n_ops <= MAX_OPS and len(p.fconst) <= MAX_CONSTS
               for p in parts(split))
    a = torch.arange(100, dtype=torch.int32)
    with pytest.raises(TypeError):
        pb.predicate_bitmap(split, [a])
    np.testing.assert_array_equal(
        ref.unpack_bitmap(pb.predicate_words(split, {"a": a}), 100).numpy(),
        np.arange(100) < MAX_OPS - 1)


# ---- grouped_agg's regime choice (the CUDA launches it plans run only on
# the card; here the plan's arithmetic is held, and each regime's split of
# rows and groups is replayed in numpy against np.bincount)
Q3_RESIDUAL = (316_000, 119_009)   # rows, groups at sf=1000 (the path)
SMS = 132                          # the H100's SMs


def _replay(p, ids, vals, G):
    """What the plan's launches compute, block by block, in numpy: rows go
    to blocks and groups to partials exactly as csrc/grouped_agg.cu cuts
    them; each partial must fit the shared memory the plan gives it."""
    R = len(ids)
    sums, counts = np.zeros(G), np.zeros(G, np.int64)
    valid = (ids >= 0) & (ids < G)
    if p.regime == "l2":  # every row adds into the outputs themselves
        return (np.bincount(ids[valid], weights=vals[valid], minlength=G),
                np.bincount(ids[valid], minlength=G))
    if p.regime == "smem":
        assert p.per * ga.PARTIAL_BYTES <= ga.SMEM_BLOCK
        assert p.ranges * p.per >= G > (p.ranges - 1) * p.per
        # warp tiles of 32 x 8 rows (32 x 16 without combining rounds),
        # grid-strided over the chunk's warps
        warps, tile = p.threads // 32, 32 * (8 if p.combine else 16)
        chunk_of = (np.arange(R) // tile) % (p.blocks * warps) // warps
        for c in range(p.blocks):
            for q in range(p.ranges):
                g0 = q * p.per
                m = valid & (chunk_of == c) & (ids >= g0) & (ids < g0 + p.per)
                counts += np.bincount(ids[m], minlength=G)
                sums += np.bincount(ids[m], weights=vals[m], minlength=G)
        return sums, counts
    width, nb = 1 << p.shift, p.buckets
    assert nb <= ga.MAX_BUCKETS and (nb - 1) * width < G <= nb * width
    assert p.blocks * p.chunk >= R > (p.blocks - 1) * p.chunk
    assert p.win * ga.PARTIAL_BYTES <= ga.SMEM_BLOCK and p.win <= width
    bucket = np.where(valid, ids, 0) >> p.shift
    hist = np.zeros((nb, p.blocks), np.int64)        # range_hist
    for b in range(p.blocks):
        rows = slice(b * p.chunk, (b + 1) * p.chunk)
        hist[:, b] = np.bincount(bucket[rows][valid[rows]], minlength=nb)
    tot = hist.sum(axis=1)                             # range_scan
    start = np.concatenate([[0], np.cumsum(hist.reshape(-1))])[:-1]
    cur = start.reshape(nb, p.blocks)
    lid, val = np.full(valid.sum(), -1), np.zeros(valid.sum())
    for r in np.nonzero(valid)[0]:                     # range_scatter
        k, b = bucket[r], r // p.chunk
        lid[cur[k, b]], val[cur[k, b]] = ids[r] - (k << p.shift), vals[r]
        cur[k, b] += 1
    assert (lid >= 0).all()                            # every slot written
    first = np.concatenate([[0], np.cumsum(tot)])
    assert p.wpb * p.win >= min(width, G)              # windows cover a bucket
    for k in range(nb):                                # range_agg
        for s in range(p.split):
            lo = first[k] + tot[k] * s // p.split
            hi = first[k] + tot[k] * (s + 1) // p.split
            for w in range(p.wpb):
                wn = min(p.win, G - (k << p.shift) - w * p.win)
                m = (lid[lo:hi] >= w * p.win) & (lid[lo:hi] < w * p.win + wn)
                g = (k << p.shift) + lid[lo:hi][m]
                counts += np.bincount(g, minlength=G)
                sums += np.bincount(g, weights=val[lo:hi][m], minlength=G)
    return sums, counts


@pytest.mark.parametrize("G,want", [
    (1, "smem"), (ga.SMEM_GROUPS, "smem"), (ga.SMEM_GROUPS + 1, "smem"),
    (Q3_RESIDUAL[1], "smem"), (ga.SMEM_MAX_GROUPS, "smem"),
    (ga.SMEM_MAX_GROUPS + 1, "range"), (2_000_000, "range"),
    (14_700_000, "range"), (2 ** 31 - 1, "range")])
def test_grouped_agg_plan_picks_the_smallest_regime_that_holds_g(G, want):
    for R in (1, Q3_RESIDUAL[0], 60_000_000):
        p = ga.plan(R, G, SMS)
        few_rows = (G > ga.SMEM_GROUPS and R <= ga.L2_ROWS_PER_GROUP * G
                    and G * 16 <= ga.L2_OUTPUT_BYTES)
        assert p.regime == ("l2" if few_rows else want)
        if p.regime == "l2":
            assert p.zero_fill and p.blocks <= 8 * SMS
            continue
        if want == "smem":
            assert p.zero_fill == (p.blocks > 1)
            assert 1 <= p.blocks * p.ranges <= 4 * SMS
            assert p.ranges <= ga.MAX_RANGES and p.ranges * p.per >= G
            bps = 1024 // p.threads  # blocks an SM, 1024 threads in all
            assert bps * (p.per * ga.PARTIAL_BYTES + ga.SMEM_RESERVED) \
                <= ga.SMEM_PER_SM
        else:
            width = 1 << p.shift
            assert (p.buckets - 1) * width < G <= p.buckets * width
            assert p.buckets <= ga.MAX_BUCKETS
            assert p.zero_fill == (p.split > 1)


def test_grouped_agg_plan_shapes_of_the_main_path():
    # the Q3 residual: 2.7 rows a group, 1.9 MB of outputs: into L2
    assert ga.plan(*Q3_RESIDUAL, SMS).regime == "l2"
    # 60M random ids over its groups: 7 ranges of 17,002 groups, the row
    # chunks that fill the card once
    p = ga.plan(60_000_000, Q3_RESIDUAL[1], SMS)
    assert (p.regime, p.ranges, p.per, p.blocks, p.zero_fill) == (
        "smem", 7, 17_002, SMS // 7, True)
    # few rows forced into smem: one chunk, whose blocks write their ranges
    # whole
    p = ga.plan(5000, Q3_RESIDUAL[1], SMS, "smem")
    assert (p.blocks, p.zero_fill) == (1, False)
    # Q18's group-by: 449 buckets of 32,768 groups (the scatter's runs),
    # 2 windows each, every window's block written directly (no zero-fill)
    p = ga.plan(60_000_000, 14_700_000, SMS)
    assert (p.regime, p.buckets, p.wpb, p.split, p.zero_fill) == (
        "range", 449, 2, 1, False)
    # at most 2 windows a bucket, until MAX_BUCKETS buckets need wider ones
    p = ga.plan(1000, 2 ** 28 + 5, SMS)
    assert (p.shift, p.wpb) == (ga.WIN_SHIFT + ga.MAX_WINDOW_BITS + 1, 4)
    p = ga.plan(1000, 2 ** 31 - 1, SMS)
    assert p.buckets <= ga.MAX_BUCKETS and p.wpb == 1 << (p.shift - 14)


def test_grouped_agg_plan_rejects_what_a_regime_cannot_hold():
    with pytest.raises(ValueError):
        ga.plan(100, ga.SMEM_MAX_GROUPS + 1, SMS, "smem")
    with pytest.raises(ValueError):
        ga.plan(100, 10, SMS, "sorted")


@pytest.mark.parametrize("regime,R,G,narrow", [
    ("smem", 3000, 37, False), ("smem", 30_000, 1000, False),
    ("smem", 30_000, 45_000, False), ("l2", 3000, 1000, False),
    ("range", 3000, 1000, False),
    ("range", 1, 3, False),
    # buckets of 16 ids in windows of 8, each window by 3 blocks
    ("range", 3000, 1000, True)])
def test_grouped_agg_regimes_cover_every_row_and_group(regime, R, G, narrow):
    rng = np.random.default_rng(R + G)
    ids = rng.integers(-2, G + 2, R).astype(np.int32)  # some out of range
    vals = rng.normal(size=R)
    p = ga.plan(R, G, 4, regime)
    if narrow:
        p = dataclasses.replace(p, shift=4, buckets=-(-G // 16), split=3,
                                win=8, wpb=2)
    sums, counts = _replay(p, ids, vals, G)
    keep = (ids >= 0) & (ids < G)
    np.testing.assert_array_equal(counts,
                                  np.bincount(ids[keep], minlength=G))
    np.testing.assert_allclose(
        sums, np.bincount(ids[keep], weights=vals[keep], minlength=G),
        rtol=1e-9, atol=1e-12)
