"""The equi-join's match-and-expand (``kernels/join_expand.py``) on the CPU.

``join_pairs`` runs the plain versions of ``join_probe`` and
``join_expand`` here; the CUDA kernels are held to them bitwise on the card
(``tests/test_torch_cuda.py``). These tests hold the plain versions to the
torch chain ``hash_join`` ran before them (two ``searchsorted``, two
``repeat_interleave``), to numpy, and ``hash_join`` to the JAX package's, on
random fan-outs: unique keys (counts 0 and 1), duplicates, one key matching
many rows, no match, empty sides, float keys with NaN and -0.0, and int32
against uint64 keys, which meet in float64. They also check the
``join.probe_rows`` and ``join.out_rows`` counters, traced and untraced.
About 10 s on one core, JAX's import included.
"""
import numpy as np
import pytest
import torch

from repro.queryproc import operators as rops
from repro.queryproc.table import ColumnTable as RTable
from repro_torch import kernels
from repro_torch.kernels import join_expand as je
from repro_torch.obs import metrics, trace
from repro_torch.queryproc import operators as ops
from repro_torch.queryproc.table import NP_OF, ColumnTable, gather, sort_key

CASES = ("unique", "unique_sorted", "fanout", "skew", "none", "empty_left",
         "empty_right", "float_nan", "int32_uint64", "uint64_high")


def _keys(case: str, seed: int = 0):
    """(left keys, right keys) as numpy arrays."""
    rng = np.random.default_rng(seed)
    if case in ("unique", "unique_sorted"):   # a key to a foreign key
        right = rng.permutation(30_000)[:10_000].astype(np.int32)
        left = rng.integers(-5, 30_005, 40_000).astype(np.int32)
        return (np.sort(left) if case == "unique_sorted" else left), right
    if case == "fanout":                      # duplicate right keys, 1 to 8
        base = rng.permutation(5_000)[:2_000]
        right = np.repeat(base, rng.integers(1, 9, base.size)).astype(
            np.int64)
        return rng.choice(base, 20_000).astype(np.int64), \
            right[rng.permutation(right.size)]
    if case == "skew":                        # one left key, 20,000 matches
        right = np.concatenate([np.full(20_000, 7), rng.integers(0, 50, 300)])
        left = np.concatenate([[7], rng.integers(0, 100, 5_000), [7]])
        return left.astype(np.int64), right[rng.permutation(right.size)]
    if case == "none":
        return (rng.integers(1_000, 2_000, 5_000).astype(np.int32),
                rng.integers(0, 1_000, 3_000).astype(np.int32))
    if case == "empty_left":
        return np.zeros(0, np.int32), rng.integers(0, 9, 100).astype(np.int32)
    if case == "empty_right":
        return rng.integers(0, 9, 100).astype(np.int32), np.zeros(0, np.int32)
    if case == "float_nan":                   # NaN meets NaN, -0.0 meets 0.0
        vals = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, -np.inf])
        return (rng.choice(vals, 5_000).astype(np.float32),
                rng.choice(np.append(vals, 9.0), 700))
    if case == "int32_uint64":                # meet in float64
        left = rng.integers(-50, 200, 5_000).astype(np.int32)
        return left, rng.integers(0, 200, 900).astype(np.uint64)
    if case == "uint64_high":
        base = np.uint64(2 ** 63) + rng.integers(0, 400, 1_000).astype(
            np.uint64)
        return rng.choice(base, 4_000), base
    raise ValueError(case)


def _sides(lv: torch.Tensor, rv: torch.Tensor):
    """(rv_sorted, r_order, lk) as ``hash_join`` builds them."""
    common = np.result_type(NP_OF[lv.dtype], NP_OF[rv.dtype])
    r_order = torch.sort(sort_key(rv), stable=True).indices
    return (ops.key_in(gather(rv, r_order), common), r_order,
            ops.key_in(lv, common))


def _chain(rv_sorted, r_order, lk):
    """The torch chain ``hash_join`` ran before the two kernels."""
    lo = torch.searchsorted(rv_sorted, lk)
    counts = torch.searchsorted(rv_sorted, lk, right=True) - lo
    l_idx = torch.repeat_interleave(torch.arange(len(lk)), counts)
    offs = torch.cumsum(counts, 0) - counts
    r_idx = r_order[torch.arange(len(l_idx))
                    - torch.repeat_interleave(offs - lo, counts)]
    return lo, counts, l_idx, r_idx


def _torch_sides(case, seed=0):
    left, right = _keys(case, seed)
    return _sides(torch.from_numpy(left), torch.from_numpy(right))


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("case", CASES)
def test_join_pairs_equal_the_chain_it_replaced(case, seed):
    rv_sorted, r_order, lk = _torch_sides(case, seed)
    lo, counts, l_idx, r_idx = _chain(rv_sorted, r_order, lk)
    got_l, got_r = je.join_pairs(rv_sorted, r_order, lk)
    assert got_l.dtype == got_r.dtype == torch.int64
    assert torch.equal(got_l, l_idx) and torch.equal(got_r, r_idx)
    plo, pcnt = je.join_probe(rv_sorted, lk)
    assert torch.equal(plo, lo) and pcnt.dtype == torch.int32
    assert torch.equal(pcnt.to(torch.int64), counts)


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_equal_numpy(case):
    rv_sorted, r_order, lk = _torch_sides(case)
    rv, lkn, order = rv_sorted.numpy(), lk.numpy(), r_order.numpy()
    lo, cnt = je.plain_probe(rv_sorted, lk)
    want_lo = np.searchsorted(rv, lkn)
    want_cnt = np.searchsorted(rv, lkn, side="right") - want_lo
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    ends = torch.cumsum(cnt, 0, dtype=torch.int64)
    n_out = int(ends[-1]) if len(ends) else 0
    l_idx, r_idx = je.plain_expand(lo, ends, r_order, n_out)
    np.testing.assert_array_equal(l_idx.numpy(),
                                  np.repeat(np.arange(lkn.size), want_cnt))
    want_r = np.concatenate([order[a:a + c] for a, c in
                             zip(want_lo, want_cnt)] + [np.zeros(0, int)])
    np.testing.assert_array_equal(r_idx.numpy(), want_r)


@pytest.mark.parametrize("case", CASES)
def test_hash_join_equals_the_reference(case):
    left, right = _keys(case, 2)
    lt = {"k": left, "a": np.arange(left.size, dtype=np.int32)}
    rt = {"k": right, "b": np.arange(right.size, dtype=np.float64)}
    got = ops.hash_join(ColumnTable.from_numpy(lt, "cpu"),
                        ColumnTable.from_numpy(rt, "cpu"), "k", "k")
    want = rops.hash_join(RTable(lt), RTable(rt), "k", "k")
    assert got.columns == list(want.cols)
    for c in want.cols:
        g, w = got.cols[c].numpy(), np.asarray(want.cols[c])
        assert g.dtype == w.dtype, c
        np.testing.assert_array_equal(g, w, err_msg=c)


@pytest.fixture
def registry():
    m = metrics.Metrics()
    prev = metrics.set_metrics(m)
    yield m
    metrics.set_metrics(prev)


def _counts(m):
    c = m.snapshot()["counters"]
    return c.get("join.probe_rows", 0), c.get("join.out_rows", 0)


@pytest.mark.parametrize("traced", (False, True))
def test_counters_add_the_left_rows_and_the_pairs(registry, traced):
    tables = []
    for case in ("unique", "fanout", "skew", "empty_left", "none"):
        left, right = _keys(case)
        tables.append((ColumnTable.from_numpy({"k": left}, "cpu"),
                       ColumnTable.from_numpy({"j": right}, "cpu")))
    want_rows = sum(len(lt) for lt, _ in tables)
    kernels.reset_launches()
    if traced:
        with trace.tracing():
            outs = [ops.hash_join(lt, rt, "k", "j") for lt, rt in tables]
        assert trace.last_counters()["join.probe_rows"] == want_rows
        assert trace.last_counters()["join.out_rows"] == \
            sum(len(o) for o in outs)
    else:
        outs = [ops.hash_join(lt, rt, "k", "j") for lt, rt in tables]
    assert _counts(registry) == (want_rows, sum(len(o) for o in outs))
    assert sum(len(o) for o in outs) > want_rows   # the skew's fan-out
    # the plain versions launch nothing
    assert kernels.launches()["join_probe"] == 0
    assert kernels.launches()["join_expand"] == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    rv_sorted, r_order, lk = _torch_sides("fanout")
    with pytest.raises(TypeError):
        je.join_probe(rv_sorted, lk.to(torch.int32))
    with pytest.raises(TypeError):
        je.join_probe(rv_sorted.to(torch.float64), lk)
    with pytest.raises(ValueError):
        je.join_probe(rv_sorted, lk[::2])
    with pytest.raises(ValueError):
        je.join_probe(rv_sorted.to("meta"), lk)
    lo, cnt = je.join_probe(rv_sorted, lk)
    ends = torch.cumsum(cnt, 0, dtype=torch.int64)
    n_out = int(ends[-1])
    with pytest.raises(TypeError):
        je.join_expand(lo, ends.to(torch.int32), r_order, n_out)
    with pytest.raises(ValueError):
        je.join_expand(lo, ends[:-1], r_order, n_out)
    with pytest.raises(ValueError):
        je.join_expand(lo, ends, r_order.view(-1, 1), n_out)
    with pytest.raises(ValueError):
        je.join_expand(lo, ends, r_order, -1)
