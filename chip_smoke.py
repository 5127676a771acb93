#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
It exits non-zero, and prints no result line, on any failure and when no
GPU is present. Phases:

1. Card and build: prints the card's name and power limit, then builds the
   CUDA kernels (``repro_torch.kernels._build``, one nvcc per source, in
   parallel) from ``src/``.
2. Kernels: holds each of the six CUDA kernels against its plain torch
   version on the card, at the shapes the main path gives it (60M
   lineitem rows), and times the kernel, the plain version and, where one
   PyTorch call computes the same function, that call, with CUDA events.
3. Engine: builds the TPC-H catalog at ``SF`` = 1000 (TPC-H SF10's row
   counts: 60M lineitem rows in 100 partitions over 4 storage nodes)
   on the card and runs Q1, Q3, Q6, Q12 and Q19 through
   ``repro_torch.core.engine.run_query`` in the no_pushdown, eager and
   adaptive modes at storage_power 1.0 and adaptive at 0.1. All modes must
   agree, Q1 and Q6 must agree with an independent torch evaluation over
   the whole lineitem table, and at power 0.1 Q1 and Q3 must split between
   pushdown and pushback.
4. §4.2 operators on the same catalog: the Fig-3 storage-side bitmap with
   the cached columns masked by ``bitmap_apply``, the Fig-4 compute-side
   bitmap, the storage-side shuffle of lineitem and orders against the
   compute-side one, the shuffle plans of Q3, Q12 and Q19 with their
   position vectors, and engine runs with bitmap-recosted requests and
   with shuffle pushdown. Every result is held to the plain operators,
   bitwise.
5. Prints each kernel's launches in phases 3 and 4 (all must be above 0),
   the per-kernel JSON line and, last, the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SF = 1000.0                   # the repo's generator at sf=1000 holds TPC-H
#                               SF10's row counts
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # H100 SXM non-tensor rate
SUM_RTOL = 1e-9               # f64 sums: atomic order differs from the plain
#                               version's, nothing else does
QUERY_IDS = ("Q1", "Q3", "Q6", "Q12", "Q19")
CONFIGS = (("no_pushdown", 1.0), ("eager", 1.0), ("adaptive", 1.0),
           ("adaptive", 0.1))
SHUFFLE_TARGETS = 4           # compute nodes of the §4.2 shuffle
REPLACES = {"predicate_bitmap": "src/repro/kernels/predicate_bitmap.py:42",
            "fused_scan_agg": "src/repro/kernels/fused_scan_agg.py:56",
            "grouped_agg": "src/repro/kernels/grouped_agg.py:48",
            "bitmap_apply": "src/repro/kernels/bitmap_apply.py:34",
            "hash_partition": "src/repro/kernels/hash_partition.py:38",
            "fused_scan_shuffle": "src/repro/kernels/fused_scan_shuffle.py:62"}
_CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"predicate_bitmap": _CSRC + "predicate_bitmap.cu",
           "fused_scan_agg": _CSRC + "fused_scan_agg.cu",
           "grouped_agg": _CSRC + "fused_scan_agg.cu",
           "bitmap_apply": _CSRC + "bitmap_apply.cu",
           "hash_partition": _CSRC + "shuffle.cu",
           "fused_scan_shuffle": _CSRC + "shuffle.cu"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, launches: int = 10, batches: int = 3) -> float:
    """Median time of single calls after a warm-up call: ``batches`` batches
    of ``launches`` back-to-back calls, each call between its own pair of
    CUDA events. A sleep kernel ahead of each batch lets the host queue the
    whole batch first, so a kernel's time is its device time and not its
    launch overhead; a function that synchronises inside pays its host time
    as it would on the path."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(launches + 1)]
        torch.cuda._sleep(20_000_000)
        events[0].record()
        for ev in events[1:]:
            fn()
            ev.record()
        events[-1].synchronize()
        times += [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's raw bits, so that equality is bitwise for floats too."""
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) \
        if a.numel() else 0.0


# ------------------------------------------------------------ kernel phase
def kernel_phase(cat, timer):
    """Hold each kernel against its plain version at the main path's shapes;
    returns ``{name: record}`` for the JSON line plus extra case lines."""
    from repro_torch.core.executor import compile_push_plan
    from repro_torch.kernels import bitmap_apply as ba
    from repro_torch.kernels import fused_scan_agg as fsa
    from repro_torch.kernels import fused_scan_shuffle as fss
    from repro_torch.kernels import grouped_agg as ga
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import predicate_bitmap as pb
    from repro_torch.kernels import ref
    from repro_torch.kernels.program import program_for
    from repro_torch.queryproc import operators, queries
    from repro_torch.queryproc.expressions import columns_of
    from repro_torch.queryproc.table import ColumnTable

    li_plans = {q: queries.build_query(q).plans["lineitem"] for q in QUERY_IDS}
    need = sorted(set().union(*(columns_of(p.predicate)
                                for p in li_plans.values()))
                  | {"l_returnflag", "l_linestatus", "l_extendedprice",
                     "l_discount", "l_orderkey"})
    li = cat.scan_table("lineitem", need).cols
    R = li["l_shipdate"].shape[0]
    records, lines = {}, []

    # predicate_bitmap: Q19's lineitem filter (the largest program), and
    # Q3/Q6/Q12's held for equality; the error is the largest
    # |kernel bit - plain bit| over the four bitmaps
    err = 0.0
    for q in ("Q3", "Q6", "Q12", "Q19"):
        prog = program_for(li_plans[q].predicate, li)
        cols = [li[c] for c in prog.columns]
        words, plain = pb.predicate_bitmap(prog, cols), ref.predicate_bitmap(prog, cols)
        err = max(err, float((words != plain).any()))
        check(torch.equal(words, plain), f"predicate_bitmap {q}: words differ")
    ms = timer(lambda: pb.predicate_bitmap(prog, cols))
    plain_ms = timer(lambda: ref.predicate_bitmap(prog, cols))
    b_ms, b_by = bound(nbytes(*cols) + nbytes(words), R * prog.n_ops)
    records["predicate_bitmap"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape=f"Q19 lineitem predicate, R={R}, {prog.n_ops} ops")

    # fused_scan_agg: Q1's partial agg (partition, returnflag, linestatus)
    # and Q6's keyless one (partition), one launch per summed column
    n_parts = len(cat.partitions_of("lineitem"))
    seg = torch.repeat_interleave(
        torch.arange(n_parts, device=li["l_shipdate"].device),
        torch.as_tensor([len(p.data) for p in cat.partitions_of("lineitem")],
                        device=li["l_shipdate"].device))
    q6_vals = li["l_extendedprice"] * li["l_discount"]
    for q, keys, vals in (("Q6", [], q6_vals),
                          ("Q1", ["l_returnflag", "l_linestatus"],
                           li["l_extendedprice"])):
        ids, G, _ = operators.group_ids([li[k] for k in keys], lead=seg,
                                        lead_size=n_parts)
        prog = program_for(li_plans[q].predicate, li)
        cols = [li[c] for c in prog.columns]
        sums, counts = fsa.fused_scan_agg(prog, cols, ids, vals, G)
        psums, pcounts = ref.fused_scan_agg(prog, cols, ids, vals, G)
        check(torch.equal(counts, pcounts), f"fused_scan_agg {q}: counts differ")
        check(torch.allclose(sums, psums, rtol=SUM_RTOL, atol=0.0),
              f"fused_scan_agg {q}: sums differ beyond rtol {SUM_RTOL}")
        err = float((sums - psums).abs().max())
    kept = int(pcounts.sum())
    ms = timer(lambda: fsa.fused_scan_agg(prog, cols, ids, vals, G))
    plain_ms = timer(lambda: ref.fused_scan_agg(prog, cols, ids, vals, G))
    b_ms, b_by = bound(nbytes(*cols) + kept * (4 + vals.element_size())
                       + G * 16, R * prog.n_ops + kept)
    records["fused_scan_agg"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape=f"Q1 partial agg, R={R}, G={G}, kept={kept}")

    # grouped_agg: Q3's residual group-by (orderkey, orderdate,
    # shippriority) over the joined pushdown results, then lineitem scale
    q3 = queries.build_query("Q3")
    merged = {}
    for table, plan in q3.plans.items():
        parts, _aux = compile_push_plan(plan).execute_batch_parts(
            [p.data for p in cat.partitions_of(table)])
        merged[table] = ColumnTable.concat(parts)
    j = operators.hash_join(merged["orders"], merged["customer"],
                            "o_custkey", "c_custkey")
    j = operators.hash_join(merged["lineitem"], j, "l_orderkey", "o_orderkey")
    ids, G, _ = operators.group_ids(
        [j.cols[k] for k in ("l_orderkey", "o_orderdate", "o_shippriority")])
    gen = torch.Generator(device=ids.device).manual_seed(0)
    big_ids = torch.randint(0, G, (R,), generator=gen, device=ids.device,
                            dtype=torch.int32)
    for case, cids, cvals in (("lineitem scale", big_ids, li["l_extendedprice"]),
                              ("Q3 residual", ids, j.cols["revenue"])):
        sums, counts = ga.grouped_agg(cids, cvals, G)
        psums, pcounts = ref.grouped_agg(cids, cvals, G)
        check(torch.equal(counts, pcounts), f"grouped_agg {case}: counts differ")
        check(torch.allclose(sums, psums, rtol=SUM_RTOL, atol=0.0),
              f"grouped_agg {case}: sums differ beyond rtol {SUM_RTOL}")
        rec = dict(
            max_abs_err=float((sums - psums).abs().max()),
            ms=timer(lambda: ga.grouped_agg(cids, cvals, G)),
            plain_ms=timer(lambda: ref.grouped_agg(cids, cvals, G)),
            library_ms=timer(lambda: torch.bincount(cids, weights=cvals,
                                                    minlength=G)),
            shape=f"{case}, R={cids.shape[0]}, G={G}")
        rec["bound_ms"], rec["bound_by"] = bound(
            nbytes(cids, cvals) + G * 16, cids.shape[0])
        if case == "lineitem scale":
            lines.append(rec)
    records["grouped_agg"] = rec
    del big_ids, j, merged

    # bitmap_apply: Q19's lineitem words applied to l_orderkey (int32) and
    # l_extendedprice (f64), the Fig-3 cached columns; timed on the f64 one
    prog = program_for(li_plans["Q19"].predicate, li)
    words = ref.predicate_bitmap(prog, [li[c] for c in prog.columns])
    err = 0.0
    for c in ("l_orderkey", "l_extendedprice"):
        col = li[c]
        masked, count = ba.bitmap_apply(words, col)
        pmasked, pcount = ref.bitmap_apply(words, col)
        check(torch.equal(bits(masked), bits(pmasked)) and
              int(count) == int(pcount), f"bitmap_apply {c}: differs")
        err = max(err, max_diff(masked, pmasked), abs(int(count) - int(pcount)))
    # a dropped row's output is 0 whatever the column holds: the function
    # reads the words, the kept rows' values, and writes every row
    b_ms, b_by = bound(nbytes(words) + int(count) * col.element_size()
                       + nbytes(col), R)
    records["bitmap_apply"] = dict(
        max_abs_err=err, ms=timer(lambda: ba.bitmap_apply(words, col)),
        plain_ms=timer(lambda: ref.bitmap_apply(words, col)), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape=f"Q19 words on l_extendedprice f64, R={R}, kept={int(count)}")
    del masked, pmasked

    # hash_partition: l_orderkey over every lineitem row into 4 targets
    keys, P = li["l_orderkey"], SHUFFLE_TARGETS
    pids, hist = hp.hash_partition(keys, P)
    ppids, phist = ref.hash_partition(keys, P)
    check(torch.equal(pids, ppids) and torch.equal(hist, phist),
          "hash_partition: pids or histogram differ")
    b_ms, b_by = bound(nbytes(keys, pids, hist), 3 * R)
    records["hash_partition"] = dict(
        max_abs_err=max(max_diff(pids, ppids), max_diff(hist, phist)),
        ms=timer(lambda: hp.hash_partition(keys, P)),
        plain_ms=timer(lambda: ref.hash_partition(keys, P)), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shape=f"l_orderkey, R={R}, P={P}")
    del pids, ppids

    # fused_scan_shuffle: Q3's and Q19's lineitem predicates, key
    # l_orderkey, 4 targets; timed on Q19's (the longer program)
    err = 0.0
    for q in ("Q3", "Q19"):
        prog = program_for(li_plans[q].predicate, li)
        cols = [li[c] for c in prog.columns]
        out = fss.fused_scan_shuffle(prog, cols, keys, P)
        plain = ref.fused_scan_shuffle(prog, cols, keys, P)
        check(all(torch.equal(a, b) for a, b in zip(out, plain)),
              f"fused_scan_shuffle {q}: words, pids or histogram differ")
        err = max([err] + [max_diff(a, b) for a, b in zip(out, plain)])
    b_ms, b_by = bound(nbytes(*cols, keys, *out), R * (prog.n_ops + 3))
    records["fused_scan_shuffle"] = dict(
        max_abs_err=err, ms=timer(lambda: fss.fused_scan_shuffle(prog, cols,
                                                                 keys, P)),
        plain_ms=timer(lambda: ref.fused_scan_shuffle(prog, cols, keys, P)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"Q19 lineitem predicate, key l_orderkey, R={R}, P={P}, "
              f"kept={int(out[2].sum())}")
    return records, lines


# ------------------------------------------------------------ engine phase
def independent_q1_q6(cat):
    """Q1 and Q6 in single-pass torch over the whole lineitem table, with
    none of the engine's code (no plans, no kernels, no group ids)."""
    from repro_torch.queryproc.table import ColumnTable
    from repro_torch.queryproc.tpch import N_LINESTATUS, N_RETURNFLAG, date
    li = cat.scan_table("lineitem", [
        "l_extendedprice", "l_discount", "l_tax", "l_quantity", "l_shipdate",
        "l_returnflag", "l_linestatus"]).cols
    e, d, t, qty = (li[c] for c in ("l_extendedprice", "l_discount", "l_tax",
                                    "l_quantity"))
    m = li["l_shipdate"] <= date(1998, 8, 2) - 90
    code = (li["l_returnflag"].long() * N_LINESTATUS + li["l_linestatus"])[m]
    n = N_RETURNFLAG * N_LINESTATUS

    def gsum(v):
        return torch.zeros(n, dtype=torch.float64, device=v.device).index_add_(
            0, code, v[m])
    cnt = torch.bincount(code, minlength=n)
    have = cnt > 0
    g = torch.arange(n, device=code.device)[have]
    q1 = ColumnTable({
        "l_returnflag": (g // N_LINESTATUS).to(torch.int32),
        "l_linestatus": (g % N_LINESTATUS).to(torch.int32),
        "sum_qty": gsum(qty)[have], "sum_base": gsum(e)[have],
        "sum_disc": gsum(e * (1 - d))[have],
        "sum_charge": gsum(e * (1 - d) * (1 + t))[have],
        "cnt": cnt[have].to(torch.float64)})
    D = date(1994, 1, 1)
    m6 = ((li["l_shipdate"] >= D) & (li["l_shipdate"] < D + 365)
          & (d >= 0.05) & (d < 0.0701) & (qty < 24))
    q6 = ColumnTable({"revenue": (e * d)[m6].sum().reshape(1)})
    return {"Q1": q1, "Q6": q6}


def engine_phase(cat, sync):
    """Every query in every config through ``run_query``; returns the
    kernels' launch counts over exactly these runs."""
    from repro_torch import kernels
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import EngineConfig, results_equal, run_query
    from repro_torch.queryproc import queries

    expected = independent_q1_q6(cat)
    t0 = time.perf_counter()
    for p in cat.iter_partitions():
        p.data.stats()
    sync()
    print(f"engine: column stats of {sum(1 for _ in cat.iter_partitions())} "
          f"partitions in {time.perf_counter() - t0:.3f} s")

    def config(mode, power):
        return EngineConfig(res=StorageResources(storage_power=power),
                            mode=mode, device=cat.device)
    # one untimed pass first: torch loads each device kernel at its first
    # use, which would otherwise land in whichever run comes first
    t0 = time.perf_counter()
    for qid in QUERY_IDS:
        for mode, power in CONFIGS:
            run_query(queries.build_query(qid), cat, config(mode, power))
    sync()
    print(f"engine: warm-up pass in {time.perf_counter() - t0:.3f} s")
    kernels.reset_launches()
    for qid in QUERY_IDS:
        runs = []
        for mode, power in CONFIGS:
            cfg = config(mode, power)
            sync()
            t0 = time.perf_counter()
            run = run_query(queries.build_query(qid), cat, cfg)
            sync()
            wall = time.perf_counter() - t0
            print(f"engine: {qid} mode={mode} storage_power={power} "
                  f"wall_s={wall:.4f} admitted={run.n_admitted} "
                  f"pushed_back={run.n_pushed_back} "
                  f"real_net_bytes={run.real_net_bytes} "
                  f"result_rows={len(run.result)}")
            check(len(run.result) > 0, f"{qid} {mode}: empty result")
            for c, v in run.result.cols.items():
                if v.is_floating_point():
                    check(bool(torch.isfinite(v).all()),
                          f"{qid} {mode}: non-finite {c}")
            runs.append(run)
        for run, (mode, power) in zip(runs[1:], CONFIGS[1:]):
            check(results_equal(runs[0].result, run.result),
                  f"{qid}: {mode} at power {power} disagrees with no_pushdown")
        if qid in expected:
            check(results_equal(runs[0].result, expected[qid]),
                  f"{qid}: engine disagrees with the independent evaluation")
        if qid in ("Q1", "Q3"):
            low = runs[-1]
            check(low.n_admitted > 0 and low.n_pushed_back > 0,
                  f"{qid} at power 0.1: no pushdown/pushback split "
                  f"({low.n_admitted}/{low.n_pushed_back})")
    return kernels.launches()


# ------------------------------------------------------------ §4.2 phase
def fig3_columns(plan):
    """The Fig-3 storage request of ``benchmarks/bitmap_storage.py``: its
    ``bitmap_plan`` columns split by its ``_cache_outputs_only`` cache into
    (uncached, cached); the predicate's columns are never cached."""
    from repro_torch.queryproc.expressions import columns_of
    derived = {n for n, _, _ in plan.derive}
    cols = [c for c in plan.accessed_columns() if c not in derived]
    outputs = {c for c in plan.columns if c not in derived}
    for _, incols, _ in plan.derive:
        outputs |= set(incols)
    cached = outputs - columns_of(plan.predicate)
    return ([c for c in cols if c not in cached],
            [c for c in cols if c in cached])


def shuffle_plan(query, table: str, n: int):
    """``benchmarks/shuffle.py``'s ``_shuffle_plan``: the query's plan for
    ``table`` with the shuffle attached and its key kept in the output."""
    plan, key = query.plans[table], query.shuffle_keys[table]
    if plan.agg is not None:
        return (dataclasses.replace(plan, shuffle=(key, n))
                if key in plan.agg[0] else None)
    cols = plan.columns if key in plan.columns else (*plan.columns, key)
    return dataclasses.replace(plan, columns=cols, shuffle=(key, n))


def identical(a, b) -> bool:
    """The same columns in the same order, dtypes and bits."""
    return list(a.cols) == list(b.cols) and all(
        a.cols[c].dtype == b.cols[c].dtype
        and torch.equal(bits(a.cols[c]), bits(b.cols[c])) for c in a.cols)


def same_rows(a, b) -> bool:
    """``results_equal``'s row-multiset equality, exact and on the device:
    both tables put in one order (a stable sort by every column), then
    compared bitwise."""
    from repro_torch.queryproc.operators import sort_table
    cols = sorted(a.cols)
    return (sorted(b.cols) == cols and len(a) == len(b)
            and identical(sort_table(a.select(cols), cols),
                          sort_table(b.select(cols), cols)))


def section42_phase(cat, sync):
    """The §4.2 operators over the catalog, held to the plain operators.
    Each driven step runs with the launch counts zeroed just before it and
    read just after; the checks between the steps are not counted. Returns
    the counts summed over the steps."""
    from repro_torch import kernels
    from repro_torch.core import bitmap, shuffle
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import (EngineConfig, plan_requests,
                                         results_equal, run_query)
    from repro_torch.core.executor import compile_push_plan
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.kernels import ref
    from repro_torch.queryproc import expressions as ex
    from repro_torch.queryproc import operators as ops
    from repro_torch.queryproc import queries

    launches = {n: 0 for n in kernels.WRAPPERS}

    def drive(fn, *args, **kwargs):
        kernels.reset_launches()
        out = fn(*args, **kwargs)
        sync()
        for n, c in kernels.launches().items():
            launches[n] += c
        return out

    n = SHUFFLE_TARGETS
    parts = [p.data for p in cat.partitions_of("lineitem")]
    plans = {q: queries.build_query(q).plans["lineitem"]
             for q in ("Q3", "Q6", "Q12", "Q19")}
    for qid, plan in plans.items():
        t0 = time.perf_counter()
        pred = plan.predicate
        uncached, cached = fig3_columns(plan)
        words, tabs = drive(bitmap.storage_side_bitmap_batched, parts, pred,
                            uncached)
        masked, counts = drive(bitmap.apply_bitmap_to_cache,
                               [p.select(cached) for p in parts], words)
        counts = counts.tolist()
        for p, part in enumerate(parts):
            mask = ex.compile_expr(pred)(part.cols)
            want = part.select(uncached + cached).filter(mask)
            check(torch.equal(words[p], ref.pack_bitmap(mask)),
                  f"fig3 {qid} partition {p}: words differ")
            check(counts[p] == len(want),
                  f"fig3 {qid} partition {p}: bitmap_apply count")
            check(identical(tabs[p], want.select(uncached)),
                  f"fig3 {qid} partition {p}: uncached columns differ")
            check(identical(masked[p].filter(mask), want.select(cached))
                  and not any(bool(v[~mask].any())
                              for v in masked[p].cols.values()),
                  f"fig3 {qid} partition {p}: masked cached columns differ")
        sync()
        print(f"fig3: {qid} uncached={uncached} cached={cached} "
              f"kept={sum(counts)} of {sum(len(p) for p in parts)} rows in "
              f"{len(parts)} partitions, driven and checked in "
              f"{time.perf_counter() - t0:.3f} s")
        del words, tabs, masked

        t0 = time.perf_counter()
        pred_cols = ex.columns_of(pred)
        derived = {c for c, _, _ in plan.derive}
        out_cols = [c for c in plan.accessed_columns()
                    if c not in derived and c not in pred_cols]
        bitmaps = drive(lambda: [ops.selection_bitmap(p.select(pred_cols),
                                                      pred) for p in parts])
        got = drive(bitmap.compute_side_apply_batched, parts, bitmaps,
                    out_cols)
        for p, part in enumerate(parts):
            mask = ex.compile_expr(pred)(part.cols)
            check(torch.equal(bitmaps[p], ref.pack_bitmap(mask))
                  and identical(got[p], part.select(out_cols).filter(mask)),
                  f"fig4 {qid} partition {p}: differs")
        sync()
        print(f"fig4: {qid} out_cols={out_cols} rows="
              f"{sum(len(g) for g in got)} driven and checked in "
              f"{time.perf_counter() - t0:.3f} s")
        del bitmaps, got

    for table, key in (("lineitem", "l_orderkey"), ("orders", "o_custkey")):
        t0 = time.perf_counter()
        at_storage = drive(shuffle.shuffle_at_storage_batched, cat, table,
                           key, n)
        at_compute = drive(shuffle.shuffle_at_compute, cat, table, key, n)
        _, hist = hp.hash_partition(cat.scan_table(table, [key]).cols[key], n)
        sizes = [len(t) for t in at_storage]
        check(sum(sizes) == sum(len(p.data) for p in cat.partitions_of(table))
              and sizes == hist.tolist(),
              f"shuffle {table}: target sizes {sizes}, histogram "
              f"{hist.tolist()}")
        for t, (s_t, c_t) in enumerate(zip(at_storage, at_compute)):
            check(bool((ops.hash_partition_ids(s_t.cols[key], n) == t).all()),
                  f"shuffle {table}: a row of target {t} hashes elsewhere")
            check(same_rows(s_t, c_t),
                  f"shuffle {table} target {t}: storage and compute differ")
        sync()
        print(f"shuffle: {table} by {key} into {n} targets of {sizes} rows, "
              f"driven and checked in {time.perf_counter() - t0:.3f} s")
        del at_storage, at_compute

    for qid in ("Q3", "Q12", "Q19"):
        q = queries.build_query(qid)
        for table, key in q.shuffle_keys.items():
            t0 = time.perf_counter()
            plan = shuffle_plan(q, table, n)
            tabs, aux = drive(compile_push_plan(plan).execute_batch_parts,
                              [p.data for p in cat.partitions_of(table)])
            other = next(c for c in plan.columns if c != key)
            for p, (t, a) in enumerate(zip(tabs, aux)):
                plain = ops.shuffle_partition(t, key, n)
                pv = a["position_vector"]
                via_pv = shuffle.apply_position_vector(t.select([other]), pv,
                                                       n)
                check(all(identical(s, w)
                          for s, w in zip(a["shuffle_parts"], plain)),
                      f"{qid} {table} partition {p}: shuffle slices differ")
                check(torch.equal(pv, ops.hash_partition_ids(t.cols[key], n)),
                      f"{qid} {table} partition {p}: position vector")
                check(all(identical(v, w.select([other]))
                          for v, w in zip(via_pv, plain)),
                      f"{qid} {table} partition {p}: routing by position "
                      f"vector differs")
            sync()
            print(f"shuffle plan: {qid} {table} by {key} "
                  f"({'filtered' if plan.predicate is not None else 'all rows'}"
                  f") rows={sum(len(t) for t in tabs)} driven and checked in "
                  f"{time.perf_counter() - t0:.3f} s")
            del tabs, aux

    cfg = EngineConfig(res=StorageResources(storage_power=1.0), mode="eager",
                       device=cat.device)
    for qid in ("Q3", "Q12", "Q19"):
        q = queries.build_query(qid)
        base = drive(run_query, q, cat, cfg)
        plan = q.plans["lineitem"]
        for name, cols in (("outputs", fig3_columns(plan)[1]),
                           ("predicates", ex.columns_of(plan.predicate))):
            cache = bitmap.CacheState()
            cache.cache_columns("lineitem", cols)
            reqs, met = bitmap.rewrite_all(plan_requests(q, cat), cache)
            t0 = time.perf_counter()
            run = drive(run_query, q, cat, cfg, requests=reqs)
            wall = time.perf_counter() - t0
            check(results_equal(run.result, base.result),
                  f"{qid} with {name} cached: result differs")
            print(f"bitmap engine: {qid} {name} cached: "
                  f"net_bitmap/net_baseline="
                  f"{met['net_bitmap'] / met['net_baseline']:.6f} "
                  f"bitmap_bytes={met['bitmap_bytes']} "
                  f"disk_saved={met['disk_saved']} wall_s={wall:.4f}")
        runs = {}
        for pushdown in (False, True):
            t0 = time.perf_counter()
            runs[pushdown] = drive(shuffle.run_shuffle, q, cat, cfg,
                                   shuffle.ShuffleConfig(num_compute_nodes=n),
                                   pushdown)
            print(f"shuffle engine: {qid} pushdown={pushdown} "
                  f"cross_compute_bytes={runs[pushdown].cross_compute_bytes} "
                  f"storage_net_bytes={runs[pushdown].storage_net_bytes} "
                  f"t_total={runs[pushdown].t_total:.6f} "
                  f"wall_s={time.perf_counter() - t0:.4f}")
        check(runs[True].cross_compute_bytes == 0
              and runs[False].cross_compute_bytes > 0,
              f"{qid}: shuffle pushdown left cross-compute traffic")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.queryproc import tpch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"card {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi name, power limit:")
    print(smi[0])
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: nvcc sm_90a, {len(_build.SOURCES)} libraries in "
          f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cat = tpch.build_catalog(sf=SF, seed=args.seed, num_nodes=4,
                             rows_per_partition=600_000)
    torch.cuda.synchronize()
    print(f"catalog: sf={SF} seed={args.seed} "
          f"lineitem={sum(len(p.data) for p in cat.partitions_of('lineitem'))} "
          f"rows in "
          f"{len(cat.partitions_of('lineitem'))} partitions, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, built in "
          f"{time.perf_counter() - t0:.2f} s")

    records, extra = kernel_phase(cat, cuda_ms)
    for name, rec in records.items():
        print(f"kernel: {name} [{rec['shape']}] ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}) library_ms={rec['library_ms']} "
              f"max_abs_err={rec['max_abs_err']:.3g}")
    for rec in extra:
        print(f"kernel: grouped_agg [{rec['shape']}] ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}) library_ms={rec['library_ms']:.4f} "
              f"max_abs_err={rec['max_abs_err']:.3g}")

    engine = engine_phase(cat, torch.cuda.synchronize)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sec42 = section42_phase(cat, torch.cuda.synchronize)
    print(f"section 4.2 phase: {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on the card")
    launches = {n: engine[n] + sec42[n] for n in records}
    print("kernels: " + "; ".join(
        f"{n} check=ok launches={launches[n]} (engine {engine[n]}, "
        f"section 4.2 {sec42[n]})" for n in records))
    for n in records:
        check(launches[n] > 0, f"{n} never launched on the main path")
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n],
         "replaces": REPLACES[n], "launches": launches[n],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for n, r in records.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
