#!/usr/bin/env python3
"""Time the alternatives of the redesigned kernels on one GPU.

    python3 profile_kernels.py {grouped_agg,predicate_bitmap,fused_scan_agg,
                                bitmap_apply,fused_scan_shuffle,engine,
                                cache,residual,jitter} [--seed 0]
                               [--repeats 5]

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
``repro_torch`` comes from ``PYTHONPATH`` when it is found there, else from
``src/``, so ``PYTHONPATH=<other checkout>/src`` times another version's
kernels on the same inputs. Every result is held against the plain version
first; times are medians of CUDA-event times (``chip_smoke.cuda_ms``).
Prints the card's name and power limit.

- ``grouped_agg``: at chip_smoke's three shapes (316,000 ids over 119,009
  groups, the size of Q3's residual; 60M random ids over the same groups;
  60M random order keys compressed to about 14.7M groups, like Q18's
  group-by) and at one point on each side of every threshold of
  ``grouped_agg.plan`` (16 rows a group, 24 MB of outputs, 8 ranges), it
  times every regime that holds the groups, each plan made by ``plan``,
  beside ``torch.bincount``, and prints the device time of each kernel of
  the picked plan at the three shapes (``torch.profiler``).
- ``predicate_bitmap``: Q19's lineitem program over one 600,000-row
  partition (the Fig-4 launches' shape), the same view from its row 1 (not
  16-byte aligned) and 100 copies of the partition (60M rows), each beside
  its bytes bound.
- ``fused_scan_agg``: on chip_smoke's catalog (sf=1000, 60M lineitem rows
  in 100 partitions), Q1's partial aggregate with its four sums (one call
  for all four where the wrapper takes several value columns, else one call
  per sum), with one sum and with counts only, and Q6's keyless one-value
  aggregate, each beside its bytes bound.
- ``bitmap_apply``: on the same catalog, Q19's words applied to one
  600,000-row partition's f64 and int32 cached columns (also from row 1),
  to all 60M rows of ``l_extendedprice`` (beside ``zero_`` of 480 MB, the
  card's write rate), and as the whole Fig-3 compute
  side (``core.bitmap.apply_bitmap_to_cache`` over 100 partitions and
  Q19's three cached columns): its device time, its launches, and the host
  time of the call alone and until the card is done.
- ``fused_scan_shuffle``: on the same catalog, Q19's and Q3's lineitem
  predicates with key ``l_orderkey`` into 4 targets, Q19's into 9 and
  8192 targets (the shared counters), with the keys as int64 and on one
  partition's view from its row 1, and, where the checkout pools long
  ``In`` lists, chip_smoke's 512-value ``In`` on ``l_partkey``, each
  beside its bytes bound and with the launch's grid, ring and shared
  memory where the wrapper reports them.
- ``engine``: on the same catalog, the wall time of Q1, Q3, Q6, Q12 and
  Q19 in chip_smoke's four configurations, each run once untimed and then
  ``--repeats`` times: first through the hand-built plans
  (``run_query(build_query_legacy(qid))``, or ``build_query`` where a
  checkout has no legacy builder), then, where the checkout has
  ``compile_and_run``, through it; then one pass of every query in every
  configuration (chip_smoke's warm-up) and Q1 again, then Q1 again after
  ``torch.cuda.empty_cache()``, these two with no untimed run ahead, as
  chip_smoke times them. Each line gives every wall, their median,
  the caching allocator's device allocations, frees and retries and the
  full collections of Python's cyclic GC over the line's runs; also the host time of ``compile_query("Q1")``.
- ``cache``: on the same catalog, every compiled query eager at storage
  power 1.0, uncached and warm from a ``ResultCache`` it filled first,
  each run once untimed and then ``--repeats`` times with
  ``gc.collect()`` before each timed run: the walls, their medians, the
  ratio of the medians and one run's device time (``torch.profiler``, the
  sum over kernels); for Q1, Q3 and Q14 the host functions with the most
  self time in one uncached and one warm run (``cProfile``).
- ``residual``: on the same catalog, every compiled query's residual over
  its eager merged tables through the interpreter and through the tensor
  backend (``compiler.tensorize``, observed and run cold first), each
  ``--repeats`` times with ``gc.collect()`` before each: the medians, one
  run's device time (``torch.profiler``, the sum over kernels) and, for
  the tensor backend, the device operations with the most time and the
  host functions with the most self time (``cProfile``) in one run.
- ``jitter``: how often f64 sums move in their last bits from run to run
  on the same catalog. ``--repeats`` launches of Q6's keyless
  ``fused_scan_agg`` on the same inputs (distinct results, groups that
  moved, the largest relative move); ``--repeats`` uncached eager runs of
  every compiled query (distinct results, and whether each agrees with
  the first in rows); and ``--repeats`` times chip_smoke's Q6 warm flip
  at storage power 0.01 (an uncached eager run, then adaptive, eager and
  adaptive on a fresh cache), each run held bitwise to that repetition's
  uncached one and the warm run to the eager run that filled the cache.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import functools
import gc
import os
import pstats
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def profile(fn) -> str:
    """The device time of each kernel ``fn`` launches, one call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_time_total > 0]
    return "; ".join(f"{e.key[:40]} {e.device_time_total / 1e3:.4f} ms"
                     for e in rows)


# the kernels of csrc/grouped_agg.cu (every regime)
GROUPED_AGG_KERNELS = ("agg_smem_kernel", "range_hist_kernel",
                       "range_scan_kernel", "range_scatter_kernel",
                       "range_agg_kernel")


def device_ms_of(prof) -> float:
    """Device milliseconds in a profile: the sum over the device's own
    events (kernels, copies). An operator's row carries its kernels' time
    too, so a sum over every row counts most of it twice."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def grouped_agg_shapes(dev, gen):
    """(name, ids, G): chip_smoke's shapes, then the threshold points."""
    from repro_torch.kernels import grouped_agg as ga

    def rand(R, G):
        return torch.randint(0, G, (R,), generator=gen, device=dev,
                             dtype=torch.int32), G
    keys = torch.randint(0, 15_000_000, (60_000_000,), generator=gen,
                         device=dev)
    q18 = torch.unique(keys, return_inverse=True)[1].to(torch.int32)
    del keys
    yield "Q3-residual-sized", *rand(316_000, 119_009)
    yield "60M over 119,009", *rand(60_000_000, 119_009)
    yield "Q18-like", q18, int(q18.max()) + 1
    G = 119_009
    for per in (ga.L2_ROWS_PER_GROUP - 4, ga.L2_ROWS_PER_GROUP + 4):
        yield f"{per} rows a group", *rand(per * G, G)
    top = ga.L2_OUTPUT_BYTES // 16
    for G in (top * 7 // 8, top * 9 // 8):
        yield f"{G * 16 / 2**20:.0f} MB of outputs", *rand(8 * G, G)
    for G in (ga.SMEM_MAX_GROUPS * 31 // 32, ga.SMEM_MAX_GROUPS * 33 // 32):
        yield f"{G / ga.SMEM_GROUPS:.2f} ranges", *rand(60_000_000, G)


def time_grouped_agg(dev, gen, sms):
    from chip_smoke import SUM_RTOL, check, cuda_ms
    from repro_torch.kernels import grouped_agg as ga
    from repro_torch.kernels import ref

    for n, (name, ids, G) in enumerate(grouped_agg_shapes(dev, gen)):
        R = ids.shape[0]
        vals = torch.rand(R, generator=gen, device=dev, dtype=torch.float64)
        psums, pcounts = ref.grouped_agg(ids, vals, G)
        picked = ga.plan(R, G, sms)
        for regime in ga.REGIMES:
            try:
                p = ga.plan(R, G, sms, regime)
            except ValueError:
                continue  # this regime cannot hold G groups
            sums, counts = ga.run_plan(p, ids, vals, G)
            check(torch.equal(counts, pcounts) and torch.allclose(
                sums, psums, rtol=SUM_RTOL, atol=0.0), f"{name} {regime}")
            ms = cuda_ms(lambda: ga.run_plan(p, ids, vals, G))
            mark = " (picked)" if regime == picked.regime else ""
            print(f"grouped_agg {name} R={R} G={G} {regime}{mark}: "
                  f"ms={ms:.4f}")
        print(f"grouped_agg {name}: bincount ms="
              f"{cuda_ms(lambda: torch.bincount(ids, vals, G)):.4f}")
        if n < 3:
            print(f"grouped_agg {name} picked, by kernel: "
                  f"{profile(lambda: ga.run_plan(picked, ids, vals, G))}")


def time_predicate_bitmap(dev, seed):
    from chip_smoke import bound, check, cuda_ms, nbytes
    from repro_torch.kernels import predicate_bitmap as pb
    from repro_torch.kernels import ref
    from repro_torch.kernels.program import program_for
    from repro_torch.queryproc import queries, tpch

    cat = tpch.build_catalog(sf=10, seed=seed, num_nodes=1,
                             rows_per_partition=600_000, device=dev)
    part = cat.partitions_of("lineitem")[0].data.cols
    prog = program_for(queries.build_query("Q19").plans["lineitem"].predicate,
                       part)
    cols = [part[c] for c in prog.columns]
    for name, cs in (("one partition", cols),
                     ("one partition from row 1", [c[1:] for c in cols]),
                     ("100 partitions", [c.repeat(100) for c in cols])):
        words = pb.predicate_bitmap(prog, cs)
        check(torch.equal(words, ref.predicate_bitmap(prog, cs)), name)
        R = cs[0].shape[0]
        b_ms, _ = bound(nbytes(*cs) + nbytes(words), R * prog.n_ops)
        print(f"predicate_bitmap Q19 {name} R={R} {prog.n_ops} ops: "
              f"ms={cuda_ms(lambda: pb.predicate_bitmap(prog, cs)):.4f} "
              f"bound_ms={b_ms:.4f}")


def lineitem_catalog(dev, seed):
    """chip_smoke.py's catalog: sf=1000, 100 lineitem partitions."""
    from chip_smoke import SF
    from repro_torch.queryproc import tpch
    return tpch.build_catalog(sf=SF, seed=seed, num_nodes=4,
                              rows_per_partition=600_000, device=dev)


def agg(fn, prog, cols, ids, vals, G):
    """(sums (V, G), counts) of ``vals`` through ``fn`` (the wrapper or its
    plain version): one call where it takes a sequence of value columns,
    else one call per column (an earlier version's wrapper)."""
    from repro_torch.kernels import fused_scan_agg as fsa
    if hasattr(fsa, "MAX_VALUES"):
        return fn(prog, cols, ids, vals, G)
    out = [fn(prog, cols, ids, v, G) for v in vals] or [
        fn(prog, cols, ids, None, G)]
    return (torch.stack([s for s, _ in out]) if vals else None), out[-1][1]


def time_fused_scan_agg(dev, seed):
    from chip_smoke import SUM_RTOL, bound, check, cuda_ms, nbytes
    from repro_torch.kernels import fused_scan_agg as fsa
    from repro_torch.kernels import ref
    from repro_torch.kernels.program import program_for
    from repro_torch.queryproc import operators, queries

    cat = lineitem_catalog(dev, seed)
    parts = cat.partitions_of("lineitem")
    li = cat.scan_table("lineitem", [
        "l_shipdate", "l_discount", "l_quantity", "l_extendedprice", "l_tax",
        "l_returnflag", "l_linestatus"]).cols
    seg = torch.repeat_interleave(
        torch.arange(len(parts), device=dev),
        torch.as_tensor([len(p.data) for p in parts], device=dev))
    q1 = queries.build_query("Q1").plans["lineitem"]
    for name, incols, fn in q1.derive:
        li[name] = fn(*[li[c] for c in incols])
    q1_vals = [li[c] for _o, f, c in q1.agg[1] if f == "sum"]
    e, d = li["l_extendedprice"], li["l_discount"]
    for name, q, keys, vals in (
            ("Q1 four sums", "Q1", q1.agg[0], q1_vals),
            ("Q1 one sum", "Q1", q1.agg[0], q1_vals[1:2]),
            ("Q1 counts only", "Q1", q1.agg[0], []),
            ("Q6 one sum", "Q6", [], [e * d])):
        plan = queries.build_query(q).plans["lineitem"]
        ids, G, _ = operators.group_ids([li[k] for k in keys], lead=seg,
                                        lead_size=len(parts))
        prog = program_for(plan.predicate, li)
        cols = [li[c] for c in prog.columns]
        sums, counts = agg(fsa.fused_scan_agg, prog, cols, ids, vals, G)
        psums, pcounts = agg(ref.fused_scan_agg, prog, cols, ids, vals, G)
        check(torch.equal(counts, pcounts) and (not vals or torch.allclose(
            sums, psums, rtol=SUM_RTOL, atol=0.0)), name)
        kept = int(pcounts.sum())
        b_ms, _ = bound(nbytes(*cols) + kept * (4 + sum(v.element_size()
                                                       for v in vals))
                        + G * (8 * len(vals) + 8), 0)
        fsa.fused_scan_agg.launches = 0
        agg(fsa.fused_scan_agg, prog, cols, ids, vals, G)
        print(f"fused_scan_agg {name} R={ids.shape[0]} G={G} V={len(vals)} "
              f"kept={kept}: launches={fsa.fused_scan_agg.launches} "
              f"ms={cuda_ms(lambda: agg(fsa.fused_scan_agg, prog, cols, ids, vals, G)):.4f} "
              f"bound_ms={b_ms:.4f}")


def host_s(fn, sync, runs: int = 10) -> float:
    """Median host-clock seconds from a synchronised start until ``fn``
    has returned and then ``sync`` has."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def time_bitmap_apply(dev, seed):
    from chip_smoke import bits, bound, check, cuda_ms, fig3_columns, nbytes
    from repro_torch.core import bitmap
    from repro_torch.kernels import bitmap_apply as ba
    from repro_torch.kernels import ref
    from repro_torch.kernels.program import program_for
    from repro_torch.queryproc import queries

    cat = lineitem_catalog(dev, seed)
    parts = [p.data for p in cat.partitions_of("lineitem")]
    plan = queries.build_query("Q19").plans["lineitem"]
    uncached, cached = fig3_columns(plan)
    words, _ = bitmap.storage_side_bitmap_batched(parts, plan.predicate,
                                                  uncached)
    li = cat.scan_table("lineitem", ["l_extendedprice"] + [
        c for c in sorted(set(program_for(plan.predicate, parts[0].cols)
                              .columns))]).cols
    prog = program_for(plan.predicate, li)
    keep0 = ref.unpack_bitmap(words[0], len(parts[0]))
    shapes = [(f"one partition {c} {parts[0].cols[c].dtype}", words[0],
               parts[0].cols[c]) for c in ("l_extendedprice", "l_partkey")]
    shapes += [(f"one partition {c} from row 1", ref.pack_bitmap(keep0[1:]),
                parts[0].cols[c][1:]) for c in ("l_extendedprice",
                                                "l_partkey")]
    shapes.append(("60M rows l_extendedprice", ref.predicate_bitmap(
        prog, [li[c] for c in prog.columns]), li["l_extendedprice"]))
    for name, w, col in shapes:
        masked, count = ba.bitmap_apply(w, col)
        pmasked, pcount = ref.bitmap_apply(w, col)
        check(torch.equal(bits(masked), bits(pmasked))
              and int(count) == int(pcount), name)
        b_ms, _ = bound(nbytes(w) + int(pcount) * col.element_size()
                        + nbytes(col), 0)
        print(f"bitmap_apply {name} R={col.shape[0]} kept={int(pcount)}: "
              f"ms={cuda_ms(lambda: ba.bitmap_apply(w, col)):.4f} "
              f"bound_ms={b_ms:.4f}")
    # the card's write rate, the bound's main term: zero 480 MB
    big = torch.empty(60_000_000, dtype=torch.float64, device=dev)
    print(f"write yardstick: zero_ of {big.numel() * 8} bytes "
          f"ms={cuda_ms(big.zero_):.4f} bound_ms={bound(big.numel() * 8, 0)[0]:.4f}")
    del big
    tabs = [p.select(cached) for p in parts]
    masked, counts = bitmap.apply_bitmap_to_cache(tabs, words)
    for p, (t, m, w) in enumerate(zip(tabs, masked, words)):
        for c in cached:
            pm, pc = ref.bitmap_apply(w, t.cols[c])
            check(torch.equal(bits(m.cols[c]), bits(pm))
                  and int(counts[p]) == int(pc), f"Fig-3 partition {p} {c}")
    kept = int(counts.sum())
    b_ms, _ = bound(nbytes(*words) + kept * sum(
        tabs[0].cols[c].element_size() for c in cached)
        + sum(nbytes(*t.cols.values()) for t in tabs), 0)
    ba.bitmap_apply.launches = 0
    bitmap.apply_bitmap_to_cache(tabs, words)
    launches = ba.bitmap_apply.launches
    call = lambda: bitmap.apply_bitmap_to_cache(tabs, words)  # noqa: E731
    print(f"bitmap_apply Fig-3 Q19 apply, {len(tabs)} partitions x "
          f"{cached}, kept={kept}: launches={launches} "
          f"ms={cuda_ms(call):.4f} bound_ms={b_ms:.4f} "
          f"host_call_ms={host_s(call, lambda: None) * 1e3:.4f} "
          f"host_to_done_ms={host_s(call, torch.cuda.synchronize) * 1e3:.4f}")


def time_fused_scan_shuffle(dev, seed):
    from chip_smoke import POOLED_VALUES, bound, check, cuda_ms, nbytes
    from repro_torch.kernels import fused_scan_shuffle as fss
    from repro_torch.kernels import program, ref
    from repro_torch.queryproc import queries
    from repro_torch.queryproc.expressions import Col

    cat = lineitem_catalog(dev, seed)
    need = ["l_quantity", "l_shipmode", "l_shipinstruct", "l_shipdate",
            "l_orderkey", "l_partkey"]
    li = cat.scan_table("lineitem", need).cols
    part = cat.partitions_of("lineitem")[0].data.cols
    keys = li["l_orderkey"]
    q19 = queries.build_query("Q19").plans["lineitem"].predicate
    cases = [(q, queries.build_query(q).plans["lineitem"].predicate, li, 4)
             for q in ("Q19", "Q3")]
    cases += [("Q19 P=9", q19, li, 9), ("Q19 P=8192", q19, li, 8192),
              ("Q19 int64 keys", q19, {**li, "l_orderkey": keys.to(
                  torch.int64) | (1 << 40)}, 4),
              ("Q19 one partition from row 1", q19,
               {c: part[c][1:] for c in need}, 4)]
    if hasattr(program, "K_IN_POOL"):
        gen = torch.Generator().manual_seed(512)
        hi = int(li["l_partkey"].max()) + 1
        vals = torch.randperm(hi, generator=gen)[:POOLED_VALUES].tolist()
        cases.append(("512-value pooled In", Col("l_partkey").isin(vals),
                      li, 4))
    for name, pred, t, P in cases:
        prog = program.program_for(pred, t)
        cols, k = [t[c] for c in prog.columns], t["l_orderkey"]
        out = fss.fused_scan_shuffle(prog, cols, k, P)
        check(all(torch.equal(a, b) for a, b in zip(
            out, ref.fused_scan_shuffle(prog, cols, k, P))), name)
        b_ms, _ = bound(nbytes(*cols, k, *out), k.shape[0] * (prog.n_ops + 3))
        ms = cuda_ms(lambda: fss.fused_scan_shuffle(prog, cols, k, P))
        launch = getattr(fss.fused_scan_shuffle, "last_launch", None)
        print(f"fused_scan_shuffle {name} R={k.shape[0]} {prog.n_ops} "
              f"ops: ms={ms:.4f} bound_ms={b_ms:.4f} launch={launch}")


def time_engine(dev, seed, repeats):
    from chip_smoke import CONFIGS
    from repro_torch.core import engine as eng
    from repro_torch.core.cost import StorageResources
    from repro_torch.kernels import _build
    from repro_torch.queryproc import queries

    _build.build_all()
    cat = lineitem_catalog(dev, seed)
    for p in cat.iter_partitions():
        p.data.stats()
    seed_qids = ("Q1", "Q3", "Q6", "Q12", "Q19")
    legacy = getattr(queries, "build_query_legacy", queries.build_query)

    def hand_built(qid, cfg):
        return eng.run_query(legacy(qid), cat, cfg)

    def alloc_counts():
        st = torch.cuda.memory_stats()
        return [st.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                       "num_alloc_retries")] + [
            gc.get_stats()[2]["collections"]]

    def walls(label, run, qids, configs=CONFIGS, warm=True):
        for qid in qids:
            for mode, power in configs:
                cfg = eng.EngineConfig(res=StorageResources(
                    storage_power=power), mode=mode, device=dev)
                if warm:
                    run(qid, cfg)
                before, ts = alloc_counts(), []
                for _ in range(repeats):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run(qid, cfg)
                    torch.cuda.synchronize()
                    ts.append(time.perf_counter() - t0)
                allocs, frees, retries, gcs = (a - b for a, b in
                                               zip(alloc_counts(), before))
                print(f"engine {label} {qid} {mode} {power}: walls_s="
                      f"{[round(t, 4) for t in ts]} "
                      f"median_s={statistics.median(ts):.4f} "
                      f"device_allocs={allocs} device_frees={frees} "
                      f"alloc_retries={retries} gc_full_collections={gcs} "
                      f"reserved_gb="
                      f"{torch.cuda.memory_reserved() / 1e9:.2f}")

    walls("hand-built", hand_built, seed_qids)
    if not hasattr(eng, "compile_and_run"):
        return
    from repro_torch.compiler import QUERY_IDS, compile_query
    print(f"engine compile_query Q1 host_ms="
          f"{host_s(lambda: compile_query('Q1'), lambda: None) * 1e3:.4f}")
    def compiled(qid, cfg):
        return eng.compile_and_run(qid, cat, cfg)

    walls("compiled", compiled, seed_qids)
    for qid in QUERY_IDS:
        for mode, power in CONFIGS:
            compiled(qid, eng.EngineConfig(res=StorageResources(
                storage_power=power), mode=mode, device=dev))
    torch.cuda.synchronize()
    walls("compiled after all 15 queries", compiled, ["Q1"], warm=False)
    torch.cuda.empty_cache()
    walls("compiled after empty_cache", compiled, ["Q1"], CONFIGS[:1],
          warm=False)


def time_cache(dev, seed, repeats):
    from repro_torch.compiler import QUERY_IDS
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import EngineConfig, run_query
    from repro_torch.core.result_cache import ResultCache
    from repro_torch.kernels import _build
    from repro_torch.queryproc import queries

    _build.build_all()
    cat = lineitem_catalog(dev, seed)
    for p in cat.iter_partitions():
        p.data.stats()
    cfg = EngineConfig(res=StorageResources(storage_power=1.0), mode="eager",
                       device=dev)

    def timed(fn):
        ts = []
        for _ in range(repeats):
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return ts

    def device_ms(fn):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        return device_ms_of(prof)

    def host_top(fn, n=8):
        pr = cProfile.Profile()
        pr.enable()
        fn()
        torch.cuda.synchronize()
        pr.disable()
        st = pstats.Stats(pr)
        rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:n]
        return "; ".join(f"{os.path.basename(f)}:{name} {tt * 1e3:.2f} ms"
                         for (f, _l, name), (_c, _n, tt, _ct, _cl) in rows)

    for qid in QUERY_IDS:
        q = queries.build_query(qid)
        cache = ResultCache(2 << 30)
        warm_cfg = dataclasses.replace(cfg, result_cache=cache)
        run_query(q, cat, cfg)
        uncached = timed(lambda: run_query(q, cat, cfg))
        run_query(q, cat, warm_cfg)
        warm = timed(lambda: run_query(q, cat, warm_cfg))
        mu, mw = statistics.median(uncached), statistics.median(warm)
        print(f"cache {qid} eager: uncached walls_s="
              f"{[round(t, 4) for t in uncached]} median_s={mu:.4f}; warm "
              f"walls_s={[round(t, 4) for t in warm]} median_s={mw:.4f}; "
              f"warm/uncached={mw / mu:.3f}; device_ms uncached "
              f"{device_ms(lambda: run_query(q, cat, cfg)):.3f} warm "
              f"{device_ms(lambda: run_query(q, cat, warm_cfg)):.3f}")
        if qid in ("Q1", "Q3", "Q14"):
            for label, c in (("uncached", cfg), ("warm", warm_cfg)):
                print(f"cache {qid} {label} host top by self time: "
                      f"{host_top(lambda: run_query(q, cat, c))}")
        cache.clear()


def time_residual(dev, seed, repeats):
    from repro_torch.compiler import QUERY_IDS, compile_query
    from repro_torch.core.arbitrator import PUSHDOWN
    from repro_torch.core.engine import plan_requests
    from repro_torch.core.runtime import execute_split, run_residual
    from repro_torch.kernels import _build

    _build.build_all()
    cat = lineitem_catalog(dev, seed)

    def median_s(fn):
        ts = []
        for _ in range(repeats):
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    def device(fn, n=6):
        """(device ms of one call, its n operators with the most device
        time)."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type != torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
        top = "; ".join(f"{e.key[:48]} x{e.count} "
                        f"{e.self_device_time_total / 1e3:.3f} ms"
                        for e in ops[:n])
        ga = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(k in e.key for k in GROUPED_AGG_KERNELS)) / 1e3
        return device_ms_of(prof), f"{top}; grouped_agg kernels {ga:.3f} ms"

    def host_top(fn, n=6):
        pr = cProfile.Profile()
        pr.enable()
        fn()
        torch.cuda.synchronize()
        pr.disable()
        rows = sorted(pstats.Stats(pr).stats.items(),
                      key=lambda kv: -kv[1][2])[:n]
        return "; ".join(f"{os.path.basename(f)}:{name} {tt * 1e3:.2f} ms"
                         for (f, _l, name), (_c, _n, tt, _ct, _cl) in rows)

    for qid in QUERY_IDS:
        q = compile_query(qid)
        reqs = plan_requests(q, cat)
        merged = execute_split(reqs, {r.req_id: PUSHDOWN for r in reqs}).merged
        interp = functools.partial(run_residual, q, merged, "interpreter")
        tensor = functools.partial(run_residual, q, merged, "tensor")
        interp()
        tensor()                                     # observes
        _, cold = tensor()
        ti, tt = median_s(interp), median_s(tensor)
        di, _ = device(interp)
        dt, top = device(tensor)
        print(f"residual {qid}: merged_rows="
              f"{sum(len(t) for t in merged.values())} interpreter "
              f"median_ms={1e3 * ti:.4f} device_ms={di:.4f}; tensor "
              f"median_ms={1e3 * tt:.4f} device_ms={dt:.4f} "
              f"(fell_back={cold.fell_back}); tensor/interpreter="
              f"{tt / ti:.3f}")
        print(f"residual {qid} tensor device top: {top}")
        print(f"residual {qid} tensor host top by self time: "
              f"{host_top(tensor)}")
        del merged


def time_jitter(dev, seed, repeats):
    from chip_smoke import agree, bits, identical
    from repro_torch.compiler import QUERY_IDS
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import EngineConfig, run_query
    from repro_torch.core.result_cache import ResultCache
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_scan_agg as fsa
    from repro_torch.kernels.program import program_for
    from repro_torch.queryproc import operators, queries

    _build.build_all()
    cat = lineitem_catalog(dev, seed)
    parts = cat.partitions_of("lineitem")
    li = cat.scan_table("lineitem", ["l_shipdate", "l_discount",
                                     "l_quantity", "l_extendedprice"]).cols
    seg = torch.repeat_interleave(
        torch.arange(len(parts), device=dev),
        torch.as_tensor([len(p.data) for p in parts], device=dev))
    plan = queries.build_query("Q6").plans["lineitem"]
    ids, G, _ = operators.group_ids([], lead=seg, lead_size=len(parts))
    prog = program_for(plan.predicate, li)
    cols = [li[c] for c in prog.columns]
    vals = [li["l_extendedprice"] * li["l_discount"]]
    runs = [fsa.fused_scan_agg(prog, cols, ids, vals, G)[0][0]
            for _ in range(repeats)]
    first = runs[0]
    moved = torch.zeros(G, dtype=torch.bool, device=dev)
    rel = 0.0
    for s in runs[1:]:
        moved |= bits(s) != bits(first)
        rel = max(rel, float(((s - first).abs() / first.abs().clamp(
            min=1e-300)).max()))
    print(f"jitter fused_scan_agg Q6 keyless R={ids.shape[0]} G={G}: "
          f"{len({bits(s).cpu().numpy().tobytes() for s in runs})} distinct "
          f"results in {repeats} launches, {int(moved.sum())} of {G} groups "
          f"moved, largest relative move {rel:.3e}")
    del runs, vals, cols, li, seg, ids

    def cfg(cache=None, mode="eager", power=1.0):
        return EngineConfig(res=StorageResources(storage_power=power),
                            mode=mode, device=dev, result_cache=cache)
    for qid in QUERY_IDS:
        q = queries.build_query(qid)
        results = [run_query(q, cat, cfg()).result for _ in range(repeats)]
        distinct = [results[0]]
        for r in results[1:]:
            if not any(identical(r, d) for d in distinct):
                distinct.append(r)
        how = sorted({agree(results[0], r) for r in results[1:]})
        print(f"jitter {qid} eager uncached: {len(distinct)} distinct "
              f"results in {repeats} runs; against the first: {how}")
        del results, distinct

    q6 = queries.build_query("Q6")
    tally = {}
    for _ in range(repeats):
        base = run_query(q6, cat, cfg(None, "eager", 0.01)).result
        cache = ResultCache(2 << 30)
        flips = [run_query(q6, cat, cfg(cache, mode, 0.01)).result
                 for mode in ("adaptive", "eager", "adaptive")]
        key = (tuple(agree(base, f) for f in flips),
               identical(flips[1], flips[2]))
        tally[key] = tally.get(key, 0) + 1
        cache.clear()
    for (how, served), n in sorted(tally.items()):
        print(f"jitter Q6 warm flip at storage power 0.01: {n} of {repeats} "
              f"repetitions: cold adaptive/eager/warm adaptive against the "
              f"uncached run {'/'.join(h or 'differ' for h in how)}; warm "
              f"adaptive bitwise to the eager fill: {served}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=("grouped_agg", "predicate_bitmap",
                                       "fused_scan_agg", "bitmap_apply",
                                       "fused_scan_shuffle", "engine",
                                       "cache", "residual", "jitter"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed runs a configuration (engine, cache, "
                    "residual), or runs a comparison (jitter)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.append(os.path.join(ROOT, "src"))
    import repro_torch
    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    if args.kernel == "predicate_bitmap":
        time_predicate_bitmap(dev, args.seed)
    elif args.kernel == "fused_scan_agg":
        time_fused_scan_agg(dev, args.seed)
    elif args.kernel == "bitmap_apply":
        time_bitmap_apply(dev, args.seed)
    elif args.kernel == "fused_scan_shuffle":
        time_fused_scan_shuffle(dev, args.seed)
    elif args.kernel == "engine":
        time_engine(dev, args.seed, args.repeats)
    elif args.kernel == "cache":
        time_cache(dev, args.seed, args.repeats)
    elif args.kernel == "residual":
        time_residual(dev, args.seed, args.repeats)
    elif args.kernel == "jitter":
        time_jitter(dev, args.seed, args.repeats)
    else:
        time_grouped_agg(dev, torch.Generator(device=dev).manual_seed(
            args.seed), torch.cuda.get_device_properties(dev)
            .multi_processor_count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
