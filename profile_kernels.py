#!/usr/bin/env python3
"""Time the alternatives of the redesigned kernels on one GPU.

    python3 profile_kernels.py {grouped_agg,predicate_bitmap,fused_scan_agg,
                                bitmap_apply} [--seed 0]

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
"""
from __future__ import annotations

import argparse
import os
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=("grouped_agg", "predicate_bitmap",
                                       "fused_scan_agg", "bitmap_apply"))
    ap.add_argument("--seed", type=int, default=0)
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
    else:
        time_grouped_agg(dev, torch.Generator(device=dev).manual_seed(
            args.seed), torch.cuda.get_device_properties(dev)
            .multi_processor_count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
