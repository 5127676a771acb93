#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
It exits non-zero, and prints no result line, on any failure and when no
GPU is present. Phases:

1. Card and build: prints the card's name and power limit, then builds the
   CUDA kernels (``repro_torch.kernels._build``) from ``src/`` with nvcc.
2. Kernels: holds each CUDA kernel against its plain torch version on the
   card, at the shapes the main path gives it (60M lineitem rows), and times the kernel, the plain version and, where one
   PyTorch call computes the same function, that call, with CUDA events.
3. Engine: builds the TPC-H catalog at ``SF`` = 1000 (TPC-H SF10's row
   counts: 60M lineitem rows in 100 partitions over 4 storage nodes)
   on the card and runs Q1, Q3, Q6, Q12 and Q19 through
   ``repro_torch.core.engine.run_query`` in the no_pushdown, eager and
   adaptive modes at storage_power 1.0 and adaptive at 0.1. All modes must
   agree, Q1 and Q6 must agree with an independent torch evaluation over
   the whole lineitem table, and at power 0.1 Q1 and Q3 must split between
   pushdown and pushback. Every kernel of the path must have launched.
4. Prints the per-kernel JSON line and, last, the ``{"ok": true, ...}``
   line.
"""
from __future__ import annotations

import argparse
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
REPLACES = {"predicate_bitmap": "src/repro/kernels/predicate_bitmap.py:42",
            "fused_scan_agg": "src/repro/kernels/fused_scan_agg.py:56",
            "grouped_agg": "src/repro/kernels/grouped_agg.py:48"}
SOURCES = {"predicate_bitmap": "src/repro_torch/kernels/csrc/predicate_bitmap.cu",
           "fused_scan_agg": "src/repro_torch/kernels/csrc/fused_scan_agg.cu",
           "grouped_agg": "src/repro_torch/kernels/csrc/fused_scan_agg.cu"}


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


# ------------------------------------------------------------ kernel phase
def kernel_phase(cat, timer):
    """Hold each kernel against its plain version at the main path's shapes;
    returns ``{name: record}`` for the JSON line plus extra case lines."""
    from repro_torch.core.executor import compile_push_plan
    from repro_torch.kernels import fused_scan_agg as fsa
    from repro_torch.kernels import grouped_agg as ga
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
                     "l_discount"})
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
        parts = compile_push_plan(plan).execute_batch_parts(
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

    launches = engine_phase(cat, torch.cuda.synchronize)
    print("kernels: " + "; ".join(f"{n} check=ok launches={launches[n]}"
                                  for n in records))
    for n in records:
        check(launches[n] > 0, f"{n} never launched on the engine path")
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
