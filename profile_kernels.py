#!/usr/bin/env python3
"""Time the alternatives of the redesigned kernels on one GPU.

    python3 profile_kernels.py {grouped_agg,predicate_bitmap} [--seed 0]

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
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=("grouped_agg", "predicate_bitmap"))
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
    else:
        time_grouped_agg(dev, torch.Generator(device=dev).manual_seed(
            args.seed), torch.cuda.get_device_properties(dev)
            .multi_processor_count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
