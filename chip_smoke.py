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
   ``predicate_bitmap`` is also timed on one 600,000-row lineitem
   partition (the shape of the Fig-4 launches). ``fused_scan_agg`` runs
   Q1's four sums in one launch, and Q1 with one sum and Q6 beside it.
   Q18's pushed aggregate (no predicate, about 58.8M groups) beside them.
   ``bitmap_apply`` runs Q19's whole Fig-3 apply (100 partitions x 3
   cached columns) in one launch, and one partition's columns and the
   60M-row ``l_extendedprice`` beside it. ``grouped_agg`` runs at
   three shapes (Q3's residual, 60M random ids over the same groups, Q18's
   group-by of lineitem by ``l_orderkey``) and prints the regime that
   ``grouped_agg.plan`` picks for each (``profile_kernels.py`` times the
   other regimes). A 512-value ``In`` over all of ``l_partkey`` (pooled:
   a sorted list on the card that each row binary-searches) runs through
   ``predicate_bitmap``, ``fused_scan_agg`` and ``fused_scan_shuffle``,
   and a nine-column AND (two programs) through the executor's split
   route. ``fused_scan_shuffle`` runs Q3's and Q19's predicates, Q19's
   also with int64 keys and on one partition's view from its row 1, and
   prints each launch's blocks, stages, shared bytes and whether its
   pooled lists were staged in shared memory.
3. Engine: builds the TPC-H catalog at ``SF`` = 1000 (TPC-H SF10's row
   counts: 60M lineitem rows in 100 partitions over 4 storage nodes)
   on the card and runs all 15 queries through
   ``repro_torch.core.engine.compile_and_run`` in the no_pushdown, eager
   and adaptive modes at storage_power 1.0 and adaptive at 0.1, printing
   each run's wall time, split, real bytes and peak device memory, and the
   regimes ``grouped_agg`` ran in. All modes must agree; Q1, Q6 and Q18
   must agree with an independent torch evaluation over the whole tables;
   at power 0.1 Q1 and Q3 must split between pushdown and pushback; the
   splits and bytes of Q1, Q3, Q6, Q12 and Q19 are compared with the hand-
   built plans' (``PR14_ADAPTIVE_LOW``).
4. Tensor: the residual's tensor backend (``EngineConfig.residual=
   "tensor"``) on the same catalog. Each query compiled once, one
   observe pass through ``run_query``, the interpreter's and the tensor
   backend's residual times on the eager merged tables (medians of 5),
   stages, each aggregate's ``code``/``lex`` and each join's
   ``lut``/``sorted`` lowering and the ``grouped_agg`` launches and
   regimes, each of the stages' ``grouped_agg`` calls in the cold run held
   to the plain version at its shape (every query with a keyed sum, mean
   or count calls it; ``code`` and ``lex`` aggregates both held); the
   four configs warm (no fallback, no program missed), each
   agreeing with the engine phase's interpreter run bitwise or in rows;
   the calibrated crossover, ``residual="auto"`` runs of Q1 and Q18, and
   the stream phase's stream with the tensor backend; no
   ``residual.errors``.
5. Costed: every query through ``compile_and_run(cost_based=True)`` in
   the same four configurations, each equal to its maximal-frontier
   result, with each table's chosen and maximal cut, scores, bitmap
   exchange and lowered predicate; the ``CardinalityCorrector`` learning
   from Q18 and Q4 run eager twice, and Q18's lineitem cut before and
   after it; all 15 queries through ``run_concurrent`` in adaptive_pa at
   power 0.1; each query's oracle splits (``theoretical_split``,
   ``optimum.simulated_optimum``, Eq 6) at power 0.1 beside adaptive's.
6. Compiler: a second catalog from the same arrays, lineitem clustered by
   ``l_orderkey``. Q18 compiled for it pushes its HAVING and must equal
   Q18 on the first catalog; a custom IR's ``TopK`` absorbed over a
   filtered lineitem scan must equal ``torch.topk`` over the whole table;
   a custom IR's pushed min/max aggregate must equal ``scatter_reduce``
   over the whole table. ``predicate_bitmap`` is timed on the HAVING
   program over the clustered partial aggregate. The catalog is dropped
   before the next phase.
7. §4.2 operators on the first catalog: the Fig-3 storage-side bitmap with
   the cached columns masked by ``bitmap_apply``, the Fig-4 compute-side
   bitmap, the storage-side shuffle of lineitem and orders against the
   compute-side one, the shuffle plans of Q3, Q12 and Q19 with their
   position vectors, and engine runs with bitmap-recosted requests and
   with shuffle pushdown. Every result is held to the plain operators,
   bitwise. The host-clock time of each ``apply_bitmap_to_cache`` call is
   printed alone (until it returns, and until the card is done).
8. Result cache on the first catalog: every query eager uncached, cold
   and warm through a fresh ``ResultCache`` (2 GiB), both cached results
   equal to the uncached one: bitwise, or in rows with sums within
   ``SUM_RTOL`` when the query's uncached runs also differ in bits (the
   kernels add f64 sums in atomic order; ``Jitter`` reruns every query
   uncached as that control and says which held), the warm run's
   served partitions equal to the ``cache.hit`` counter's move; the device
   bytes allocated before the fill, after it and after ``clear()``; each
   query's tightened variant served by containment; Q3 at the default
   256 MiB budget (evictions); Q6's warm flip at storage power 0.01;
   appends to a small catalog of its own never serving stale rows (in
   rows: the claim there is freshness); a §4.2
   shuffle plan cold and warm, slices and position vectors bitwise.
9. Faults: every query adaptive under ``CHAOS_SPEC`` (seed: the query's
   number) with ``RetryPolicy(sleep_scale=0.0)`` and a ``CircuitBreaker``,
   equal to its clean run (under the same control), ``n_pushdown +
   n_demoted == n_admitted``, the ``faults.*`` counters equal to the
   plan's ledger; the §4.2 shuffle
   plans of Q3 and Q18 (``fused_scan_shuffle``, ``hash_partition``)
   split under the same plan; Q6 under a certain pushdown crash; the
   fail-to-error baseline raising ``FaultExhausted``.
10. Stream: all 15 queries, and Q6 again (``Q6#1``), arriving
   ``STREAM_GAP_S`` apart through ``repro_torch.core.runtime.run_stream``
   in the four configs, each result held to its query's uncached
   ``compile_and_run`` (under the same control), ``n_pushdown +
   n_demoted`` to the simulation's admitted count and the per-query bytes
   to the stream's; then the same stream under ``CHAOS_SPEC`` with real
   sleeps and ``HedgePolicy(fixed_delay_s=HEDGE_DELAY_S)``, whose hedges
   must fire and add up (``won + lost == launched``). Walls and peak
   device memory per stream.
11. Trace: one adaptive stream traced into a ``JsonlStreamWriter`` and a
   Chrome trace (in a temporary directory) under ``torch.profiler``: each
   span name's self time (``span_attribution``), the device's busy time
   and idle share (``1 - busy / wall``) over the same window; then the
   stream untraced and traced five times each, ``gc.collect()`` before
   every run, and their medians.
12. Process tier: one spawned storage-worker process per node (4), each
   holding its node's partitions on the card (shipped over the wire
   codec) and running the kernels on them; spawn and ship times, and the
   device memory in use across the card (``mem_get_info``) before
   spawning, after shipping and after the pools close. Every query
   through ``compile_and_run`` with ``worker_pool`` in eager 1.0,
   adaptive 1.0 and adaptive 0.1, each held to its in-process run (the
   result under the same control, split and real bytes equal; walls and
   ``wire.*`` bytes printed); every query's seed-7 random decision vector
   and the shuffle plans of Q3 and Q18 through ``execute_split(tier=)``;
   the stream phase's stream on the tier (measured load from worker
   polls) beside the in-process stream; on a fresh pool the same stream
   with node 0 killed mid-stream (recovered; ``faults.*`` equal to
   ``pool.events``); one traced split whose worker spans carry the
   workers' pids; Q6 failing to error without demotion once the first
   pool's node 0 dies. A hang past ``TIER_DEADLINE_S`` ends the script.
13. Pipeline: the pushdown data pipeline (``repro_torch.data.pipeline``)
   over a corpus of ``PIPE_CORPUS`` (64 partitions of 2048 documents of
   2048 tokens, 268,435,456 int32 tokens uploaded once) with the
   trainer's ``PIPE_QUERY`` (quality and domain filter, 8 DP ranks,
   batches (4, 8, 2048)): every partition's ``fused_scan_shuffle`` launch
   held bitwise to the plain version and timed; one epoch of batches and
   one more drawn, its launches counted and equal to what the epoch's
   histograms need; the first ``PIPE_CPU_BATCHES`` held bitwise to the
   same pipeline on the CPU; ``stats()`` in no_pushdown, eager and
   adaptive at storage power 1.0 and 0.1, each giving the same batch.
14. Serve: ``SERVE_ARCH`` (olmo-1b, 16 layers, d_model 2048, vocab 50304,
   1,176,764,416 parameters) drawn on the card; ``loss_fn`` over the
   pipeline's first two batches, microbatch by microbatch (8, 2048),
   within (0.5, 3) ln V; a 2048-token prefill blocked with and without
   ``causal_skip`` against the materialized one; a decode step against
   forward; a ``ServingEngine`` (``SERVE``) over ``SERVE_REQUESTS``
   prompts of 96 to 320 pipeline tokens, ``SERVE_MAX_NEW`` new each: two
   chunked waves and a batched one; the chunked prefill's last logits
   against the batched one's; decode steps timed. Then the other three
   families at their published widths (``FAMILIES``), one at a time and
   freed after: mamba2-2.7b (64 SSD layers), recurrentgemma-2b (8 x
   (rec, rec, attn) + (rec, rec), window 2048, vocab 256,000) and
   whisper-small (12 + 12 layers over 1500 frames), each with parameters
   drawn on the card from the seed and ``count_params`` equal to the
   published count: ``loss_fn`` on its batch, a prefill at its length
   and a decode step against forward one token longer, held in fp32 on
   the same parameters (bf16's errors, past the tolerance at these
   depths as the reference's are, printed beside; mamba2's 2049 tokens
   go through the chunk padding; recurrentgemma's 4096-token prefill
   takes ``local_window_attention`` and leaves an aligned ring);
   for mamba2 and recurrentgemma a ``ServingEngine`` (``SERVE``) over
   ``FAMILY_REQUESTS`` prompts, one chunked wave and one batched, and
   decode steps timed at B = 4 (whisper is not served, as the reference's
   engine does not serve it). Token ids are drawn from the seed's
   generator below each vocabulary (mamba2's 50,280 is below the corpus's
   50,304). Last, all ten architectures' reduced configs on the card
   against the CPU. Model checks hold to ``MODEL_TOL``.
15. Train: ``TRAIN_ARCH`` (olmo-1b) at its published width and depth,
   parameters drawn from the seed, fed by the pipeline over the same
   corpus with ``TRAIN_QUERY`` (4 DP ranks, batches (2, 4, 2048); every
   partition's ``fused_scan_shuffle`` launch at P = 4 held bitwise):
   ``make_host_train_step(remat=True)`` for 4 steps on the first three
   batches and the first again, whose loss must fall; ms a step, tokens/s,
   each step's loss, ``grad_norm`` and ``lr``, peak memory. Then a central
   difference of ``loss_fn`` along a random unit direction against
   autograd's ``<grad, d>`` on the trained parameters widened to fp32
   (``grad_check``; the bf16 gradient's distance printed), and at the same
   width cut to ``RESUME_LAYERS`` layers ``train`` straight through 8
   steps against 4 saved and resumed to 8 (final losses within
   ``RESUME_TOL``), the saved state restored bit for bit.
16. Prints each kernel's launches in phases 3 to 15 (all must be above 0,
   and on the tier ``predicate_bitmap``, ``fused_scan_agg`` and the two
   shuffle kernels inside the workers, ``grouped_agg`` in the parent's
   residuals), the per-kernel JSON line and, last, the ``{"ok": true,
   ...}`` line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
KERNEL_QUERIES = ("Q1", "Q3", "Q6", "Q12", "Q19")  # the kernel phase's
CONFIGS = (("no_pushdown", 1.0), ("eager", 1.0), ("adaptive", 1.0),
           ("adaptive", 0.1))
# adaptive at power 0.1 with the hand-built plans: (admitted, pushed back,
# real bytes) of PERF.md section 5 (chip_smoke.py, NVIDIA H100 80GB HBM3,
# 700.00 W). The compiled plans of these five are the same plans, but Q3's
# come in the splitter's table order (lineitem, orders, customer), which
# orders its requests, and the Arbitrator admits in request order
PR14_ADAPTIVE_LOW = {"Q1": (36, 64, 599_001_920), "Q3": (60, 72, 865_100_164),
                     "Q6": (48, 52, 441_604_404), "Q12": (56, 60, 515_923_152),
                     "Q19": (36, 80, 601_183_684)}
CLUSTER = {"lineitem": "l_orderkey"}
NODES, RPP = 4, 600_000       # storage nodes; rows of a lineitem partition
SHUFFLE_TARGETS = 4           # compute nodes of the §4.2 shuffle
CACHE_BUDGET = 2 << 30        # holds one query's pushed results (Q8 eager
#                               ships the most, 1,270,490,848 bytes)
CHAOS_SPEC = "crash:0.25,timeout:0.15,transient:0.2,straggler:0.2:0.001"
STREAM_GAP_S = 0.004          # arrivals of the stream phase's queries
HEDGE_DELAY_S = 0.002         # the chaos stream's fixed hedge delay
CONTROL_RUNS = 256            # uncached runs that may show a query's f64
#                               sums moving before "rows" is accepted: Q6's
#                               result moves in about 1 run of 15 (2
#                               distinct results in 30 runs, and 3 of 30
#                               warm flips, profile_kernels.py jitter), so
#                               16 runs missed it about once in three
POOLED_VALUES = 512           # multitable.DOMAIN_MAX_VALUES, the longest
#                               In list the cost-based lowering makes
TIER_CONFIGS = (("eager", 1.0), ("adaptive", 1.0), ("adaptive", 0.1))
TIER_SLOTS = 2                # threads a storage worker runs groups on: the
#                               stream's pools give a node 2 on 8 cores
TIER_DEADLINE_S = 300.0       # the tier phase's own deadline: a hang past it
#                               dumps every thread's stack and exits 1
WIRE_COUNTERS = ("wire.pushdown_result_bytes", "wire.pushback_ship_bytes")
# the pipeline phase: a corpus a 1B-model pretraining feed would read (64
# partitions of 2048 documents of 2048 tokens, 268,435,456 int32 tokens)
# and the trainer's query: batches (accum 4, mb 8, S 2048), 8 DP ranks
PIPE_CORPUS = dict(num_partitions=64, docs_per_part=2048, doc_len=2048,
                   vocab=50304, hosts=4, seed=0)
PIPE_QUERY = dict(min_quality=0.25, domains=(0, 1, 2, 3, 4, 5),
                  seq_len=2048, global_batch=32, accum=4, dp_ranks=8)
PIPE_CPU_BATCHES = 4          # batches held to the CPU pipeline's
PIPE_PLAIN_TIMED = 4          # partitions whose plain version is timed
PIPE_MODES = ("no_pushdown", "eager", "adaptive")
PIPE_POWERS = (1.0, 0.1)
# the serve phase: olmo-1b at full width, the engine's waves of 4 (two
# chunked, the last of 2 batched)
SERVE_ARCH = "olmo-1b"
SERVE = dict(max_batch=4, max_len=512, prefill_chunk=64)
SERVE_REQUESTS = 10
SERVE_PROMPT = (96, 320)      # prompt lengths, cut from pipeline rows
SERVE_MAX_NEW = 32
MODEL_TOL = 2e-2              # rtol = atol on bf16 logits: the JAX
#                               package's model tests' tolerance
# the serve phase's other families at their published widths: the loss
# batch (B, S) and the prefill length (a decode step follows at it)
FAMILIES = {"mamba2-2.7b": dict(loss=(2, 2048), prefill=2048),
            "recurrentgemma-2b": dict(loss=(1, 4096), prefill=4096),
            "whisper-small": dict(loss=(2, 448), prefill=447)}
PUBLISHED_PARAMS = {"mamba2-2.7b": 2_702_235_136,
                    "recurrentgemma-2b": 2_894_528_000,
                    "whisper-small": 277_940_736}
FAMILY_REQUESTS = 6           # one chunked wave of 4, one batched of 2
FAMILY_MAX_NEW = 16
# the train phase: olmo-1b at its published width and depth (1,176,764,416
# parameters) trained on the pipeline's corpus in batches (accum 2, mb 4,
# S 2048) for 4 DP ranks with remat; the first batch comes back at step 4
TRAIN_ARCH = "olmo-1b"
TRAIN_PARAMS = 1_176_764_416
TRAIN_QUERY = dict(PIPE_QUERY, global_batch=8, accum=2, dp_ranks=4)
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=4)
TRAIN_ORDER = (0, 1, 2, 0)    # the batch each step takes
GRAD_SHAPE = (1, 512)         # the directional-derivative check's batch
GRAD_STEP = 2e-3              # its central difference's step h along a unit
#                               direction, as a share of the parameters' norm
#                               (h ~ 0.9 for olmo-1b, ~3e-5 an entry)
GRAD_ULPS = 4                 # fp32 rounding allowed in the loss at a point
GRAD_REL = 1e-3               # the fp32 gradient's own rounding and the
#                               step's h^2 truncation, relative
RESUME_LAYERS = 2             # the resume check's depth cut (a full-depth
#                               save writes ~12 GB)
RESUME_STEPS = (4, 8)         # saved at the first, resumed to the second
RESUME_TOL = 5e-2             # tests/test_substrate.py's resume tolerance
REPLACES = {"predicate_bitmap": "src/repro/kernels/predicate_bitmap.py:42",
            "fused_scan_agg": "src/repro/kernels/fused_scan_agg.py:56",
            "grouped_agg": "src/repro/kernels/grouped_agg.py:48",
            "bitmap_apply": "src/repro/kernels/bitmap_apply.py:34",
            "hash_partition": "src/repro/kernels/hash_partition.py:38",
            "fused_scan_shuffle": "src/repro/kernels/fused_scan_shuffle.py:62"}
_CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"predicate_bitmap": _CSRC + "predicate_bitmap.cu",
           "fused_scan_agg": _CSRC + "fused_scan_agg.cu",
           "grouped_agg": _CSRC + "grouped_agg.cu",
           "bitmap_apply": _CSRC + "bitmap_apply.cu",
           "hash_partition": _CSRC + "shuffle.cu",
           "fused_scan_shuffle": _CSRC + "shuffle.cu"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, launches: int = 10, batches: int = 3) -> float:
    """Median time of single calls after a warm-up call: ``batches`` batches
    of ``launches`` back-to-back calls, each call between its own pair of
    CUDA events. A sleep kernel ahead of each batch, twice as long as the
    host took to issue the warm-up call ``launches`` times (at least 20M
    cycles), lets the host queue the whole batch first, so a kernel's time
    is its device time and not its launch overhead; a function that
    synchronises inside pays its host time as it would on the path."""
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # cycles at the H100's 1.98 GHz boost clock: a slower clock sleeps longer
    cycles = max(20_000_000, int(2 * launches * host_s * 1.98e9))
    times = []
    for _ in range(batches):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(launches + 1)]
        torch.cuda._sleep(cycles)
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
    returns ``{name: record}`` for the JSON line plus extra records (other
    shapes, each with its kernel's ``name``)."""
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

    li_plans = {q: queries.build_query(q).plans["lineitem"]
                for q in KERNEL_QUERIES}
    need = sorted(set().union(*(columns_of(p.predicate)
                                for p in li_plans.values()))
                  | {"l_returnflag", "l_linestatus", "l_extendedprice",
                     "l_discount", "l_tax", "l_orderkey", "l_partkey"})
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
    # the same program on one partition, as the Fig-4 compute side runs it
    pcols = [cat.partitions_of("lineitem")[0].data.cols[c]
             for c in prog.columns]
    pwords = pb.predicate_bitmap(prog, pcols)
    check(torch.equal(pwords, ref.predicate_bitmap(prog, pcols)),
          "predicate_bitmap Q19 on one partition: words differ")
    b_ms, b_by = bound(nbytes(*pcols) + nbytes(pwords),
                       pcols[0].shape[0] * prog.n_ops)
    lines.append(dict(
        name="predicate_bitmap", max_abs_err=0.0,
        ms=timer(lambda: pb.predicate_bitmap(prog, pcols)),
        plain_ms=timer(lambda: ref.predicate_bitmap(prog, pcols)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"Q19 lineitem predicate, one partition, "
              f"R={pcols[0].shape[0]}, {prog.n_ops} ops"))

    # fused_scan_agg: Q1's partial agg (partition, returnflag, linestatus)
    # with its four sums in one launch (the record), then Q1 with one sum
    # (the one-value launch of earlier versions) and Q6's keyless one
    li_parts = [p.data for p in cat.partitions_of("lineitem")]
    n_parts = len(li_parts)
    seg = torch.repeat_interleave(
        torch.arange(n_parts, device=li["l_shipdate"].device),
        torch.as_tensor([len(p) for p in li_parts],
                        device=li["l_shipdate"].device))
    q1 = li_plans["Q1"]
    q1_cols = dict(li)
    for name, incols, fn in q1.derive:
        q1_cols[name] = fn(*[li[c] for c in incols])
    q1_vals = [q1_cols[c] for _o, f, c in q1.agg[1] if f == "sum"]
    for case, q, keys, vals in (
            ("Q1 partial agg, four sums", "Q1", q1.agg[0], q1_vals),
            ("Q1 partial agg, one sum", "Q1", q1.agg[0],
             [li["l_extendedprice"]]),
            ("Q6 partial agg, one sum", "Q6", [],
             [li["l_extendedprice"] * li["l_discount"]])):
        ids, G, _ = operators.group_ids([li[k] for k in keys], lead=seg,
                                        lead_size=n_parts)
        prog = program_for(li_plans[q].predicate, li)
        cols = [li[c] for c in prog.columns]
        sums, counts = fsa.fused_scan_agg(prog, cols, ids, vals, G)
        psums, pcounts = ref.fused_scan_agg(prog, cols, ids, vals, G)
        check(torch.equal(counts, pcounts), f"fused_scan_agg {case}: counts differ")
        check(torch.allclose(sums, psums, rtol=SUM_RTOL, atol=0.0),
              f"fused_scan_agg {case}: sums differ beyond rtol {SUM_RTOL}")
        kept, V = int(pcounts.sum()), len(vals)
        # the predicate columns once, ids and values of the kept rows, and
        # G x (8V + 8) bytes of sums and counts (csrc/fused_scan_agg.cu)
        b_ms, b_by = bound(nbytes(*cols) + kept * (4 + sum(
            v.element_size() for v in vals)) + G * (8 * V + 8),
            R * prog.n_ops + kept * (V + 1))
        rec = dict(
            name="fused_scan_agg", max_abs_err=float((sums - psums).abs().max()),
            ms=timer(lambda: fsa.fused_scan_agg(prog, cols, ids, vals, G)),
            plain_ms=timer(lambda: ref.fused_scan_agg(prog, cols, ids, vals, G)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"{case}, R={R}, G={G}, V={V}, kept={kept}")
        if "fused_scan_agg" in records:
            lines.append(rec)
        else:
            records["fused_scan_agg"] = rec
    del q1_cols, q1_vals, vals, sums, psums
    # Q18's pushed aggregate: all of lineitem by (partition, l_orderkey),
    # no predicate; the codes overflow the dense limit, so group_ids
    # compresses them with torch.unique (about 588,000 groups a partition)
    ids, G, _ = operators.group_ids([li["l_orderkey"]], lead=seg,
                                    lead_size=n_parts)
    vals = [li["l_quantity"]]
    sums, counts = fsa.fused_scan_agg(None, (), ids, vals, G)
    psums, pcounts = ref.fused_scan_agg(None, (), ids, vals, G)
    check(torch.equal(counts, pcounts), "fused_scan_agg Q18: counts differ")
    check(torch.allclose(sums, psums, rtol=SUM_RTOL, atol=0.0),
          f"fused_scan_agg Q18: sums differ beyond rtol {SUM_RTOL}")
    b_ms, b_by = bound(nbytes(ids, *vals) + G * 16, 2 * R)
    # with no predicate the function is two bincounts: the sums and counts
    lib = (torch.bincount(ids, weights=vals[0], minlength=G),
           torch.bincount(ids, minlength=G))
    check(torch.equal(lib[1], counts)
          and torch.allclose(lib[0], sums[0], rtol=SUM_RTOL, atol=0.0),
          "fused_scan_agg Q18: bincount disagrees")
    lines.append(dict(
        name="fused_scan_agg", max_abs_err=float((sums - psums).abs().max()),
        ms=timer(lambda: fsa.fused_scan_agg(None, (), ids, vals, G)),
        plain_ms=timer(lambda: ref.fused_scan_agg(None, (), ids, vals, G)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: (
            torch.bincount(ids, weights=vals[0], minlength=G),
            torch.bincount(ids, minlength=G))),
        shape=f"Q18 partial agg, no predicate, R={R}, G={G}, V=1"))
    del lib
    del ids, vals, sums, psums, counts, pcounts

    # grouped_agg: Q3's residual group-by (orderkey, orderdate,
    # shippriority) over the joined pushdown results (the path's shape), then
    # two at lineitem scale: 60M random ids over the same G (the yardstick)
    # and Q18's group-by, all of lineitem by l_orderkey (about 14.7M groups,
    # compressed by torch.unique), each in the regime grouped_agg.plan picks
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
    q18_ids, q18_G, _ = operators.group_ids([li["l_orderkey"]])
    # the H100's 132 SMs stand in for the card's count in the CPU rehearsal
    sms = (torch.cuda.get_device_properties(ids.device).multi_processor_count
           if ids.is_cuda else 132)
    for case, cids, cvals, cG in (
            ("lineitem scale", big_ids, li["l_extendedprice"], G),
            ("Q18 group-by l_orderkey", q18_ids, li["l_extendedprice"], q18_G),
            ("Q3 residual", ids, j.cols["revenue"], G)):
        sums, counts = ga.grouped_agg(cids, cvals, cG)
        psums, pcounts = ref.grouped_agg(cids, cvals, cG)
        check(torch.equal(counts, pcounts), f"grouped_agg {case}: counts differ")
        check(torch.allclose(sums, psums, rtol=SUM_RTOL, atol=0.0),
              f"grouped_agg {case}: sums differ beyond rtol {SUM_RTOL}")
        rec = dict(
            name="grouped_agg", regime=ga.plan(cids.shape[0], cG, sms).regime,
            max_abs_err=float((sums - psums).abs().max()),
            ms=timer(lambda: ga.grouped_agg(cids, cvals, cG)),
            plain_ms=timer(lambda: ref.grouped_agg(cids, cvals, cG)),
            library_ms=timer(lambda: torch.bincount(cids, weights=cvals,
                                                    minlength=cG)),
            shape=f"{case}, R={cids.shape[0]}, G={cG}")
        rec["bound_ms"], rec["bound_by"] = bound(
            nbytes(cids, cvals) + cG * 16, cids.shape[0])
        if case != "Q3 residual":
            lines.append(rec)
    records["grouped_agg"] = rec
    del big_ids, q18_ids, j, merged

    # bitmap_apply: Q19's Fig-3 compute side in one launch (the record):
    # each partition's words applied to its three cached columns
    # (l_discount and l_extendedprice f64, l_partkey int32), as
    # core.bitmap.apply_bitmap_to_cache launches it; then one partition's
    # f64 and int32 columns, and all 60M rows of l_extendedprice
    plan = li_plans["Q19"]
    cached = fig3_columns(plan)[1]
    part_cols = [p.cols for p in li_parts]
    prog = program_for(plan.predicate, part_cols[0])
    pwords = [ref.predicate_bitmap(prog, [pc[c] for c in prog.columns])
              for pc in part_cols]
    seg_w = [w for w in pwords for _ in cached]
    seg_c = [pc[c] for pc in part_cols for c in cached]
    seg_p = [p for p in range(n_parts) for _ in cached]
    outs, counts = ba.bitmap_apply_segments(seg_w, seg_c, seg_p)
    pouts, pcounts = ref.bitmap_apply_segments(seg_w, seg_c, seg_p)
    check(torch.equal(counts, pcounts) and all(
        torch.equal(bits(a), bits(b)) for a, b in zip(outs, pouts)),
        "bitmap_apply Q19 Fig-3 apply: masked columns or counts differ")
    err = max(max(max_diff(a, b) for a, b in zip(outs, pouts)),
              max_diff(counts, pcounts))
    kept = pcounts.tolist()
    # a dropped row's output is 0 whatever the column holds: the function
    # reads each partition's words once, the kept rows' values, and writes
    # every row
    b_ms, b_by = bound(nbytes(*pwords) + sum(
        kept[p] * c.element_size() for p, c in zip(seg_p, seg_c))
        + nbytes(*seg_c), sum(c.shape[0] for c in seg_c))
    records["bitmap_apply"] = dict(
        max_abs_err=err,
        ms=timer(lambda: ba.bitmap_apply_segments(seg_w, seg_c, seg_p)),
        plain_ms=timer(lambda: ref.bitmap_apply_segments(seg_w, seg_c, seg_p)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"Q19 Fig-3 apply, {n_parts} partitions x {cached}, "
              f"{len(seg_c)} segments in one launch, kept={sum(kept)}")
    del outs, pouts
    prog = program_for(plan.predicate, li)
    words = ref.predicate_bitmap(prog, [li[c] for c in prog.columns])
    for case, w, col in (
            ("one partition, l_extendedprice f64", pwords[0],
             part_cols[0]["l_extendedprice"]),
            ("one partition, l_partkey int32", pwords[0],
             part_cols[0]["l_partkey"]),
            (f"all of l_extendedprice f64, R={R}", words,
             li["l_extendedprice"])):
        masked, count = ba.bitmap_apply(w, col)
        pmasked, pcount = ref.bitmap_apply(w, col)
        check(torch.equal(bits(masked), bits(pmasked)) and
              int(count) == int(pcount), f"bitmap_apply {case}: differs")
        b_ms, b_by = bound(nbytes(w) + int(pcount) * col.element_size()
                           + nbytes(col), col.shape[0])
        lines.append(dict(
            name="bitmap_apply", max_abs_err=max(
                max_diff(masked, pmasked), abs(int(count) - int(pcount))),
            ms=timer(lambda: ba.bitmap_apply(w, col)),
            plain_ms=timer(lambda: ref.bitmap_apply(w, col)), bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
            shape=f"Q19 words on {case}, kept={int(pcount)}"))
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
    for q in ("Q3", "Q19"):
        prog = program_for(li_plans[q].predicate, li)
        cols = [li[c] for c in prog.columns]
        out = held_shuffle(prog, cols, keys, P, q)
    b_ms, b_by = bound(nbytes(*cols, keys, *out), R * (prog.n_ops + 3))
    records["fused_scan_shuffle"] = dict(
        max_abs_err=0.0, ms=timer(lambda: fss.fused_scan_shuffle(prog, cols,
                                                                 keys, P)),
        plain_ms=timer(lambda: ref.fused_scan_shuffle(prog, cols, keys, P)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"Q19 lineitem predicate, key l_orderkey, R={R}, P={P}, "
              f"kept={int(out[2].sum())}")
    # the same with the keys as int64 (high bits set: only the low 32 hash,
    # so the pids are the int32 keys'), and on one partition's view from
    # its row 1 (every column and the keys off a 16-byte boundary)
    keys64 = keys.to(torch.int64) | (1 << 40)
    part = cat.partitions_of("lineitem")[0].data.cols
    vcols = [part[c][1:] for c in prog.columns]
    vkeys = part["l_orderkey"][1:]
    check(all(c.data_ptr() % 16 for c in (*vcols, vkeys)),
          "partition view: a column starts on a 16-byte boundary")
    for case, pc, k in (("int64 keys", cols, keys64),
                        ("one partition from row 1", vcols, vkeys)):
        got = held_shuffle(prog, pc, k, P, f"Q19, {case}")
        check(k is not keys64 or torch.equal(got[1], out[1]),
              "fused_scan_shuffle Q19: int64 keys hash to other targets")
        b_ms, b_by = bound(nbytes(*pc, k, *got), k.shape[0] * (prog.n_ops + 3))
        lines.append(dict(
            name="fused_scan_shuffle", max_abs_err=0.0,
            ms=timer(lambda: fss.fused_scan_shuffle(prog, pc, k, P)),
            plain_ms=timer(lambda: ref.fused_scan_shuffle(prog, pc, k, P)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"Q19 lineitem predicate, {case}, R={k.shape[0]}, P={P}"))
    del out, got, keys64
    lines += pooled_in_records(li, seg, n_parts, timer)
    split_route_check(cat)
    return records, lines


def held_shuffle(prog, cols, keys, P, case):
    """``fused_scan_shuffle`` held bitwise to its plain version; prints the
    launch's grid, ring and shared memory (``last_launch``)."""
    from repro_torch.kernels import fused_scan_shuffle as fss
    from repro_torch.kernels import ref

    out = fss.fused_scan_shuffle(prog, cols, keys, P)
    plain = ref.fused_scan_shuffle(prog, cols, keys, P)
    check(all(a.dtype == b.dtype and torch.equal(a, b)
              for a, b in zip(out, plain)),
          f"fused_scan_shuffle {case}: words, pids or histogram differ")
    launch = fss.fused_scan_shuffle.last_launch if keys.is_cuda else None
    print(f"kernel: fused_scan_shuffle launch [{case}, {keys.dtype}, "
          f"R={keys.shape[0]}]: " + (", ".join(
              f"{k}={v}" for k, v in launch.items()) if launch else
              "the plain version (CPU)"))
    return out


def pooled_in_records(li, seg, n_parts, timer):
    """A 512-value ``In`` (pooled: a sorted list on the card that each row
    binary-searches) over all of ``l_partkey`` through the three kernels
    that interpret a program, each held to its plain version."""
    from repro_torch.kernels import fused_scan_agg as fsa
    from repro_torch.kernels import fused_scan_shuffle as fss
    from repro_torch.kernels import predicate_bitmap as pb
    from repro_torch.kernels import ref
    from repro_torch.kernels.program import program_for
    from repro_torch.queryproc.expressions import Col

    col = li["l_partkey"]
    R = col.shape[0]
    gen = torch.Generator().manual_seed(512)
    hi = int(col.max()) + 1
    vals = tuple(torch.randperm(hi, generator=gen)[:POOLED_VALUES].tolist())
    prog = program_for(Col("l_partkey").isin(vals), {"l_partkey": col})
    check(len(prog.pool) == POOLED_VALUES, "512-value In: not pooled")
    steps = POOLED_VALUES.bit_length()  # compares of the binary search
    shape = f"512-value pooled In on l_partkey (int32), R={R}"
    out = []
    words = pb.predicate_bitmap(prog, [col])
    check(torch.equal(words, ref.predicate_bitmap(prog, [col])),
          "predicate_bitmap pooled In: words differ")
    b_ms, b_by = bound(nbytes(col, words), R * steps)
    out.append(dict(
        name="predicate_bitmap", max_abs_err=0.0,
        ms=timer(lambda: pb.predicate_bitmap(prog, [col])),
        plain_ms=timer(lambda: ref.predicate_bitmap(prog, [col])),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{shape}, kept={int(ref.unpack_bitmap(words, R).sum())}"))
    ids = seg.to(torch.int32)
    vals_ = [li["l_extendedprice"]]
    sums, counts = fsa.fused_scan_agg(prog, [col], ids, vals_, n_parts)
    psums, pcounts = ref.fused_scan_agg(prog, [col], ids, vals_, n_parts)
    check(torch.equal(counts, pcounts), "fused_scan_agg pooled In: counts "
                                        "differ")
    check(torch.allclose(sums, psums, rtol=SUM_RTOL, atol=0.0),
          f"fused_scan_agg pooled In: sums differ beyond rtol {SUM_RTOL}")
    kept = int(pcounts.sum())
    b_ms, b_by = bound(nbytes(col) + kept * 12 + n_parts * 16,
                       R * steps + 2 * kept)
    out.append(dict(
        name="fused_scan_agg", max_abs_err=float((sums - psums).abs().max()),
        ms=timer(lambda: fsa.fused_scan_agg(prog, [col], ids, vals_,
                                            n_parts)),
        plain_ms=timer(lambda: ref.fused_scan_agg(prog, [col], ids, vals_,
                                                  n_parts)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{shape}, sum of l_extendedprice by partition, G={n_parts}, "
              f"kept={kept}"))
    keys, P = li["l_orderkey"], SHUFFLE_TARGETS
    got = held_shuffle(prog, [col], keys, P, "512-value pooled In")
    b_ms, b_by = bound(nbytes(col, keys, *got), R * (steps + 3))
    out.append(dict(
        name="fused_scan_shuffle", max_abs_err=0.0,
        ms=timer(lambda: fss.fused_scan_shuffle(prog, [col], keys, P)),
        plain_ms=timer(lambda: ref.fused_scan_shuffle(prog, [col], keys, P)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{shape}, key l_orderkey, P={P}"))
    return out


def split_route_check(cat):
    """A nine-column AND (one column past a program's eight: two programs,
    their words combined with ``&``) through the executor over lineitem's
    partitions, as a filter and as a count by partition over the kept
    rows, and through the op shims ``ops.fused_scan_agg`` and
    ``ops.fused_scan_shuffle`` over the whole columns, held to
    ``compile_expr``'s mask."""
    from repro_torch import kernels
    from repro_torch.core.executor import compile_push_plan
    from repro_torch.core.plan import PushPlan
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.program import SplitProgram, program_for
    from repro_torch.queryproc import operators as ops
    from repro_torch.queryproc.expressions import Col, compile_expr
    from repro_torch.queryproc.table import ColumnTable

    names = ("l_quantity", "l_discount", "l_tax", "l_shipdate",
             "l_commitdate", "l_receiptdate", "l_returnflag", "l_linestatus",
             "l_shipmode")
    pred = Col("l_quantity") <= 3
    for c in names[1:]:
        pred = pred & (Col(c) >= 0)
    li = cat.scan_table("lineitem", [*names, "l_orderkey"]).cols
    check(isinstance(program_for(pred, li), SplitProgram),
          "nine-column AND: not split")
    want = li["l_orderkey"][compile_expr(pred)(li)]
    parts = [p.data for p in cat.partitions_of("lineitem")]
    kernels.reset_launches()
    t0 = time.perf_counter()
    got, _ = compile_push_plan(PushPlan("lineitem", ("l_orderkey",), pred)) \
        .execute_batch_parts(parts)
    counts, _ = compile_push_plan(PushPlan(
        "lineitem", ("n",), pred, agg=((), (("n", "count", ""),)))) \
        .execute_batch_parts(parts)
    wall = time.perf_counter() - t0
    n = kernels.launches()
    check(torch.equal(ColumnTable.concat(got).cols["l_orderkey"], want),
          "nine-column AND: filtered rows differ")
    total = sum(float(c.cols["n"].sum()) for c in counts)
    check(total == want.shape[0], "nine-column AND: counts differ")
    on_card = want.is_cuda
    check(not on_card or (n["predicate_bitmap"] == 4
                          and n["fused_scan_agg"] == 1),
          f"nine-column AND: launches {n}")
    print(f"kernel: nine-column AND through the split route, R="
          f"{li['l_orderkey'].shape[0]}, kept={want.shape[0]}, filter and "
          f"count in {wall:.4f} s, launches {n}")

    # the op shims take the same route: words part by part, then the
    # program-free launches over the kept rows (every row's target from
    # hash_partition), held to independent torch over the mask
    mask = compile_expr(pred)(li)
    G, keys = 600, li["l_orderkey"]
    ids = (keys % G).to(torch.int32)
    vals = cat.scan_table("lineitem", ["l_extendedprice"]).cols[
        "l_extendedprice"]
    kernels.reset_launches()
    sums, cnt = kops.fused_scan_agg(li, pred, ids, vals, G)
    words, pids, hist = kops.fused_scan_shuffle(li, pred, keys,
                                                SHUFFLE_TARGETS)
    n = kernels.launches()
    want_pids = ops.hash_partition_ids(keys, SHUFFLE_TARGETS)
    want_sums = torch.zeros(G, dtype=torch.float64, device=keys.device
                            ).index_add_(0, ids[mask].long(), vals[mask])
    check(torch.equal(cnt.long(), torch.bincount(ids[mask], minlength=G))
          and torch.equal(words, ref.pack_bitmap(mask))
          and torch.equal(pids, want_pids)
          and torch.equal(hist.long(), torch.bincount(
              want_pids[mask], minlength=SHUFFLE_TARGETS))
          and max_diff(sums, want_sums) <= SUM_RTOL * float(
              want_sums.abs().max()),
          "nine-column AND through the op shims differs")
    check(not on_card or n == {**dict.fromkeys(n, 0), "predicate_bitmap": 4,
                               "fused_scan_agg": 1, "hash_partition": 1,
                               "fused_scan_shuffle": 1},
          f"nine-column AND through the op shims: launches {n}")
    print(f"kernel: nine-column AND through the op shims (fused_scan_agg, "
          f"G={G}; fused_scan_shuffle, P={SHUFFLE_TARGETS}), launches {n}")


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


def independent_q18(cat, threshold: float = 150.0):
    """Q18 in torch over the whole lineitem and orders tables, with none
    of the engine's code: each order's quantity summed by ``index_add_``
    at its key, the orders above the threshold, their 100 largest totals."""
    from repro_torch.queryproc.table import ColumnTable
    li = cat.scan_table("lineitem", ["l_orderkey", "l_quantity"]).cols
    od = cat.scan_table("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                                   "o_totalprice"]).cols
    n = int(torch.maximum(li["l_orderkey"].max(), od["o_orderkey"].max())) + 1
    qty = torch.zeros(n, dtype=torch.float64, device=li["l_quantity"].device)
    qty.index_add_(0, li["l_orderkey"].long(), li["l_quantity"])
    sum_qty = qty[od["o_orderkey"].long()]
    big = torch.nonzero(sum_qty > threshold).flatten()
    top = big[torch.topk(od["o_totalprice"][big], min(100, len(big))).indices]
    return ColumnTable({"l_orderkey": od["o_orderkey"][top],
                        "sum_qty": sum_qty[top],
                        **{c: v[top] for c, v in od.items()}})


@contextlib.contextmanager
def grouped_agg_regimes(seen: list):
    """Record the regime, rows and groups of every ``grouped_agg`` launch
    made inside the block (``grouped_agg.plan`` picks the regime)."""
    from repro_torch.kernels import grouped_agg as ga
    run_plan = ga.run_plan

    def recording(plan, ids, values, G):
        seen.append(f"{plan.regime}(R={ids.shape[0]},G={G})")
        return run_plan(plan, ids, values, G)
    ga.run_plan = recording
    try:
        yield seen
    finally:
        ga.run_plan = run_plan


@contextlib.contextmanager
def tensor_agg_held(held: list):
    """Hold every ``grouped_agg`` call that the tensor backend's stage
    programs make inside the block against ``kernels.ref.grouped_agg`` on
    the same (ids, values, G), at the shapes the stages give it (a ``lex``
    aggregate: G = the bucket's rows; a ``code`` one: G = the code's
    domain; invalid rows parked at id G, which the kernel must drop):
    counts equal, sums within ``SUM_RTOL``. Only the tensor backend's own
    calls are held (through ``tensorize``'s name for the kernel module);
    ``held`` gets ``(rows, G, rows dropped, max_abs_err)`` for each."""
    from repro_torch.compiler import tensorize
    from repro_torch.kernels import ref
    real = tensorize.gak

    class Held:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def grouped_agg(ids, values, G):
            sums, counts = real.grouped_agg(ids, values, G)
            psums, pcounts = ref.grouped_agg(ids, values, G)
            label = f"tensor: grouped_agg (R={ids.shape[0]}, G={G})"
            check(torch.equal(counts, pcounts), f"{label}: counts differ")
            err = 0.0
            if values is not None and G > 0:
                check(torch.allclose(sums, psums, rtol=SUM_RTOL, atol=0.0),
                      f"{label}: sums differ beyond rtol {SUM_RTOL}")
                err = float((sums - psums).abs().max())
            dropped = int(((ids < 0) | (ids >= G)).sum())
            held.append((ids.shape[0], G, dropped, err))
            return sums, counts
    tensorize.gak = Held()
    try:
        yield held
    finally:
        tensorize.gak = real


def keyed_sums(residual) -> bool:
    """A stage program of the residual lowers a keyed aggregate with a
    sum, mean or count (one that it takes from ``grouped_agg``). A join's
    build side and the other host-resident inputs of a stage are the
    interpreter's, so their aggregates do not count (Q17's by partkey)."""
    from repro_torch.compiler import ir, tensorize
    art = tensorize._artifact(residual)
    seen, stack = set(), [r for st in art.stages for r in st.jit_roots]
    while stack:
        n = stack.pop()
        if id(n) in seen or id(n) in art.leaf_names:
            continue
        seen.add(id(n))
        if isinstance(n, ir.Aggregate) and n.keys and any(
                fn in ("sum", "mean", "count") for _, fn, _ in n.aggs):
            return True
        stack.extend(n.inputs())
    return False


def host_counts(on_card):
    """(device allocations of the caching allocator so far, full
    collections of Python's cyclic GC so far): what a run can stall on
    outside its own work."""
    allocs = (torch.cuda.memory_stats().get("num_device_alloc", 0)
              if on_card else 0)
    return allocs, gc.get_stats()[2]["collections"]


def engine_phase(cat, sync, results=None):
    """Every query in every config through ``compile_and_run``; returns the
    kernels' launch counts over exactly these runs. ``results``, when
    given, gets each run's result under ``(qid, mode, power)``."""
    from repro_torch import kernels
    from repro_torch.compiler import QUERY_IDS
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import (EngineConfig, compile_and_run,
                                         results_equal)

    expected = {**independent_q1_q6(cat), "Q18": independent_q18(cat)}
    on_card = cat.device.type == "cuda"
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
        with grouped_agg_regimes([]) as seen:
            for mode, power in CONFIGS:
                compile_and_run(qid, cat, config(mode, power))
        print(f"engine: {qid} grouped_agg launches over the four configs: "
              f"{', '.join(dict.fromkeys(seen)) or 'none'}")
    sync()
    print(f"engine: warm-up pass in {time.perf_counter() - t0:.3f} s")
    kernels.reset_launches()
    peaks = [0.0]
    for qid in QUERY_IDS:
        runs = []
        for mode, power in CONFIGS:
            cfg = config(mode, power)
            sync()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            before = host_counts(on_card)
            t0 = time.perf_counter()
            run = compile_and_run(qid, cat, cfg)
            sync()
            wall = time.perf_counter() - t0
            allocs, gcs = (a - b for a, b in zip(host_counts(on_card), before))
            if on_card:
                peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            peak = f"{peaks[-1]:.2f} GB" if on_card else "not measured"
            print(f"engine: {qid} mode={mode} storage_power={power} "
                  f"wall_s={wall:.4f} admitted={run.n_admitted} "
                  f"pushed_back={run.n_pushed_back} "
                  f"real_net_bytes={run.real_net_bytes} "
                  f"result_rows={len(run.result)} peak={peak} "
                  f"device_allocs={allocs} gc_full_collections={gcs}")
            check(len(run.result) > 0, f"{qid} {mode}: empty result")
            if results is not None:
                results[(qid, mode, power)] = run.result
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
        if qid in PR14_ADAPTIVE_LOW and on_card:
            low = runs[-1]
            got = (low.n_admitted, low.n_pushed_back, low.real_net_bytes)
            print(f"engine: {qid} adaptive 0.1 (admitted, pushed back, real "
                  f"bytes) {got}, hand-built plans {PR14_ADAPTIVE_LOW[qid]}: "
                  f"{'same' if got == PR14_ADAPTIVE_LOW[qid] else 'DIFFERS'}")
    print(f"engine: peak over the timed runs "
          f"{f'{max(peaks):.2f} GB' if on_card else 'not measured'}")
    return kernels.launches()


# ------------------------------------------------------------ tensor phase
def tensor_phase(cat, sync, interp, card: str = "no card", repeats: int = 5):
    """The residual's tensor backend (``EngineConfig.residual="tensor"``).
    Each query is compiled once (``compile_and_run`` would compile, and so
    observe, at every call): one observe pass through ``run_query``, then
    on the eager merged tables the interpreter's and the tensor backend's
    residual times (medians of ``repeats``, ``gc.collect()`` and a sync
    around each; the first, untimed tensor run is the cold one), its
    stages, lowerings and ``grouped_agg`` launches and regimes, with each
    of the cold run's stage calls of ``grouped_agg`` held to the plain
    version (``tensor_agg_held``); then the
    four configs warm, each ``fell_back`` False, ``observed`` False, no
    program missed, and agreeing with the engine phase's interpreter run
    of the config (``interp``: ``(qid, mode, power)`` -> result) bitwise
    or in rows. Then the calibrated crossover and one ``residual="auto"``
    run of Q1 and of Q18, and the stream phase's 16-entry stream in
    adaptive 1.0 with the tensor backend, each result agreeing with the
    engine phase's adaptive 1.0 run; ``residual.errors`` must stay 0.
    ``card`` labels the lines. Returns the launch counts of the driven
    runs."""
    from repro_torch import kernels
    from repro_torch.compiler import QUERY_IDS, compile_query, tensorize
    from repro_torch.core.arbitrator import PUSHDOWN
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import EngineConfig, plan_requests, run_query
    from repro_torch.core.runtime import (execute_split, run_residual,
                                          run_stream)
    from repro_torch.obs import metrics

    drive, launches, _ = launch_counting(sync)
    on_card = cat.device.type == "cuda"

    def config(mode="adaptive", power=1.0, residual="tensor"):
        return EngineConfig(res=StorageResources(storage_power=power),
                            mode=mode, device=cat.device, residual=residual)

    def median_s(fn):
        times = []
        for _ in range(repeats):
            gc.collect()
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    def agrees(got, want, label: str) -> str:
        how = agree(want, got)
        check(bool(how), f"tensor: {label} disagrees with the interpreter")
        return how

    def tally(hows: dict, how: str) -> None:
        hows[how] = hows.get(how, 0) + 1
    prev = metrics.get_metrics()
    metrics.set_metrics(metrics.Metrics())
    try:
        hows, kinds = {}, set()
        for qid in QUERY_IDS:
            q = compile_query(qid)
            run = drive(run_query, q, cat, config("eager"))
            check(run.residual_backend == "tensor"
                  and run.residual_jit["observed"],
                  f"tensor: {qid} observe pass {run.residual_jit}")
            agrees(run.result, interp[(qid, "eager", 1.0)], f"{qid} observe")
            reqs = plan_requests(q, cat)
            merged = execute_split(
                reqs, {r.req_id: PUSHDOWN for r in reqs}).merged
            rows = sum(len(t) for t in merged.values())
            kernels.reset_launches()
            with grouped_agg_regimes([]) as seen, \
                    tensor_agg_held([]) as held:
                _, cold = run_residual(q, merged, "tensor")
                sync()
            n_ga = kernels.launches()["grouped_agg"]
            check(not cold.fell_back, f"tensor: {qid} cold run fell back")
            if keyed_sums(q.residual):
                # the stages themselves called the kernel (the interpreter
                # launches it too, so the launch count alone shows nothing)
                check(len(held) > 0 and (n_ga >= len(held) or not on_card),
                      f"tensor: {qid}'s stages called grouped_agg "
                      f"{len(held)} times, {n_ga} launches in the cold run")
            t_int = median_s(lambda: run_residual(q, merged, "interpreter"))
            t_ten = median_s(lambda: run_residual(q, merged, "tensor"))
            del merged
            aggs, joins = tensorize.lowerings(q.residual)
            if held:
                kinds.update(a[0] for a in aggs)
            print(f"tensor: {qid} merged_rows={rows} stages={cold.n_stages} "
                  f"cold_misses={cold.jit_misses} aggregates="
                  f"{[a[0] for a in aggs]} joins={[j[0] for j in joins]} "
                  f"grouped_agg launches={n_ga} regimes="
                  f"{', '.join(dict.fromkeys(seen)) or 'none'} "
                  f"held to the plain version (R, G, dropped, max_abs_err)="
                  f"{held} "
                  f"interpreter_ms={1e3 * t_int:.4f} "
                  f"tensor_ms={1e3 * t_ten:.4f} (medians of {repeats}) "
                  f"[{card}]")
            for mode, power in CONFIGS:
                run = drive(run_query, q, cat, config(mode, power))
                jit = run.residual_jit
                check(run.residual_backend == "tensor" and jit is not None
                      and not jit["fell_back"] and not jit["observed"]
                      and jit["misses"] == 0 and jit["hits"] >= 1,
                      f"tensor: {qid} {mode} {power} {jit}")
                tally(hows, agrees(run.result, interp[(qid, mode, power)],
                                   f"{qid} {mode} {power}"))
        check(kinds >= {"code", "lex"},
              f"tensor: grouped_agg held to its plain version under the "
              f"{sorted(kinds)} aggregates only, not both code and lex")
        print(f"tensor: {len(QUERY_IDS)} queries x {len(CONFIGS)} configs "
              f"warm (no program missed), agree with the interpreter "
              f"{hows} [{card}]")
        t0 = time.perf_counter()
        th = tensorize.calibrate_residual_threshold(device=cat.device)
        print(f"tensor: calibrate_residual_threshold() = {th} merged rows "
              f"in {time.perf_counter() - t0:.2f} s (inf: the tensor "
              f"backend won at no size) [{card}]")
        for qid in ("Q1", "Q18"):
            run = drive(run_query, compile_query(qid), cat,
                        config(residual="auto"))
            agrees(run.result, interp[(qid, "adaptive", 1.0)], f"{qid} auto")
            print(f"tensor: {qid} residual=auto (threshold "
                  f"{tensorize.auto_threshold(cat.device)}) ran "
                  f"{run.residual_backend} {run.residual_jit}")
        run = drive(run_stream, stream_queries(STREAM_GAP_S), cat, config())
        check(set(run.results) == {*QUERY_IDS, "Q6#1"},
              f"tensor stream: keys {sorted(run.results)}")
        shows = {}
        for key, res in run.results.items():
            tally(shows, agrees(res, interp[(key.split("#")[0], "adaptive",
                                             1.0)], f"stream {key}"))
        counters = metrics.get_metrics().snapshot()["counters"]
        res_c = {k: int(v) for k, v in sorted(counters.items())
                 if k.startswith("residual.")}
        print(f"tensor: stream of {len(run.results)} adaptive 1.0 "
              f"residual=tensor: t_decide_s={run.t_decide:.4f} "
              f"wall_clock_s={run.wall_clock:.4f} agree={shows}; "
              f"{res_c} [{card}]")
        check(res_c.get("residual.errors", 0) == 0,
              f"tensor: residual.errors in {res_c}")
    finally:
        metrics.set_metrics(prev)
    return launches


# ---------------------------------------------------------- compiler phase
def compiler_phase(cat, ccat, timer, sync):
    """The plans only the compiler emits, held to independent evaluations:
    Q18 with its HAVING pushed on ``ccat`` (lineitem clustered by
    ``l_orderkey``) against Q18 on ``cat``, an absorbed TopK and a pushed
    min/max aggregate on ``cat``. Each driven run has the launch counts
    zeroed just before it and read just after. Returns the counts summed
    over the driven runs and the kernel record of ``predicate_bitmap`` on
    the HAVING program."""
    from repro_torch import kernels
    from repro_torch.compiler import compile_ir, compile_query_detailed, ir
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import (EngineConfig, compile_and_run,
                                         results_equal, run_query)
    from repro_torch.core.executor import compile_push_plan
    from repro_torch.kernels import predicate_bitmap as pb
    from repro_torch.kernels import ref
    from repro_torch.kernels.program import program_for
    from repro_torch.queryproc.expressions import Col
    from repro_torch.queryproc.table import ColumnTable
    from repro_torch.queryproc.tpch import N_LINESTATUS, date

    launches = {n: 0 for n in kernels.WRAPPERS}

    def drive(fn, *args, **kwargs):
        sync()
        kernels.reset_launches()
        out = fn(*args, **kwargs)
        sync()
        for n, c in kernels.launches().items():
            launches[n] += c
        return out

    def config(mode, power):
        return EngineConfig(res=StorageResources(storage_power=power),
                            mode=mode, device=cat.device)

    # Q18 with its HAVING pushed, on the clustered catalog
    q18 = compile_ir(compile_query_detailed("Q18").root, "Q18",
                     clustered=ccat.clustered)
    plan = q18.plans["lineitem"]
    check(plan.having is not None, "Q18 on the clustered catalog: HAVING "
                                   "not pushed")
    for mode, power in CONFIGS:
        plain = compile_and_run("Q18", cat, config(mode, power))
        t0 = time.perf_counter()
        run = drive(run_query, q18.query, ccat, config(mode, power))
        wall = time.perf_counter() - t0
        check(results_equal(run.result, plain.result),
              f"Q18 clustered, {mode} at power {power}: differs from Q18 on "
              f"the unclustered catalog")
        recon, precon = run.net_bytes_recon, plain.net_bytes_recon
        print(f"compiler: Q18 HAVING pushed, mode={mode} storage_power="
              f"{power} wall_s={wall:.4f} admitted={run.n_admitted} "
              f"pushed_back={run.n_pushed_back} real_net_bytes="
              f"{run.real_net_bytes} (pushdown {recon['real_pushdown_bytes']})"
              f"; unclustered {plain.real_net_bytes} (pushdown "
              f"{precon['real_pushdown_bytes']})")
    del run, plain
    # predicate_bitmap on the HAVING program over the clustered partials
    partial = dataclasses.replace(plan, having=None)
    tabs, _ = compile_push_plan(partial).execute_batch_parts(
        [p.data for p in ccat.partitions_of("lineitem")])
    out = ColumnTable.concat(tabs).cols
    prog = program_for(plan.having, out)
    cols = [out[c] for c in prog.columns]
    words, plain_words = pb.predicate_bitmap(prog, cols), \
        ref.predicate_bitmap(prog, cols)
    check(torch.equal(words, plain_words), "predicate_bitmap Q18 HAVING: "
                                           "words differ")
    G = cols[0].shape[0]
    b_ms, b_by = bound(nbytes(*cols, words), G * prog.n_ops)
    record = dict(
        name="predicate_bitmap", max_abs_err=0.0,
        ms=timer(lambda: pb.predicate_bitmap(prog, cols)),
        plain_ms=timer(lambda: ref.predicate_bitmap(prog, cols)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"Q18 HAVING sum_qty > 150 over the clustered partial "
              f"aggregate, {G} groups in {len(tabs)} partitions")
    del tabs, out, cols, words, plain_words

    li = cat.scan_table("lineitem", [
        "l_orderkey", "l_extendedprice", "l_discount", "l_quantity",
        "l_shipdate", "l_returnflag", "l_linestatus"]).cols
    D = date(1995, 3, 15)
    m = li["l_shipdate"] < D
    # a TopK absorbed over a filtered, derived lineitem scan
    n = ir.Scan("lineitem", ("l_orderkey", "l_extendedprice"))
    n = ir.Map(ir.Filter(n, Col("l_shipdate") < D), (
        ("revenue", ("l_extendedprice", "l_discount"),
         lambda e, d: e * (1 - d)),))
    top = compile_ir(ir.TopK(n, "l_extendedprice", 100), "TOPK")
    check(top.plans["lineitem"].top_k == ("l_extendedprice", 100, False),
          "custom TopK: not absorbed")
    e = li["l_extendedprice"][m]
    idx = torch.topk(e, 100).indices
    want = ColumnTable({"l_orderkey": li["l_orderkey"][m][idx],
                        "l_extendedprice": e[idx],
                        "revenue": (e * (1 - li["l_discount"][m]))[idx]})
    for mode, power in (("eager", 1.0), ("adaptive", 0.1)):
        run = drive(run_query, top.query, cat, config(mode, power))
        check(same_rows(run.result, want),
              f"custom TopK {mode} at power {power}: differs from torch.topk")
        print(f"compiler: TopK 100 of l_extendedprice over {int(m.sum())} "
              f"filtered rows, mode={mode} storage_power={power} "
              f"admitted={run.n_admitted} pushed_back={run.n_pushed_back} "
              f"real_net_bytes={run.real_net_bytes}")

    # a pushed min/max aggregate
    keys = ("l_returnflag", "l_linestatus")
    agg = ir.Aggregate(ir.Filter(ir.Scan("lineitem", ()),
                                 Col("l_shipdate") < D), keys,
                       (("lo_price", "min", "l_extendedprice"),
                        ("hi_price", "max", "l_extendedprice"),
                        ("last_ship", "max", "l_shipdate"),
                        ("qty", "sum", "l_quantity"), ("n", "count", "")))
    mm = compile_ir(agg, "MINMAX")
    check(mm.plans["lineitem"].agg is not None, "custom min/max: not pushed")
    code = (li["l_returnflag"].long() * N_LINESTATUS
            + li["l_linestatus"])[m]
    cnt = torch.bincount(code)
    have = torch.nonzero(cnt).flatten()

    def reduce(col, how):
        v = li[col][m]
        return torch.empty(cnt.shape[0], dtype=v.dtype, device=v.device) \
            .scatter_reduce_(0, code, v, how, include_self=False)[have]
    want = ColumnTable({
        "l_returnflag": (have // N_LINESTATUS).to(torch.int32),
        "l_linestatus": (have % N_LINESTATUS).to(torch.int32),
        "lo_price": reduce("l_extendedprice", "amin"),
        "hi_price": reduce("l_extendedprice", "amax"),
        "last_ship": reduce("l_shipdate", "amax"),
        "qty": reduce("l_quantity", "sum"), "n": cnt[have]})
    for mode, power in (("eager", 1.0), ("adaptive", 0.1)):
        run = drive(run_query, mm.query, cat, config(mode, power))
        check(results_equal(run.result, want),
              f"custom min/max {mode} at power {power}: differs from "
              f"scatter_reduce")
        print(f"compiler: min/max by {keys}, mode={mode} storage_power="
              f"{power} admitted={run.n_admitted} pushed_back="
              f"{run.n_pushed_back} real_net_bytes={run.real_net_bytes}")
    return launches, record


# ------------------------------------------------------------ costed phase
def costed_phase(cat, sync):
    """The cost-based compiler, the cardinality corrector, the concurrent
    run and the §3.1 oracle split over the catalog. Every query runs
    ``compile_and_run(cost_based=True)`` in each of ``CONFIGS`` and must
    equal the same query's maximal-frontier result; the corrector learns
    from Q18 and Q4 run twice, then Q18 compiles costed with it; all 15
    queries run concurrently in adaptive_pa at power 0.1; each query's
    oracle split at power 0.1 is printed beside adaptive's makespan. Each
    driven run has the launch counts zeroed just before it and read just
    after. Returns the counts summed over the driven runs."""
    from repro_torch import kernels
    from repro_torch.compiler import QUERY_IDS, compile_query_costed
    from repro_torch.core import optimum
    from repro_torch.core.cost import CardinalityCorrector, StorageResources
    from repro_torch.core.engine import (EngineConfig, compile_and_run,
                                         results_equal, run_concurrent,
                                         run_query, theoretical_split)
    from repro_torch.core.simulator import SimRequest
    from repro_torch.queryproc import queries

    launches = {n: 0 for n in kernels.WRAPPERS}

    def drive(fn, *args, **kwargs):
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        wall = time.perf_counter() - t0
        for n, c in kernels.launches().items():
            launches[n] += c
        return out, wall

    def config(mode, power, corrector=None):
        return EngineConfig(res=StorageResources(storage_power=power),
                            mode=mode, device=cat.device, corrector=corrector)

    def short(text, n=100):
        return text if text is None or len(text) <= n else \
            f"{text[:n]}...({len(text)} chars)"

    # the maximal frontier's result, and adaptive's makespan at power 0.1
    maximal = {qid: compile_and_run(qid, cat, config("adaptive", 0.1))
               for qid in QUERY_IDS}
    for qid in QUERY_IDS:
        for power in sorted({p for _m, p in CONFIGS}, reverse=True):
            cq = compile_query_costed(
                qid, cat, res=StorageResources(storage_power=power))
            for ch in cq.cut_report:
                print(f"costed: {qid} power={power} {ch.table} chosen="
                      f"{ch.signatures[ch.chosen]} maximal="
                      f"{ch.signatures[ch.maximal]} scores="
                      f"{[round(x, 6) for x in ch.scores]} bitmap={ch.bitmap}"
                      f" lowered={short(ch.lowered)}")
        for mode, power in CONFIGS:
            run, wall = drive(compile_and_run, qid, cat, config(mode, power),
                              cost_based=True)
            check(results_equal(run.result, maximal[qid].result),
                  f"costed {qid} {mode} at power {power}: differs from the "
                  f"maximal frontier")
            by_table = {}
            for o in run.outcomes:
                by_table[o.table] = by_table.get(o.table, 0) + o.shipped_bytes
            print(f"costed: {qid} mode={mode} storage_power={power} "
                  f"wall_s={wall:.4f} admitted={run.n_admitted} "
                  f"pushed_back={run.n_pushed_back} real_net_bytes="
                  f"{run.real_net_bytes} {by_table} (maximal adaptive 0.1: "
                  f"{maximal[qid].real_net_bytes}) result_rows="
                  f"{len(run.result)}")

    # the corrector loop of tests/test_cost_split.py at this scale
    corr = CardinalityCorrector()
    before = compile_query_costed("Q18", cat).frontier_signature()
    for _ in range(2):
        for qid in ("Q18", "Q4"):
            run, _wall = drive(run_query, queries.build_query(qid), cat,
                               config("eager", 1.0, corr))
            if qid == "Q18":
                q18_by_table = run.net_bytes_recon["by_table"]
    after = compile_query_costed("Q18", cat, corrector=corr)
    print(f"corrector: Q18 lineitem cut {before['lineitem']} -> "
          f"{after.frontier_signature()['lineitem']}; snapshot "
          f"{corr.snapshot()}; Q18 by_table {q18_by_table}")
    run, wall = drive(compile_and_run, "Q18", cat, config("eager", 1.0, corr),
                      cost_based=True)
    check(results_equal(run.result, maximal["Q18"].result),
          "Q18 compiled with the corrector: differs from the maximal frontier")
    print(f"corrector: Q18 costed with the corrector, eager 1.0, wall_s="
          f"{wall:.4f} real_net_bytes={run.real_net_bytes}")

    # §6.2: every query at once, PA-aware, at power 0.1
    runs, wall = drive(run_concurrent,
                       [queries.build_query(q) for q in QUERY_IDS], cat,
                       config("adaptive_pa", 0.1))
    for qid, run in runs.items():
        check(results_equal(run.result, maximal[qid].result),
              f"concurrent {qid}: differs from its solo run")
        print(f"concurrent: {qid} finish_s={run.t_pushable:.6f} admitted="
              f"{run.n_admitted} pushed_back={run.n_pushed_back} "
              f"real_net_bytes={run.real_net_bytes}")
    print(f"concurrent: 15 queries adaptive_pa at power 0.1, makespan "
          f"{next(iter(runs.values())).sim.makespan:.6f} s simulated, "
          f"wall_s={wall:.4f}")

    # Fig 7: the heuristic against the oracle splits at power 0.1, on the
    # requests of the maximal frontier that adaptive ran above
    res = StorageResources(storage_power=0.1)
    for qid in QUERY_IDS:
        run = maximal[qid]
        fluid = theoretical_split(queries.build_query(qid), cat, res)
        oracle = optimum.simulated_optimum(
            [SimRequest(r.req_id, r.part.node_id, qid, r.cost)
             for r in run.requests], res)
        eq6 = optimum.uniform_prediction([r.cost for r in run.requests], res)
        N = len(run.requests)
        print(f"oracle: {qid} power=0.1 N={N} adaptive admitted="
              f"{run.n_admitted} makespan_s={run.t_pushable:.6f}; "
              f"theoretical_split n={fluid.n_pushdown} time_s="
              f"{fluid.time:.6f}; simulated oracle n={oracle.n_pushdown} "
              f"time_s={oracle.time:.6f}; Eq 6 n={eq6.n_pushdown}; "
              f"gap_frac={abs(run.n_admitted - eq6.n_pushdown) / N:.4f} "
              f"time_gap={(run.t_pushable - oracle.time) / oracle.time:.4f}")
    return launches


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


def launch_counting(sync):
    """(drive, launches, host_s). ``drive(fn, *args, **kwargs)`` runs
    ``fn`` with the kernels' launch counts zeroed just before and adds
    them to ``launches`` just after, so checks between driven calls are
    not counted; ``host_s`` gets the host-clock seconds until ``fn``
    returned ("call") and until the card was done ("done")."""
    from repro_torch import kernels
    launches = {n: 0 for n in kernels.WRAPPERS}
    host_s = {}

    def drive(fn, *args, **kwargs):
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        host_s["call"] = time.perf_counter() - t0
        sync()
        host_s["done"] = time.perf_counter() - t0
        for n, c in kernels.launches().items():
            launches[n] += c
        return out
    return drive, launches, host_s


def section42_phase(cat, sync):
    """The §4.2 operators over the catalog, held to the plain operators.
    Each driven step runs with the launch counts zeroed just before it and
    read just after; the checks between the steps are not counted. Returns
    the counts summed over the steps."""
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

    drive, launches, host_s = launch_counting(sync)
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
        to_mask = [p.select(cached) for p in parts]
        masked, counts = drive(bitmap.apply_bitmap_to_cache, to_mask, words)
        apply_s = dict(host_s)
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
              f"{time.perf_counter() - t0:.3f} s; apply_bitmap_to_cache "
              f"alone: host_call_s={apply_s['call']:.6f} "
              f"host_to_done_s={apply_s['done']:.6f}")
        del words, tabs, masked, to_mask

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


# ------------------------------------------------------------ cache phase
def agree(a, b) -> str:
    """How two results of one query agree: "bitwise" (``identical``), or
    "rows" when the columns, dtypes and row multiset agree with floats
    within ``SUM_RTOL`` (f64 sums accumulate in the kernels' atomic order,
    which can move their last bits from one run to the next); "" when
    they differ."""
    from repro_torch.core.engine import results_equal
    if identical(a, b):
        return "bitwise"
    same = list(a.cols) == list(b.cols) and all(
        a.cols[c].dtype == b.cols[c].dtype for c in a.cols)
    return "rows" if same and results_equal(a, b, tol=SUM_RTOL) else ""


class Jitter:
    """The control for one query's results: does its uncached result move
    in its last bits from run to run? The kernels add f64 sums with
    atomics in scheduling order, so it may. ``rerun()`` returns a fresh
    uncached result. The first rerun is made for every query
    (``control``). A result that agrees with the first run only in rows
    is accepted when the query's uncached runs also differ in bits:
    already in the control, or in one of the up to ``CONTROL_RUNS`` runs
    made then."""

    def __init__(self, first, rerun):
        self.first, self.rerun = first, rerun
        self.runs = 2
        self.moved = not identical(first, rerun())
        self.control = "differ" if self.moved else "bitwise"

    def holds(self, got) -> str:
        """"bitwise", "rows" (backed by the control) or ""."""
        how = agree(self.first, got)
        while how == "rows" and not self.moved and self.runs < CONTROL_RUNS:
            self.runs += 1
            self.moved = not identical(self.first, self.rerun())
        return how if how == "bitwise" or self.moved else ""

    def __str__(self) -> str:
        return (f"uncached x2 {self.control}"
                + (f", moved within {self.runs} uncached runs"
                   if self.moved and self.control == "bitwise" else ""))


def tightened(query, cat, plan_keys):
    """The query with each containment-eligible plan's predicate ANDed
    with ``col >= the column's minimum``: tighter in syntax, the same rows
    in fact, so the cache serves it by containment. None when no plan is
    eligible."""
    from repro_torch.queryproc import expressions as ex
    plans = dict(query.plans)
    for table, plan in query.plans.items():
        if plan_keys(plan).shape is None:
            continue
        col = sorted(ex.columns_of(plan.predicate))[0]
        lo = min(p.data.stats()[col].min for p in cat.partitions_of(table))
        plans[table] = dataclasses.replace(plan, predicate=ex.And(
            plan.predicate, ex.Cmp(">=", ex.Col(col), lo)))
    return (dataclasses.replace(query, plans=plans)
            if plans != query.plans else None)


def owned_copies(cache) -> int:
    """The allocator's slack over a cache's device bytes when every entry
    owns its tensors: each tensor's block is rounded to 512 bytes, and a
    block of 1 MiB or more may keep up to 1 MiB it was not split from.
    Checks that no cached tensor is a view into a larger one (a batch it
    was sliced from), then returns the slack."""
    slack = 0
    for e in cache._entries.values():
        tensors = list(e.result.cols.values())
        for k, x in e.aux.items():
            if k == "shuffle_parts":
                tensors += [v for p in x for v in p.cols.values()]
            else:
                tensors.append(x)
        for t in tensors:
            n = t.numel() * t.element_size()
            check(t.untyped_storage().nbytes() == n,
                  f"cache: a cached tensor of {n} bytes is a view into "
                  f"{t.untyped_storage().nbytes()}")
            slack += 1024 + (1 << 20 if n >= 1 << 20 else 0)
    return slack


def cache_phase(cat, sync):
    """The pushed-result cache on the catalog's device: every query eager
    uncached, cold and warm, then its tightened variant served by
    containment; one query at the default budget (evictions); Q6's warm
    flip at storage power 0.01; appends to a small catalog of its own; a
    §4.2 shuffle plan cold and warm. Returns the launch counts of the
    driven runs."""
    from repro_torch.compiler import QUERY_IDS
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import EngineConfig, run_query
    from repro_torch.core.executor import compile_push_plan
    from repro_torch.core.result_cache import (DEFAULT_BUDGET_BYTES,
                                               ResultCache, plan_keys)
    from repro_torch.obs import metrics
    from repro_torch.queryproc import queries, tpch
    from repro_torch.queryproc.table import ColumnTable

    on_card = cat.device.type == "cuda"
    drive, launches, host_s = launch_counting(sync)
    prev = metrics.set_metrics(metrics.Metrics())
    counters = metrics.get_metrics().snapshot

    def count(name):
        return counters()["counters"].get(name, 0.0)

    def mem():
        gc.collect()
        return torch.cuda.memory_allocated() if on_card else 0

    def cfg(cache=None, mode="eager", power=1.0):
        return EngineConfig(res=StorageResources(storage_power=power),
                            mode=mode, device=cat.device, result_cache=cache)
    peaks = [0.0]
    try:
        n_bitwise = n_control = 0
        for qid in QUERY_IDS:
            q = queries.build_query(qid)
            base = drive(run_query, q, cat, cfg())
            t_base = host_s["done"]
            jit = Jitter(base.result,
                         lambda: drive(run_query, q, cat, cfg()).result)
            n_control += jit.control == "bitwise"
            cache = ResultCache(CACHE_BUDGET)
            before = mem()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            cold = drive(run_query, q, cat, cfg(cache))
            t_cold = host_s["done"]
            h0 = count("cache.hit")
            warm = drive(run_query, q, cat, cfg(cache))
            t_warm = host_s["done"]
            hit = count("cache.hit") - h0
            how = [jit.holds(r.result) for r in (cold, warm)]
            check(all(how), f"cache {qid}: cold/warm differ from uncached "
                  f"({[agree(base.result, r.result) for r in (cold, warm)]}"
                  f", {jit})")
            n_bitwise += how == ["bitwise", "bitwise"]
            check(warm.cache_hits == hit > 0,
                  f"cache {qid}: {warm.cache_hits} served, cache.hit moved "
                  f"{hit}")
            check(cold.cache_hits == 0, f"cache {qid}: cold run served")
            check(cold.real_net_bytes == base.real_net_bytes,
                  f"cache {qid}: cold run shipped other bytes")
            stats = cache.stats()
            held_limit = stats["bytes"] + owned_copies(cache)
            variant = tightened(q, cat, plan_keys)
            contained = "none eligible"
            if variant is not None:
                want = drive(run_query, variant, cat, cfg())
                vjit = Jitter(want.result, lambda: drive(
                    run_query, variant, cat, cfg()).result)
                c0 = count("cache.hit.containment")
                got = drive(run_query, variant, cat, cfg(cache))
                n_cont = count("cache.hit.containment") - c0
                how_c = vjit.holds(got.result)
                contained = (f"{int(n_cont)} partitions served, "
                             f"{how_c or agree(want.result, got.result)} "
                             f"({vjit})")
                check(n_cont > 0 and how_c,
                      f"cache {qid}: tightened variant not served by "
                      f"containment, or it differs")
                del want, got, vjit
            if on_card:
                peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            peak = f"{peaks[-1]:.2f} GB" if on_card else "not measured"
            warm_bytes = warm.real_net_bytes
            del cold, warm
            filled = mem()
            cache.clear()
            cleared = mem()
            if on_card:
                check(filled - before <= held_limit and cleared == before,
                      f"cache {qid}: allocated {before} before the fill, "
                      f"{filled} after (at most {held_limit}), {cleared} "
                      f"after clear()")
            print(f"cache: {qid} eager walls (single runs) uncached_s="
                  f"{t_base:.4f} cold_s={t_cold:.4f} warm_s={t_warm:.4f} "
                  f"served={int(hit)} entries={stats['entries']} "
                  f"device_bytes={stats['bytes']} real_net_bytes="
                  f"{base.real_net_bytes} (warm {warm_bytes}) "
                  f"agree={'/'.join(how)} ({jit}) containment: "
                  f"{contained}; "
                  f"allocated before/filled/cleared {before}/{filled}/"
                  f"{cleared} peak={peak}")
            del base
        print(f"cache: {n_bitwise} of {len(QUERY_IDS)} queries bitwise in "
              f"both cached runs, the others in rows with sums within rtol "
              f"{SUM_RTOL}; control: {n_control} of {len(QUERY_IDS)} "
              f"queries' two uncached runs bitwise, and every query agreeing "
              f"in rows alone moved between uncached runs; peak over the "
              f"cold/warm/containment runs "
              f"{f'{max(peaks):.2f} GB' if on_card else 'not measured'}")

        q = queries.build_query("Q3")
        base = drive(run_query, q, cat, cfg())
        jit = Jitter(base.result,
                     lambda: drive(run_query, q, cat, cfg()).result)
        # the default budget holds about half of Q3's pushed bytes at
        # sf=1000; the CPU rehearsal's small catalogs take half of theirs
        cache = ResultCache(DEFAULT_BUDGET_BYTES if on_card
                            else base.real_net_bytes // 2)
        e0 = count("cache.evict")
        before = mem()
        runs = [drive(run_query, q, cat, cfg(cache)) for _ in range(2)]
        evicted = count("cache.evict") - e0
        how = [jit.holds(r.result) for r in runs]
        check(evicted > 0 and cache.bytes <= cache.budget_bytes and all(how),
              f"eviction: {evicted} evictions, {cache.bytes} bytes, "
              f"results {how} ({jit})")
        served, n = runs[1].cache_hits, len(runs[1].outcomes)
        del runs
        # the surviving entries must not keep the evicted ones' batches
        held = mem() - before
        check(not on_card or held <= cache.bytes + owned_copies(cache),
              f"eviction: {held} bytes allocated for {cache.bytes} cached")
        print(f"cache eviction: Q3 eager at {cache.budget_bytes} bytes "
              f"(pushed {base.real_net_bytes}): evicted={int(evicted)} "
              f"entries={cache.stats()['entries']} bytes={cache.bytes} "
              f"allocated for them {held if on_card else 'not measured'}, "
              f"warm served={served} of {n}, results {'/'.join(how)} "
              f"({jit})")
        del base, cache

        cache = ResultCache(CACHE_BUDGET)
        q6 = queries.build_query("Q6")
        base = drive(run_query, q6, cat, cfg(None, "eager", 0.01))
        jit = Jitter(base.result, lambda: drive(
            run_query, q6, cat, cfg(None, "eager", 0.01)).result)
        flips = [drive(run_query, q6, cat, cfg(cache, mode, 0.01))
                 for mode in ("adaptive", "eager", "adaptive")]
        t_warm = host_s["done"]
        n = len(flips[0].outcomes)
        check(flips[0].n_admitted == 0 and flips[0].n_pushed_back == n,
              f"warm flip: cold adaptive admitted {flips[0].n_admitted}")
        how = [jit.holds(f.result) for f in flips]
        # every partition of the warm run is served from the eager run's
        # entries, and the residual adds them in one order: the same bits
        served = identical(flips[1].result, flips[2].result)
        check(flips[2].n_admitted == n == flips[2].cache_hits and all(how)
              and served,
              f"warm flip: warm adaptive admitted {flips[2].n_admitted}, "
              f"served {flips[2].cache_hits} of {n}, results {how} against "
              f"the uncached run "
              f"({[agree(base.result, f.result) for f in flips]}, {jit}), "
              f"warm {'equal to' if served else 'differs from'} the eager "
              f"fill")
        print(f"cache warm flip: Q6 at storage_power 0.01: cold adaptive "
              f"{flips[0].n_admitted}/{flips[0].n_pushed_back}, warm "
              f"adaptive {flips[2].n_admitted}/{flips[2].n_pushed_back} "
              f"with {flips[2].cache_hits} served; walls (single runs) "
              f"warm_s={t_warm:.4f}; results {'/'.join(how)} "
              f"({jit}), warm bitwise to the eager fill")
        del flips, cache, base

        small = tpch.build_catalog(sf=2.0, seed=1, num_nodes=2,
                                   rows_per_partition=3000, device=cat.device)
        s0 = count("cache.evict.stale")
        n_rows = 0
        for qid in QUERY_IDS:
            q = queries.build_query(qid)
            cache = ResultCache(CACHE_BUDGET)
            drive(run_query, q, small, cfg(cache))
            table = sorted(q.plans)[0]
            part = small.tables[table][0]
            small.append_to_partition(table, 0, ColumnTable(
                {c: v[-1:] for c, v in part.data.cols.items()}))
            want = drive(run_query, q, small, cfg())
            for ctx in ("post-append", "refilled"):
                got = drive(run_query, q, small, cfg(cache))
                how = agree(want.result, got.result)
                check(bool(how),
                      f"invalidation {qid} {ctx}: stale rows served")
                n_rows += how == "rows"
        stale = count("cache.evict.stale") - s0
        check(stale >= len(QUERY_IDS), f"invalidation: {stale} stale "
              f"evictions over {len(QUERY_IDS)} appends")
        print(f"cache invalidation: 15 queries, one append each on an "
              f"sf=2 catalog, stale_evictions={int(stale)}, no stale rows "
              f"({n_rows} of 30 cached runs equal in rows alone)")
        del small

        q = queries.build_query("Q3")
        plan = compile_push_plan(shuffle_plan(q, "lineitem", SHUFFLE_TARGETS))
        parts = cat.partitions_of("lineitem")
        tabs = [p.data for p in parts]
        want = drive(plan.execute_batch_parts, tabs)
        cache = ResultCache(CACHE_BUDGET)
        for ctx in ("cold", "warm"):
            got = drive(plan.execute_batch_parts, tabs, cache=cache,
                        parts=parts)
            for p, (w, wa, g, ga) in enumerate(zip(*want, *got)):
                check(identical(w, g) and torch.equal(
                    wa["position_vector"], ga["position_vector"]) and all(
                    identical(a, b) for a, b in zip(wa["shuffle_parts"],
                                                    ga["shuffle_parts"])),
                      f"shuffle plan {ctx} partition {p}: differs")
            served = sum(1 for a in got[1] if a.get("cache") == "exact")
            check(served == (len(parts) if ctx == "warm" else 0),
                  f"shuffle plan {ctx}: {served} served")
        print(f"cache shuffle plan: Q3 lineitem by l_orderkey into "
              f"{SHUFFLE_TARGETS} targets, cold and warm held bitwise "
              f"(slices, position vectors); entries={cache.stats()['entries']}"
              f" device_bytes={cache.bytes}")
    finally:
        metrics.set_metrics(prev)
    return launches


# ------------------------------------------------------------ fault phase
def fault_phase(cat, sync):
    """Every query adaptive under the four fault kinds, each held to its
    clean run and its counters to the plan's ledger; the shuffle plans of
    Q3's and Q18's lineitem split under the same kinds; Q6 under a certain
    pushdown crash (every admitted group demoted); the fail-to-error
    baseline. Returns the launch counts of the driven runs."""
    from repro_torch.compiler import QUERY_IDS
    from repro_torch.core import runtime
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import EngineConfig, plan_requests, run_query
    from repro_torch.core.faults import (CircuitBreaker, FaultExhausted,
                                         FaultPlan, RetryPolicy)
    from repro_torch.obs import metrics
    from repro_torch.queryproc import queries

    drive, launches, host_s = launch_counting(sync)

    def cfg(plan=None, retry=RetryPolicy(sleep_scale=0.0)):
        return EngineConfig(res=StorageResources(storage_power=1.0),
                            mode="adaptive", device=cat.device, faults=plan,
                            retry=retry, breaker=CircuitBreaker())
    prev = metrics.get_metrics()
    try:
        for qid in QUERY_IDS:
            q = queries.build_query(qid)
            clean = drive(run_query, q, cat, cfg())
            t_clean = host_s["done"]
            jit = Jitter(clean.result,
                         lambda: drive(run_query, q, cat, cfg()).result)
            plan = FaultPlan.from_spec(CHAOS_SPEC, seed=int(qid[1:]))
            metrics.set_metrics(metrics.Metrics())
            run = drive(run_query, q, cat, cfg(plan))
            wall = host_s["done"]
            counted = metrics.get_metrics().snapshot()["counters"]
            how = jit.holds(run.result)
            n_pd = sum(1 for o in run.outcomes if o.path == "pushdown")
            check(bool(how), f"faults {qid}: result differs from clean "
                  f"({agree(clean.result, run.result)}, {jit})")
            check(n_pd + run.n_demoted == run.n_admitted,
                  f"faults {qid}: {n_pd} pushed down + {run.n_demoted} "
                  f"demoted != {run.n_admitted} admitted")
            check(all(counted.get(f"faults.{k}", 0) == n
                      for k, n in plan.counts().items()),
                  f"faults {qid}: counters {counted} against the ledger "
                  f"{plan.counts()}")
            rec = run.recovery or {}
            print(f"faults: {qid} adaptive 1.0 {CHAOS_SPEC} seed={qid[1:]}: "
                  f"injected={plan.counts()} retries={rec.get('retries', 0)}"
                  f" demoted={rec.get('n_demoted', 0)} of "
                  f"{run.n_admitted} admitted, walls (single runs) "
                  f"chaos_s={wall:.4f} clean_s={t_clean:.4f}, agree={how} "
                  f"({jit})")
        for qid in ("Q3", "Q18"):
            # a §4.2 shuffle plan's requests split under the same plan:
            # Q3's filter through fused_scan_shuffle, Q18's partial
            # aggregate hashed by hash_partition, on either path
            q = queries.build_query(qid)
            plan = shuffle_plan(q, "lineitem", SHUFFLE_TARGETS)
            reqs = [dataclasses.replace(r, plan=plan)
                    for r in plan_requests(q, cat) if r.table == "lineitem"]
            clean = drive(runtime.execute_split, reqs, {})
            jit = Jitter(clean.merged["lineitem"], lambda: drive(
                runtime.execute_split, reqs, {}).merged["lineitem"])
            fplan = FaultPlan.from_spec(CHAOS_SPEC, seed=int(qid[1:]))
            got = drive(runtime.execute_split, reqs, {}, faults=fplan,
                        retry=RetryPolicy(sleep_scale=0.0))
            how = jit.holds(got.merged["lineitem"])
            check(bool(how) and got.n_pushdown + got.n_demoted == len(reqs)
                  and got.faults_injected == sum(fplan.counts().values()),
                  f"faults: {qid} shuffle plan under {CHAOS_SPEC} differs")
            print(f"faults: {qid} lineitem shuffle plan by {plan.shuffle[0]} "
                  f"into {SHUFFLE_TARGETS} targets, all pushdown: injected="
                  f"{fplan.counts()} retries={got.retries} demoted="
                  f"{got.n_demoted} of {len(reqs)}, result {how} ({jit})")
        metrics.set_metrics(metrics.Metrics())
        q6 = queries.build_query("Q6")
        clean = drive(run_query, q6, cat, cfg())
        jit = Jitter(clean.result,
                     lambda: drive(run_query, q6, cat, cfg()).result)
        plan = FaultPlan.from_spec("pushdown.crash:1.0", seed=1)
        run = drive(run_query, q6, cat, cfg(plan))
        wall = host_s["done"]
        how = jit.holds(run.result)
        check(run.n_admitted > 0 and run.n_demoted == run.n_admitted
              and all(o.path == "pushback" for o in run.outcomes)
              and bool(how),
              f"faults: certain crash demoted {run.n_demoted} of "
              f"{run.n_admitted}, result {how} ({jit})")
        print(f"faults: Q6 pushdown.crash:1.0 demoted all {run.n_demoted} "
              f"admitted requests to pushback, result {how} ({jit}), "
              f"wall_s={wall:.4f}")
        try:
            drive(run_query, q6, cat, cfg(plan, RetryPolicy(
                sleep_scale=0.0, demote_on_exhaust=False)))
        except FaultExhausted as exc:
            print(f"faults: fail-to-error baseline raised: {exc}")
        else:
            check(False, "faults: demote_on_exhaust=False did not raise")
    finally:
        metrics.set_metrics(prev)
    return launches


def stream_queries(gap_s: float):
    """Every compiled query arriving ``gap_s`` apart, and Q6 once more at
    the end (keyed ``Q6#1``)."""
    from repro_torch.compiler import QUERY_IDS
    from repro_torch.core.runtime import StreamQuery
    from repro_torch.queryproc import queries
    qids = [*QUERY_IDS, "Q6"]
    return [StreamQuery(queries.build_query(q), arrival=i * gap_s)
            for i, q in enumerate(qids)]


def check_stream(run, controls, label: str) -> dict:
    """Hold each of a stream's results to its query's ``Jitter`` control
    and its split to the simulation's admitted count and the per-query
    bytes; returns how many results agreed "bitwise" and in "rows"."""
    hows = {}
    for key, res in run.results.items():
        jit = controls[key.split("#")[0]]
        how = jit.holds(res)
        check(bool(how), f"{label}: {key} differs from its uncached run "
              f"({agree(jit.first, res)}, {jit})")
        hows[how] = hows.get(how, 0) + 1
    check(run.n_pushdown + run.n_demoted == run.sim.admitted()
          and run.n_pushdown + run.n_pushback == len(run.sim.per_request)
          and sum(d["real_net_bytes"] for d in run.per_query.values())
          == run.real_net_bytes,
          f"{label}: split {run.n_pushdown}/{run.n_pushback} "
          f"(+{run.n_demoted} demoted) against {run.sim.admitted()} "
          f"admitted, or bytes do not add up")
    return hows


def stream_phase(cat, sync, card: str = "no card"):
    """All 15 queries (and Q6 twice) through ``runtime.run_stream`` in the
    four configs, each query's result held to its own uncached
    ``compile_and_run`` (``Jitter``), the split to the shared simulation
    and the bytes to the per-query sums; then a chaos stream under
    ``CHAOS_SPEC`` with a fixed hedge delay. Each stream starts from a
    fresh metrics registry, so its Arbitrators read their fluid queues
    (no queue depth was published yet) and decide the same in every run.
    ``card`` labels the lines (nvidia-smi's name and power limit). Returns
    the launch counts of the streams."""
    from repro_torch.compiler import QUERY_IDS
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import EngineConfig, compile_and_run
    from repro_torch.core.faults import (CircuitBreaker, FaultPlan,
                                         HedgePolicy, RetryPolicy)
    from repro_torch.core.runtime import run_stream
    from repro_torch.obs import metrics

    on_card = cat.device.type == "cuda"
    drive, launches, host_s = launch_counting(sync)

    def config(mode="adaptive", power=1.0, **kw):
        return EngineConfig(res=StorageResources(storage_power=power),
                            mode=mode, device=cat.device, **kw)
    controls = {}
    for qid in QUERY_IDS:
        first = compile_and_run(qid, cat, config()).result
        controls[qid] = Jitter(first, lambda q=qid: compile_and_run(
            q, cat, config()).result)

    def peak():
        return (f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
                if on_card else "not measured")
    prev = metrics.get_metrics()
    try:
        for mode, power in CONFIGS:
            metrics.set_metrics(metrics.Metrics())
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            run = drive(run_stream, stream_queries(STREAM_GAP_S), cat,
                        config(mode, power))
            hows = check_stream(run, controls, f"stream {mode} {power}")
            check(set(run.results) == {*QUERY_IDS, "Q6#1"},
                  f"stream {mode} {power}: keys {sorted(run.results)}")
            print(f"stream: {len(run.results)} queries {mode} "
                  f"storage_power={power} gap_s={STREAM_GAP_S}: "
                  f"call_s={host_s['done']:.4f} = t_decide_s="
                  f"{run.t_decide:.4f} (planning, the fluid simulation) + "
                  f"wall_clock_s={run.wall_clock:.4f} (execution) "
                  f"pushdown={run.n_pushdown} pushback={run.n_pushback} "
                  f"real_net_bytes={run.real_net_bytes} peak={peak()} "
                  f"agree={hows} [{card}]")
        metrics.set_metrics(metrics.Metrics())
        plan = FaultPlan.from_spec(CHAOS_SPEC, seed=18)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        run = drive(run_stream, stream_queries(STREAM_GAP_S), cat, config(
            faults=plan, retry=RetryPolicy(sleep_scale=1.0),
            breaker=CircuitBreaker(),
            hedge=HedgePolicy(fixed_delay_s=HEDGE_DELAY_S)))
        hows = check_stream(run, controls, "stream chaos")
        c = metrics.get_metrics().snapshot()["counters"]
        hedge = {k: int(c.get(f"hedge.{k}", 0))
                 for k in ("launched", "won", "lost")}
        check(hedge["launched"] > 0
              and hedge["won"] + hedge["lost"] == hedge["launched"]
              and run.hedged == hedge["won"],
              f"stream chaos: hedge counters {hedge}, {run.hedged} won")
        check(all(c.get(f"faults.{k}", 0) == n
                  for k, n in plan.counts().items()),
              f"stream chaos: counters {c} against {plan.counts()}")
        print(f"stream: chaos {CHAOS_SPEC} seed=18, RetryPolicy("
              f"sleep_scale=1.0), HedgePolicy(fixed_delay_s={HEDGE_DELAY_S})"
              f": wall_s={host_s['done']:.4f} injected={plan.counts()} "
              f"retries={run.retries} demoted={run.n_demoted} hedge={hedge} "
              f"exec_samples={int(c.get('stream.exec_samples', 0))} "
              f"peak={peak()} agree={hows} [{card}]")
    finally:
        metrics.set_metrics(prev)
    return launches


def device_busy_s(prof) -> tuple:
    """(seconds in which the card ran at least one kernel or copy in a
    ``torch.profiler`` window, the union of the device events' intervals;
    the number of device events)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6, len(spans)


def trace_phase(cat, sync, card: str = "no card", repeats: int = 5):
    """One adaptive stream of all 15 queries traced, with a
    ``JsonlStreamWriter`` sink and a Chrome trace exported to a temporary
    directory, under ``torch.profiler``: each layer's self time from
    ``span_attribution`` and the card's idle share over the same window;
    then the same stream untraced and traced ``repeats`` times each, in
    turns, ``gc.collect()`` before each: what tracing costs when it is
    on. The profiler records device activity only, so that it adds
    little host time to the window. ``card`` labels the lines. Returns the
    launch counts of the traced stream."""
    import tempfile
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.runtime import run_stream
    from repro_torch.obs import export, metrics, trace

    on_card = cat.device.type == "cuda"
    drive, launches, host_s = launch_counting(sync)
    cfg = EngineConfig(res=StorageResources(storage_power=1.0),
                       mode="adaptive", device=cat.device)
    prev = metrics.get_metrics()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            metrics.set_metrics(metrics.Metrics())
            tr = trace.Tracer()
            writer = export.JsonlStreamWriter(os.path.join(tmp, "s.jsonl"))
            tr.attach_sink(writer)
            prof = (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
                if on_card else contextlib.nullcontext())
            with prof, trace.tracing(tr):
                run = drive(run_stream, stream_queries(STREAM_GAP_S), cat, cfg)
            writer.close()
            wall = host_s["done"]
            _, spans = export.from_jsonl(writer.path)
            chrome = export.to_chrome_trace(tr, os.path.join(tmp, "s.json"))
            with open(chrome) as fh:
                n_events = len(json.load(fh)["traceEvents"])
            check(len(spans) == len(tr.snapshot()) == n_events - 1
                  and all(s["dur"] is not None for s in spans),
                  f"trace: {len(spans)} streamed spans, "
                  f"{len(tr.snapshot())} traced, {n_events} Chrome events")
            for q in tr.find("query"):
                shipped = sum(s.attrs["shipped_bytes"] for s in tr.snapshot()
                              if s.parent == q.sid and s.name in (
                                  "storage_execute", "compute_replay"))
                check(shipped == q.attrs["real_net_bytes"] == run.per_query[
                    q.attrs["qid"]]["real_net_bytes"],
                    f"trace: {q.attrs['qid']} spans ship {shipped} bytes")
        print(f"trace: adaptive 1.0 stream of {len(run.results)} queries "
              f"traced under torch.profiler: wall_s={wall:.4f}, "
              f"{len(spans)} spans streamed to JSONL and exported as a "
              f"Chrome trace [{card}]")
        if on_card:
            busy, n_dev = device_busy_s(prof)
            check(busy > 0, f"trace: the profiler saw no device time "
                  f"({n_dev} device events)")
            print(f"trace: device busy_s={busy:.6f} ({n_dev} device "
                  f"events): idle share {1 - busy / wall:.4f} of the call's "
                  f"{wall:.6f} s, {1 - busy / run.wall_clock:.4f} of the "
                  f"execution's {run.wall_clock:.6f} s (after t_decide "
                  f"{run.t_decide:.6f} s) [{card}]")
        else:
            print("trace: device idle share not measured (no card)")
        for r in export.span_attribution(tr):
            print(f"trace: layer {r['name']} ({r['cat']}) n={r['count']} "
                  f"self_ms={r['self_s'] * 1e3:.3f} "
                  f"total_ms={r['total_s'] * 1e3:.3f} [{card}]")
        walls = {(k, part): [] for k in ("untraced", "traced")
                 for part in ("call", "execution")}
        for _ in range(repeats):
            for kind in ("untraced", "traced"):
                metrics.set_metrics(metrics.Metrics())
                gc.collect()
                sync()
                t0 = time.perf_counter()
                with (trace.tracing() if kind == "traced"
                      else contextlib.nullcontext()):
                    timed = run_stream(stream_queries(STREAM_GAP_S), cat, cfg)
                sync()
                walls[kind, "call"].append(time.perf_counter() - t0)
                walls[kind, "execution"].append(timed.wall_clock)
        for part in ("call", "execution"):
            got = [walls[k, part] for k in ("untraced", "traced")]
            med = [statistics.median(v) for v in got]
            print(f"trace: stream {part} walls, median of {repeats}: "
                  f"untraced_s={med[0]:.4f} traced_s={med[1]:.4f} "
                  f"(traced/untraced {med[1] / med[0]:.4f}; runs "
                  f"{', '.join(f'{w:.4f}' for w in got[0])} / "
                  f"{', '.join(f'{w:.4f}' for w in got[1])}) [{card}]")
    finally:
        metrics.set_metrics(prev)
    return launches


# ------------------------------------------------------------- tier phase
def device_used() -> str:
    """Memory in use on the whole card (every process's contexts and
    allocations, from ``cudaMemGetInfo``)."""
    if not torch.cuda.is_available():
        return "not measured"
    free, total = torch.cuda.mem_get_info()
    return f"{(total - free) / 1e9:.2f} GB"


def worker_launches(pool) -> dict:
    """Kernel launches the pool's live workers made so far, summed."""
    out = {}
    for snap in pool.publish_load().values():
        for n, c in (snap or {}).get("launches", {}).items():
            out[n] = out.get(n, 0) + c
    return out


def tier_phase(cat, sync, card: str = "no card"):
    """The process storage tier: one spawned worker per catalog node holds
    the node's partitions (shipped over the wire) and runs the kernels on
    them. Every query in three configs through ``compile_and_run`` with
    the pool, each held to its in-process run (results under ``Jitter``,
    splits and real bytes equal); every query's seed-7 random decision
    vector and the shuffle plans of Q3 and Q18 through
    ``execute_split(tier=pool)``, held to the in-process split; the stream
    phase's stream on the tier beside the in-process one; on a fresh pool
    the same stream with node 0 killed mid-stream (recovered, counters
    equal to ``pool.events``); one traced split with the workers' spans;
    Q6 failing to error once the first pool's node 0 dies. A hang past ``TIER_DEADLINE_S`` ends
    the process. Returns the launch counts: the parent's in the driven
    tier runs plus those inside the first pool's workers (on the card,
    ``predicate_bitmap``, ``fused_scan_agg`` and the shuffle kernels must
    launch inside the workers, ``grouped_agg`` in the parent's
    residuals)."""
    import faulthandler

    import numpy as np

    from repro_torch.compiler import QUERY_IDS
    from repro_torch.core import runtime
    from repro_torch.core.arbitrator import PUSHBACK, PUSHDOWN
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import (EngineConfig, compile_and_run,
                                         plan_requests)
    from repro_torch.core.faults import FaultExhausted, RetryPolicy
    from repro_torch.distributed.workers import WorkerPool
    from repro_torch.obs import metrics, trace
    from repro_torch.queryproc import queries

    on_card = cat.device.type == "cuda"
    drive, launches, host_s = launch_counting(sync)
    fast = RetryPolicy(sleep_scale=0.0)
    marks = [time.perf_counter()]

    def step(what):
        marks.append(time.perf_counter())
        print(f"tier: {what} in {marks[-1] - marks[-2]:.2f} s")

    def config(mode="adaptive", power=1.0, **kw):
        return EngineConfig(res=StorageResources(storage_power=power),
                            mode=mode, device=cat.device, **kw)

    def counted(name):
        return int(metrics.get_metrics().snapshot()["counters"].get(name, 0))

    def new_pool(label):
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        print(f"tier: device memory in use before spawning the {label} pool "
              f"{device_used()} [{card}]")
        pool = WorkerPool(cat, pd_slots=TIER_SLOTS)
        wire = pool.wire_bytes()
        print(f"tier: {label} pool of {len(pool.workers)} workers: spawned "
              f"and started in {pool.start_s:.2f} s, {wire['sent']} bytes "
              f"shipped in {pool.ship_s:.2f} s "
              f"({wire['sent'] / pool.ship_s / 1e9:.3f} GB/s), device "
              f"memory in use {device_used()}; workers " + ", ".join(
                  f"node {n} pid {w['pid']} on {w['device']} ({w['name']})"
                  for n, w in pool.workers.items()) + f" [{card}]")
        check(all(w["pid"] != os.getpid() and w["device"] == str(cat.device)
                  for w in pool.workers.values()),
              f"tier: workers {pool.workers} not on {cat.device}")
        return pool

    faulthandler.dump_traceback_later(TIER_DEADLINE_S, exit=True,
                                      file=sys.__stderr__)
    prev = metrics.set_metrics(metrics.Metrics())
    pool = None
    try:
        pool = new_pool("first")
        before = worker_launches(pool)
        step("spawning and shipping")

        # every query through the engine on the pool, beside in-process
        controls = {}
        for mode, power in TIER_CONFIGS:
            for qid in QUERY_IDS:
                base = config(mode, power, measured_feedback=False)
                sync()
                t0 = time.perf_counter()
                ref = compile_and_run(qid, cat, base)
                sync()
                t_ref = time.perf_counter() - t0
                jit = Jitter(ref.result,
                             lambda q=qid, b=base: compile_and_run(
                                 q, cat, b).result)
                if (mode, power) == ("adaptive", 1.0):
                    controls[qid] = jit
                wire0 = [counted(n) for n in WIRE_COUNTERS]
                got = drive(compile_and_run, qid, cat, dataclasses.replace(
                    base, worker_pool=pool, retry=fast))
                wire = [counted(n) - w for n, w in zip(WIRE_COUNTERS, wire0)]
                how = jit.holds(got.result)
                same = ((got.n_admitted, got.n_pushed_back,
                         got.real_net_bytes) == (ref.n_admitted,
                                                 ref.n_pushed_back,
                                                 ref.real_net_bytes))
                check(bool(how) and same and got.n_demoted == 0,
                      f"tier {qid} {mode} {power}: result {how or 'differs'} "
                      f"({jit}), split {got.n_admitted}/{got.n_pushed_back} "
                      f"{got.real_net_bytes} against {ref.n_admitted}/"
                      f"{ref.n_pushed_back} {ref.real_net_bytes}, demoted "
                      f"{got.n_demoted}")
                print(f"tier: {qid} {mode} {power}: wall_s={host_s['done']:.4f}"
                      f" inproc_s={t_ref:.4f} admitted={got.n_admitted} "
                      f"pushed_back={got.n_pushed_back} real_net_bytes="
                      f"{got.real_net_bytes} wire.pushdown_result_bytes="
                      f"{wire[0]} wire.pushback_ship_bytes={wire[1]} "
                      f"agree={how} ({jit}) [{card}]")
        step(f"{len(TIER_CONFIGS)} x 15 queries on both tiers")

        # seed-7 random decision vectors, and the §4.2 shuffle plans
        rng = np.random.default_rng(7)
        hows = {}
        for qid in QUERY_IDS:
            reqs = plan_requests(queries.build_query(qid), cat)
            dec = {r.req_id: (PUSHDOWN if rng.random() < 0.5 else PUSHBACK)
                   for r in reqs}
            ref = runtime.execute_split(reqs, dec)
            got = drive(runtime.execute_split, reqs, dec, retry=fast,
                        tier=pool)
            for table, res in ref.merged.items():
                jit = Jitter(res, lambda r=reqs, d=dec, t=table:
                             runtime.execute_split(r, d).merged[t])
                how = jit.holds(got.merged[table])
                check(bool(how), f"tier {qid} random decisions: {table} "
                      f"{agree(res, got.merged[table]) or 'differs'} ({jit})")
                hows[how] = hows.get(how, 0) + 1
            check(got.n_demoted == 0 and (got.n_pushdown, got.n_pushback,
                                          got.real_net_bytes)
                  == (ref.n_pushdown, ref.n_pushback, ref.real_net_bytes),
                  f"tier {qid} random decisions: split or bytes differ")
        print(f"tier: 15 queries under seed-7 random decision vectors "
              f"through execute_split(tier=pool): merged tables {hows} "
              f"[{card}]")
        step("the random decision vectors")
        for qid in ("Q3", "Q18"):
            q = queries.build_query(qid)
            plan = shuffle_plan(q, "lineitem", SHUFFLE_TARGETS)
            reqs = [dataclasses.replace(r, plan=plan)
                    for r in plan_requests(q, cat) if r.table == "lineitem"]
            ref = runtime.execute_split(reqs, {})
            jit = Jitter(ref.merged["lineitem"], lambda r=reqs:
                         runtime.execute_split(r, {}).merged["lineitem"])
            got = drive(runtime.execute_split, reqs, {}, retry=fast,
                        tier=pool)
            how = jit.holds(got.merged["lineitem"])
            check(bool(how) and got.n_pushdown == len(reqs)
                  and got.real_net_bytes == ref.real_net_bytes,
                  f"tier: {qid} shuffle plan {how or 'differs'} ({jit})")
            print(f"tier: {qid} lineitem shuffle plan by {plan.shuffle[0]} "
                  f"into {SHUFFLE_TARGETS} targets, all pushdown on the "
                  f"workers: wall_s={host_s['done']:.4f} result {how} ({jit})"
                  f" [{card}]")
        step("the shuffle plans")

        # the stream, in-process and on the tier, with measured load
        metrics.set_metrics(metrics.Metrics())
        inproc = runtime.run_stream(stream_queries(STREAM_GAP_S), cat,
                                    config())
        done0 = pool.publish_load()[0]["done"]
        # a fresh registry: the poll above published gauges, and the
        # stream's one simulation must read what the in-process one read
        metrics.set_metrics(metrics.Metrics())
        run = drive(runtime.run_stream, stream_queries(STREAM_GAP_S), cat,
                    config(worker_pool=pool))
        items0 = pool.publish_load()[0]["done"] - done0
        check_stream(run, controls, "tier stream")
        print(f"tier: stream of {len(run.results)} adaptive 1.0 on the tier:"
              f" t_decide_s={run.t_decide:.4f} wall_clock_s="
              f"{run.wall_clock:.4f} pushdown={run.n_pushdown} pushback="
              f"{run.n_pushback} real_net_bytes={run.real_net_bytes}; "
              f"in-process t_decide_s={inproc.t_decide:.4f} wall_clock_s="
              f"{inproc.wall_clock:.4f} pushdown={inproc.n_pushdown} "
              f"pushback={inproc.n_pushback} real_net_bytes="
              f"{inproc.real_net_bytes}; node 0 ran {items0} work items "
              f"[{card}]")
        check((run.n_pushdown, run.n_pushback, run.real_net_bytes)
              == (inproc.n_pushdown, inproc.n_pushback,
                  inproc.real_net_bytes),
              "tier stream: split or bytes differ from in-process")
        step("the streams")

        # one traced split: the workers' spans adopted, from their pids
        reqs = plan_requests(queries.build_query("Q6"), cat)
        half = {r.req_id: (PUSHDOWN if i % 2 == 0 else PUSHBACK)
                for i, r in enumerate(reqs)}
        with trace.tracing() as tr:
            drive(runtime.execute_split, reqs, half, retry=fast, tier=pool)
        spans = tr.find("worker_execute") + tr.find("worker_fetch")
        pids = {w["pid"] for w in pool.workers.values()}
        check(tr.find("worker_execute") and tr.find("worker_fetch") and all(
            s.attrs["pid"] in pids and s.attrs["pid"] != os.getpid()
            and s.attrs["remote_parent"] == s.parent for s in spans),
            "tier trace: worker spans missing or not the workers'")
        print(f"tier: traced Q6 split: {len(spans)} worker spans adopted "
              f"from pids {sorted({s.attrs['pid'] for s in spans})} (parent "
              f"{os.getpid()})")
        after = worker_launches(pool)
        inside = {n: after.get(n, 0) - before.get(n, 0) for n in launches}
        parent = dict(launches)
        print(f"tier: kernel launches inside the first pool's workers "
              f"{inside}, in the parent (replays and residuals) so far "
              f"{parent}; device memory in use {device_used()} [{card}]")
        if on_card:
            # partial aggregates are fused_scan_agg's; grouped_agg runs in
            # the residual, which stays in the parent
            check(all(inside[n] > 0 for n in (
                "predicate_bitmap", "fused_scan_agg", "fused_scan_shuffle",
                "hash_partition")) and parent["grouped_agg"] > 0,
                f"tier: launches inside the workers {inside}, parent "
                f"{parent}")

        # the fail-to-error baseline: node 0 dies at its next work item
        pool.die_after(0, 0)
        try:
            drive(runtime.run_stream,
                  [runtime.StreamQuery(queries.build_query("Q6"))], cat,
                  config(worker_pool=pool, retry=RetryPolicy(
                      sleep_scale=0.0, demote_on_exhaust=False)))
        except RuntimeError as exc:
            check(isinstance(exc.__cause__, FaultExhausted),
                  f"tier: no-demote stream raised {exc!r}")
            print(f"tier: Q6 with demote_on_exhaust=False after node 0 died "
                  f"raised: {exc.__cause__}")
        else:
            check(False, "tier: demote_on_exhaust=False did not raise")
        pool.close()
        step("the traced split and the fail-to-error baseline")

        # a fresh pool: node 0 dies mid-stream, the stream recovers
        metrics.set_metrics(metrics.Metrics())
        pool = new_pool("second")
        k = max(1, items0 // 2)
        pool.die_after(0, k)
        run = drive(runtime.run_stream, stream_queries(STREAM_GAP_S), cat,
                    config(worker_pool=pool, retry=fast))
        check_stream(run, controls, "tier kill stream")
        c = metrics.get_metrics().snapshot()["counters"]
        faults_n = int(c.get("faults.crash", 0) + c.get("faults.timeout", 0))
        check(not pool.alive(0) and run.n_demoted > 0
              and faults_n == len(pool.events) > 0,
              f"tier kill stream: node 0 alive {pool.alive(0)}, demoted "
              f"{run.n_demoted}, faults {faults_n} against "
              f"{len(pool.events)} events")
        print(f"tier: stream with node 0 killed at its work item {k + 1}: "
              f"wall_s={host_s['done']:.4f} demoted={run.n_demoted} "
              f"retries={run.retries} faults.crash+timeout={faults_n} == "
              f"pool.events={len(pool.events)} [{card}]")
        pool.close()
        pool = None
        step("the second pool and the kill stream")
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        print(f"tier: device memory in use after the pools closed "
              f"{device_used()} [{card}]")
        for n in launches:
            launches[n] += inside[n]
    finally:
        if pool is not None:
            pool.close()
        metrics.set_metrics(prev)
        faulthandler.cancel_dump_traceback_later()
    return launches


# ------------------------------------------------------ pipeline phase
def epoch_plan(hists, order0, order1, need: int, doc_len: int):
    """(batches the first epoch completes, launches until one batch more).
    ``hists[pi]`` are partition ``pi``'s kept documents per rank; batches
    drain as soon as every rank holds ``need`` tokens."""
    per_rank = [0] * len(hists[0])
    for pi in order0:
        per_rank = [a + h * doc_len for a, h in zip(per_rank, hists[pi])]
    epoch = min(per_rank) // need
    per_rank = [0] * len(per_rank)
    for n, pi in enumerate([*order0, *order1], start=1):
        per_rank = [a + h * doc_len for a, h in zip(per_rank, hists[pi])]
        if min(per_rank) // need > epoch:
            return epoch, n
    raise RuntimeError("two epochs do not make one batch more than one")


def pipeline_phase(corpus_kw: dict, query_kw: dict, device, timer, sync,
                   card: str = "no card"):
    """The pushdown data pipeline (``repro_torch.data.pipeline``): the
    corpus uploaded once, one epoch of batches and one more drawn (every
    partition's filter and shuffle one ``fused_scan_shuffle`` launch),
    each partition's launch held bitwise to the plain version and timed,
    the first ``PIPE_CPU_BATCHES`` held bitwise to the same pipeline on the
    CPU, and ``stats()`` in ``PIPE_MODES`` at ``PIPE_POWERS`` with the same
    batches. Returns (launches of the driven epoch, the kernel record at
    the pipeline's shape, the first two batches)."""
    import numpy as np

    from repro_torch.core.cost import StorageResources
    from repro_torch.data.pipeline import (CorpusQuery, PushdownDataPipeline,
                                           synth_corpus)
    from repro_torch.kernels import fused_scan_shuffle as fss
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.program import program_for

    t0 = time.perf_counter()
    corpus = synth_corpus(**corpus_kw)
    t_synth = time.perf_counter() - t0
    query = CorpusQuery(**query_kw)
    t0 = time.perf_counter()
    pipe = PushdownDataPipeline(corpus, query, device=device)
    sync()
    t_up = time.perf_counter() - t0
    n_tok = sum(p.tokens.size for p in corpus)
    print(f"pipeline: corpus {len(corpus)} partitions x "
          f"{corpus_kw['docs_per_part']} docs x {corpus_kw['doc_len']} "
          f"tokens ({n_tok} int32 tokens) made in {t_synth:.2f} s, on "
          f"{device} in {t_up:.2f} s; {card}")

    # every partition's launch against the plain version, timed (the
    # plain version, whose host time is ~100x the launch's, on a few)
    t0 = time.perf_counter()
    expr, P = query.predicate(), query.dp_ranks
    hists, ms, plain_ms = [], [], []
    for pi, part in enumerate(pipe._parts):
        got = kops.fused_scan_shuffle(part.cols, expr, part.doc_id, P)
        prog = program_for(expr, part.cols)
        pcols = [part.cols[c] for c in prog.columns]
        want = ref.fused_scan_shuffle(prog, pcols, part.doc_id, P)
        check(all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, want)),
              "pipeline: a partition's fused_scan_shuffle differs from the "
              "plain version")
        hists.append(got[2].tolist())
        ms.append(timer(lambda: fss.fused_scan_shuffle(
            prog, pcols, part.doc_id, P)))
        if pi < PIPE_PLAIN_TIMED:
            plain_ms.append(timer(lambda: ref.fused_scan_shuffle(
                prog, pcols, part.doc_id, P)))
    t_held = time.perf_counter() - t0
    R = corpus_kw["docs_per_part"]
    b_ms, b_by = bound(nbytes(*pcols, part.doc_id, *got),
                       R * (prog.n_ops + 3))
    record = dict(name="fused_scan_shuffle", max_abs_err=0.0,
                  ms=statistics.median(ms), plain_ms=statistics.median(
                      plain_ms), bound_ms=b_ms, bound_by=b_by,
                  library_ms=None,
                  shape=f"corpus partition, R={R}, quality >= "
                        f"{query.min_quality} & domain in "
                        f"{len(query.domains or ())} values, int64 doc_id, "
                        f"P={P}; median of {len(ms)} partitions (min "
                        f"{min(ms):.4f}, max {max(ms):.4f}; bound "
                        f"{b_ms:.3g}), plain of {len(plain_ms)}")

    # one epoch and one batch more, counted
    rng = np.random.default_rng(pipe.seed)
    order0, order1 = rng.permutation(len(corpus)), rng.permutation(
        len(corpus))
    mb = query.global_batch // query.accum
    need = query.seq_len * max(1, mb // P) * query.accum
    epoch, expect = epoch_plan(hists, order0, order1, need,
                               corpus_kw["doc_len"])
    drive, launches, host_s = launch_counting(sync)
    first = []

    def draw():
        for i in range(epoch + 1):
            b = next(pipe)["tokens"]
            if i < max(PIPE_CPU_BATCHES, 2):
                first.append(b)
    drive(draw)
    shape = (query.accum, mb, query.seq_len)
    check(all(tuple(b.shape) == shape and b.dtype == torch.int32 and
              b.device.type == torch.device(device).type for b in first),
          "pipeline: a batch has the wrong shape, dtype or device")
    # CPU tensors run the plain version, which counts no launch
    want = expect if torch.device(device).type == "cuda" else 0
    check(launches["fused_scan_shuffle"] == want,
          f"pipeline: {launches['fused_scan_shuffle']} launches, the epoch "
          f"plan needs {want}")
    check(expect > len(corpus), "pipeline: the epoch left a partition out")
    check(all(n == 0 for k, n in launches.items()
              if k != "fused_scan_shuffle"),
          "pipeline: a kernel other than fused_scan_shuffle launched")
    tok = (epoch + 1) * query.global_batch * query.seq_len
    print(f"pipeline: {epoch} batches {shape} in the epoch, {epoch + 1} "
          f"drawn with {expect} fused_scan_shuffle launches in "
          f"{host_s['done']:.4f} s ({tok / host_s['done']:.0f} tokens/s); "
          f"launch median {record['ms']:.4f} ms over {len(ms)} partitions, "
          f"plain {record['plain_ms']:.4f} ms; {card}")

    t0 = time.perf_counter()
    cpu = PushdownDataPipeline(corpus, query, device="cpu")
    for i in range(PIPE_CPU_BATCHES):
        check(torch.equal(first[i].cpu(), next(cpu)["tokens"]),
              f"pipeline: batch {i} differs from the CPU pipeline's")
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = {}
    for mode in PIPE_MODES:
        for power in PIPE_POWERS:
            p = PushdownDataPipeline(corpus, query, StorageResources(
                storage_power=power), mode=mode, device=device)
            check(torch.equal(next(p)["tokens"], first[0]),
                  f"pipeline: {mode} at power {power} gives another batch")
            st = stats[mode, power] = p.stats()
            check(st["admitted"] + st["pushed_back"] == len(corpus),
                  f"pipeline: {mode} {power} loses a partition's decision")
            check(mode != "no_pushdown" or st["admitted"] == 0,
                  "pipeline: no_pushdown admitted a pushdown")
            check(mode != "eager" or st["pushed_back"] == 0,
                  "pipeline: eager pushed a partition back")
            print(f"pipeline stats: {mode} power={power}: admitted "
                  f"{st['admitted']:.0f}, pushed back "
                  f"{st['pushed_back']:.0f}, ingest makespan "
                  f"{st['ingest_makespan_s']:.6f} s (simulated), ingest "
                  f"net bytes {st['ingest_net_bytes']:.0f}")
            del p
    check(stats["adaptive", 0.1]["pushed_back"] >=
          stats["adaptive", 1.0]["pushed_back"],
          "pipeline: adaptive pushed back less at power 0.1 than at 1.0")
    print(f"pipeline: {len(ms)} launches held and timed in {t_held:.2f} s, "
          f"{PIPE_CPU_BATCHES} batches held to the CPU's in {t_cpu:.2f} s, "
          f"{len(stats)} mode pipelines in {time.perf_counter() - t0:.2f} s")
    return launches, record, first[:2]


# --------------------------------------------------------- serve phase
def held(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Max abs difference of two logit tensors, checked finite and within
    ``MODEL_TOL`` (rtol = atol)."""
    a, b = a.float().cpu(), b.float().cpu()
    err = float((a - b).abs().max())
    check(bool(torch.isfinite(a).all()) and torch.allclose(
        a, b, rtol=MODEL_TOL, atol=MODEL_TOL),
          f"{what} differ (max abs {err:.3g})")
    return err


def synced(fn, sync):
    """``fn()`` and its seconds, between two ``sync()`` calls."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def left_padded(prompts, device) -> torch.Tensor:
    """Prompts right-aligned in one (B, P) int32 batch, left-padded with 0
    as the engine pads a wave."""
    P = max(len(p) for p in prompts)
    toks = torch.zeros((len(prompts), P), dtype=torch.int32)
    for b, p in enumerate(prompts):
        toks[b, P - len(p):] = torch.from_numpy(p)
    return toks.to(device)


def decode_seconds(model, cfg, toks, max_len: int, steps: int, sync):
    """Seconds of ``steps`` greedy decode steps at ``toks``'s batch, from a
    decode cache of ``max_len`` built over ``toks``."""
    from repro_torch.models import api
    _, cache = api.build_decode_cache(model, cfg, {"tokens": toks}, max_len)
    tok = toks[:, -1:]

    def run():
        nonlocal cache, tok
        for i in range(steps):
            logits, cache = api.decode_step(model, cfg, cache,
                                            toks.shape[1] + i, tok)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    return synced(run, sync)[1]


def serve_phase(cfg, batches, device, sync, card: str = "no card",
                seed: int = 0, reduced: bool = False):
    """The generic decoder and the serving engine at ``cfg``'s width:
    parameters drawn on ``device``, ``loss_fn`` over every microbatch of
    the pipeline's ``batches``, the blocked prefill of one row with and
    without ``causal_skip`` against the materialized one, a decode step
    against forward, the ``ServingEngine`` over ``SERVE_REQUESTS``
    requests cut from pipeline rows (both prefill branches), the chunked
    prefill's last logits against the batched one's on a wave; then
    ``family_phase`` for each of ``FAMILIES`` (at the published width, or
    the reduced config when ``reduced``), and all ten architectures'
    reduced configs on ``device`` against the CPU. Tolerances:
    ``MODEL_TOL`` (rtol = atol), the JAX package's model tests'."""
    import math

    import numpy as np

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import api
    from repro_torch.models.params import tree_map_specs
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    def close(a, b, what):
        return held(a, b, f"serve: {what}")

    def timed(fn):
        return synced(fn, sync)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    model, s = timed(lambda: api.init_params(cfg, gen, device))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == api.count_params(cfg), "serve: parameter count")
    print(f"serve: {cfg.name} {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params} parameters "
          f"({2 * n_params / 1e9:.2f} GB bf16) drawn on {device} in "
          f"{s:.2f} s; {card}")

    # loss over every microbatch of the pipeline's batches
    losses, secs = [], []
    for b in batches:
        for mb in b:
            loss, s = timed(lambda: float(api.loss_fn(model, cfg,
                                                      {"tokens": mb})))
            check(math.isfinite(loss) and 0.5 * math.log(cfg.vocab_size)
                  < loss < 3.0 * math.log(cfg.vocab_size),
                  f"serve: loss {loss} outside (0.5, 3) ln V")
            losses.append(loss)
            secs.append(s)
    mb_tok = batches[0][0].numel()
    print(f"serve: loss_fn over {len(losses)} microbatches "
          f"{tuple(batches[0][0].shape)}: losses {min(losses):.4f}.."
          f"{max(losses):.4f} (ln V = {math.log(cfg.vocab_size):.4f}), "
          f"median {statistics.median(secs) * 1e3:.1f} ms a microbatch, "
          f"{mb_tok / statistics.median(secs):.0f} tokens/s (first call "
          f"{secs[0] * 1e3:.1f} ms); {card}")

    # the blocked prefill at full length, and prefill/decode consistency
    row = batches[0][0][:1]                           # (1, S)
    S = row.shape[1]
    (full, _, _, _), s_full = timed(lambda: api.forward(
        model, cfg, {"tokens": row}))
    for skip in (False, True):
        (lg, _, _, (k, v)), s = timed(lambda: api.forward(
            model, cfg, {"tokens": row}, blockwise=True, causal_skip=skip,
            collect_cache=True))
        err = close(lg, full, f"blocked prefill (causal_skip={skip}) logits")
        check(tuple(k.shape) == (cfg.num_layers, 1, S, cfg.num_kv_heads,
                                 cfg.head_dim), "serve: prefill cache shape")
        print(f"serve: prefill S={S} blocked causal_skip={skip} "
              f"{s * 1e3:.1f} ms (materialized {s_full * 1e3:.1f} ms), "
              f"max abs err {err:.3g} against the materialized; {card}")
        del lg, k, v
    last, cache = api.build_decode_cache(model, cfg,
                                         {"tokens": row[:, :S - 1]}, S)
    err_last = close(last, full[:, -2], "prefill's last logits and forward")
    (dec, _), s = timed(lambda: api.decode_step(model, cfg, cache, S - 1,
                                                row[:, S - 1:]))
    err_dec = close(dec[:, 0], full[:, -1], "decode step and forward")
    print(f"serve: prefill/decode consistency at S={S}: max abs err "
          f"{err_last:.3g} (prefill), {err_dec:.3g} (decode step, "
          f"{s * 1e3:.1f} ms at B=1); {card}")
    del full, last, cache, dec

    # the engine: waves of max_batch, the last one smaller
    scfg = ServeConfig(**SERVE)
    rng = np.random.default_rng(seed)
    rows = torch.cat([b.reshape(-1, b.shape[-1]) for b in batches])
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1,
                        SERVE_REQUESTS)
    prompts = [rows[i, :n].cpu().numpy() for i, n in enumerate(lens)]
    reqs = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
            for i, p in enumerate(prompts)]
    eng = ServingEngine(cfg, model, scfg)
    _, s = timed(lambda: eng.serve(reqs))
    waves = -(-SERVE_REQUESTS // scfg.max_batch)
    chunked = sum(eng.policy.chunked(len(reqs[i:i + scfg.max_batch]))
                  for i in range(0, SERVE_REQUESTS, scfg.max_batch))
    check(all(len(r.out_tokens) == SERVE_MAX_NEW and r.done for r in reqs),
          "serve: a request missed its budget")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
          "serve: a token outside the vocabulary")
    check(eng.chunked_prefills == chunked and 0 < chunked < waves,
          f"serve: {eng.chunked_prefills} chunked prefills of {waves} "
          f"waves, the policy asks for {chunked} and a batched one")
    out_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"serve: engine {SERVE_REQUESTS} requests (prompts "
          f"{min(lens)}..{max(lens)} tokens, {SERVE_MAX_NEW} new each) in "
          f"{waves} waves, {eng.chunked_prefills} chunked and "
          f"{waves - eng.chunked_prefills} batched prefills: {out_tok} "
          f"tokens in {s:.3f} s, {out_tok / s:.1f} served tokens/s; {card}")

    # the chunked prefill's last logits against the batched one's
    wave = prompts[:scfg.max_batch]
    toks = left_padded(wave, device)
    P = toks.shape[1]
    batched = ServingEngine(cfg, model, dataclasses.replace(
        scfg, prefill_chunk=scfg.max_len))
    lb, cb = batched._prefill(toks, live_slots=len(wave))
    lc, cc = eng._prefill(toks, live_slots=len(wave))
    err = close(lc, lb, "chunked and batched prefill's last logits")
    print(f"serve: chunked against batched prefill on a wave of "
          f"{len(wave)} x {P}: max abs err {err:.3g}; {card}")
    del lb, cb, lc, cc

    # decode steps at the engine's batch, from a prefilled wave
    s = decode_seconds(model, cfg, toks, scfg.max_len, SERVE_MAX_NEW, sync)
    peak = (f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            if on_card else "not measured")
    print(f"serve: decode {s / SERVE_MAX_NEW * 1e3:.2f} ms a step at "
          f"B={len(wave)}, cache {scfg.max_len}; peak "
          f"max_memory_allocated {peak}; {card}")
    del model, eng, batched
    if on_card:
        torch.cuda.empty_cache()

    # the other families, one at a time
    for arch, shapes in FAMILIES.items():
        t0 = time.perf_counter()
        family_phase(get_config(arch, reduced), shapes, device, sync, card,
                     seed, 0 if reduced else PUBLISHED_PARAMS[arch])
        print(f"family: {arch} in {time.perf_counter() - t0:.2f} s")

    # every architecture's reduced config: device against CPU, the CPU
    # copy made through the family's own module
    for arch in ARCH_IDS:
        small = get_config(arch, reduced=True)
        m = api.init_params(small, torch.Generator(device=device)
                            .manual_seed(seed), device)
        mcpu = type(m)(small, tree_map_specs(lambda t: t.cpu(), m.tree()))
        g = torch.Generator().manual_seed(seed)
        batch = {"tokens": torch.randint(0, small.vocab_size, (2, 64),
                                         generator=g, dtype=torch.int32)}
        if small.family == "audio":
            batch["frames"] = torch.randn(
                (2, small.num_audio_frames, small.d_model),
                generator=g).to(torch.bfloat16)
        if small.family == "vlm":
            batch["patches"] = torch.randn(
                (2, small.num_patches, small.patch_dim),
                generator=g).to(torch.bfloat16)
        lg, aux, _, _ = api.forward(m, small, {k: v.to(device)
                                               for k, v in batch.items()})
        lgc, auxc, _, _ = api.forward(mcpu, small, batch)
        err = close(lg, lgc, f"{arch} reduced logits on {device} and CPU")
        close(aux, auxc, f"{arch} reduced aux on {device} and CPU")
        print(f"serve: {arch} reduced ({small.num_layers} layers, d_model "
              f"{small.d_model}) on {device} against the CPU: max abs err "
              f"{err:.3g}")


def family_phase(cfg, shapes: dict, device, sync, card: str = "no card",
                 seed: int = 0, published: int = 0) -> None:
    """One of the ssm, hybrid and audio families at ``cfg``'s width, on
    ``device``: parameters drawn from ``seed``, ``loss_fn`` on a
    ``shapes["loss"]`` batch (a first call and a warm one), a prefill of
    ``shapes["prefill"]`` tokens and a decode step held to forward one
    token longer in fp32 (bf16's errors printed); for the families the
    engine serves, a ``ServingEngine``
    over ``FAMILY_REQUESTS`` prompts and ``FAMILY_MAX_NEW`` decode steps
    timed at the engine's batch. Token ids (and whisper's frames) are
    drawn from the seed's generator, below the vocabulary. ``published``
    (when not 0) is the count ``count_params`` must give."""
    import math

    import numpy as np

    from repro_torch.models import api
    from repro_torch.models.params import tree_map_specs
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    def close(a, b, what):
        return held(a, b, f"{cfg.name}: {what}")

    def timed(fn):
        return synced(fn, sync)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    model, s = timed(lambda: api.init_params(cfg, gen, device))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == api.count_params(cfg) and
          (not published or n_params == published),
          f"{cfg.name}: {n_params} parameters, count_params "
          f"{api.count_params(cfg)}, published {published or 'n/a'}")
    print(f"family: {cfg.name} ({cfg.family}) {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {n_params} "
          f"parameters (count_params {api.count_params(cfg)}) drawn on "
          f"{device} in {s:.2f} s; {card}")

    def batch_of(B, S):
        b = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=device,
                                     dtype=torch.int32)}
        if cfg.family == "audio":  # the frontend stub's frame embeddings
            b["frames"] = torch.randn(
                (B, cfg.num_audio_frames, cfg.d_model), generator=gen,
                device=device).to(torch.bfloat16)
        return b

    B, S = shapes["loss"]
    batch = batch_of(B, S)
    runs = []
    for _ in range(2):  # the first call, then a warm one
        loss, s = timed(lambda: float(api.loss_fn(model, cfg, batch)))
        check(math.isfinite(loss) and 0.5 * math.log(cfg.vocab_size)
              < loss < 3.0 * math.log(cfg.vocab_size),
              f"{cfg.name}: loss {loss} outside (0.5, 3) ln V")
        runs.append((loss, s))
    (loss, s), first = runs[1], runs[0][1]
    print(f"family: {cfg.name} loss_fn on ({B}, {S}): loss {loss:.4f} "
          f"(ln V = {math.log(cfg.vocab_size):.4f}), {s * 1e3:.1f} ms "
          f"({B * S / s:.0f} tokens/s; first call {first * 1e3:.1f} ms); "
          f"{card}")
    del batch

    # a prefill, then one decode step against forward over one more token,
    # held in fp32 on the same parameters widened exactly. In bf16 two
    # valid orders of the arithmetic (a decode step's matmuls at M = B
    # rows, forward's at B x S; a prompt one token shorter) part by about
    # an ulp a layer, and at these depths that adds up past the tolerance
    # (on an NVIDIA H100 80GB HBM3 at 700 W: mamba2-2.7b's decode 0.0444
    # off forward, whisper-small's prefill 0.0261), as the reference's
    # bf16 does (tests/test_torch_recurrent.py::
    # test_bf16_noise_at_depth_is_the_references): the bf16 run's errors
    # are printed beside the fp32 forward's
    P = shapes["prefill"]
    row = batch_of(1 if cfg.family == "hybrid" else 2, P + 1)
    pre = dict(row, tokens=row["tokens"][:, :P])
    (last, cache), s_pre = timed(lambda: api.build_decode_cache(
        model, cfg, pre, P + 8))
    (dec, _), s_dec = timed(lambda: api.decode_step(
        model, cfg, cache, P, row["tokens"][:, P:]))
    (full, _, _, _), s_full = timed(lambda: api.forward(model, cfg, row))
    del cache
    wide = type(model)(cfg, tree_map_specs(lambda t: t.float(),
                                           model.tree()))
    row32 = {k: (v.float() if v.is_floating_point() else v)
             for k, v in row.items()}
    pre32 = dict(row32, tokens=row32["tokens"][:, :P])
    last32, cache32 = api.build_decode_cache(wide, cfg, pre32, P + 8)
    dec32, _ = api.decode_step(wide, cfg, cache32, P, row32["tokens"][:, P:])
    full32 = api.forward(wide, cfg, row32)[0]
    err32 = (close(last32, full32[:, -2], "fp32 prefill's last logits and "
                   "forward"),
             close(dec32[:, 0], full32[:, -1], "fp32 decode step and forward"))
    e = lambda a, b: float((a.float() - b).abs().max())  # noqa: E731
    print(f"family: {cfg.name} prefill of {P} tokens at B="
          f"{row['tokens'].shape[0]} {s_pre * 1e3:.1f} ms, a decode step "
          f"{s_dec * 1e3:.1f} ms, forward over {P + 1} {s_full * 1e3:.1f} "
          f"ms; fp32 max abs err {err32[0]:.3g} (prefill), {err32[1]:.3g} "
          f"(decode) against forward, tolerance {MODEL_TOL}; bf16 "
          f"{e(last, full[:, -2]):.3g} (prefill), "
          f"{e(dec[:, 0], full[:, -1]):.3g} (decode) against bf16 "
          f"forward, and against the fp32 forward "
          f"{e(full[:, -1], full32[:, -1]):.3g} (forward), "
          f"{e(dec[:, 0], full32[:, -1]):.3g} (decode); {card}")
    del last, dec, full, row, pre, wide, row32, pre32, last32, cache32
    del dec32, full32

    if cfg.family != "audio":  # the engine serves mamba2 and recurrentgemma
        scfg = ServeConfig(**SERVE)
        lens = np.random.default_rng(seed).integers(
            SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, FAMILY_REQUESTS)
        prompts = [torch.randint(1, cfg.vocab_size, (int(n),), generator=gen,
                                 device=device, dtype=torch.int32
                                 ).cpu().numpy() for n in lens]
        reqs = [Request(rid=i, prompt=p, max_new=FAMILY_MAX_NEW)
                for i, p in enumerate(prompts)]
        eng = ServingEngine(cfg, model, scfg)
        _, s = timed(lambda: eng.serve(reqs))
        waves = -(-FAMILY_REQUESTS // scfg.max_batch)
        check(all(len(r.out_tokens) == FAMILY_MAX_NEW and r.done
                  for r in reqs), f"{cfg.name}: a request missed its budget")
        check(all(0 <= t < cfg.vocab_size for r in reqs
                  for t in r.out_tokens),
              f"{cfg.name}: a token outside the vocabulary")
        check(0 < eng.chunked_prefills < waves,
              f"{cfg.name}: {eng.chunked_prefills} chunked prefills of "
              f"{waves} waves, not both branches")
        out_tok = sum(len(r.out_tokens) for r in reqs)
        print(f"family: {cfg.name} engine {FAMILY_REQUESTS} requests "
              f"(prompts {min(lens)}..{max(lens)} tokens, {FAMILY_MAX_NEW} "
              f"new each) in {waves} waves, {eng.chunked_prefills} chunked: "
              f"{out_tok} tokens in {s:.3f} s, {out_tok / s:.1f} served "
              f"tokens/s; {card}")

        # decode steps at the engine's batch, from a prefilled wave
        toks = left_padded(prompts[:scfg.max_batch], device)
        s = decode_seconds(model, cfg, toks, scfg.max_len, FAMILY_MAX_NEW,
                           sync)
        print(f"family: {cfg.name} decode {s / FAMILY_MAX_NEW * 1e3:.2f} ms "
              f"a step at B={toks.shape[0]}; {card}")
        del eng
    peak = (f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            if on_card else "not measured")
    print(f"family: {cfg.name} peak max_memory_allocated {peak}; {card}")
    del model
    if on_card:
        torch.cuda.empty_cache()


# --------------------------------------------------------- train phase
def ulp32(x: float) -> float:
    """The spacing of float32 numbers at ``x``."""
    import math
    return 2.0 ** (math.frexp(abs(x))[1] - 24)


def grad_check(model, cfg, tokens, gen, card: str) -> dict:
    """A central difference of ``loss_fn`` along one random unit direction
    ``d`` against autograd's ``<grad, d>``, on ``model``'s parameters
    widened to fp32 (exactly) and a ``GRAD_SHAPE`` batch; beside it, how
    far the bf16 gradient is from the fp32 one.

    The step is ``h = GRAD_STEP |theta|``. The tolerance: each fp32 loss
    is its exact value plus a rounding error of a few ulps (``GRAD_ULPS``),
    so the difference of the two losses over ``2 h`` is off by at most
    ``2 GRAD_ULPS ulp(L) / (2 h)``; ``GRAD_REL`` of ``|<grad, d>|`` more
    covers the fp32 gradient's own rounding and the O(h^2) truncation.
    ``tests/test_torch_train.py::
    test_the_gradient_checks_tolerance_covers_the_fp32_rounding`` holds
    both bounds against an fp64 evaluation of a 2-layer, 512-wide olmo on
    the CPU."""
    import math

    from repro_torch.models import api
    from repro_torch.models.params import tree_map_specs

    def grads(m):
        m.requires_grad_(True)
        try:
            loss = api.loss_fn(m, cfg, {"tokens": tokens})
            return float(loss.detach()), torch.autograd.grad(
                loss, list(m.parameters()), allow_unused=True)
        finally:
            m.requires_grad_(False)

    _, g16 = grads(model)
    wide = type(model)(cfg, tree_map_specs(lambda t: t.float(),
                                           model.tree()))
    loss0, g32 = grads(wide)
    g32 = [torch.zeros_like(p) if g is None else g
           for p, g in zip(wide.parameters(), g32)]
    dot = lambda a, b: sum(float((x.double() * y.double()).sum())  # noqa: E731
                           for x, y in zip(a, b))
    n32 = math.sqrt(dot(g32, g32))
    d16 = [g32i - (torch.zeros_like(g32i) if g is None else g.float())
           for g32i, g in zip(g32, g16)]
    err16 = math.sqrt(dot(d16, d16)) / n32
    del g16, d16
    d = [torch.randn(p.shape, generator=gen, device=p.device)
         for p in wide.parameters()]
    nd = math.sqrt(dot(d, d))
    d = [x / nd for x in d]
    gd = dot(g32, d)
    params = list(wide.parameters())
    h = GRAD_STEP * math.sqrt(dot(params, params))
    del g32
    with torch.no_grad():
        for p, x in zip(params, d):
            p.add_(h * x)
        plus = float(api.loss_fn(wide, cfg, {"tokens": tokens}))
        for p, x in zip(params, d):
            p.sub_(2 * h * x)
        minus = float(api.loss_fn(wide, cfg, {"tokens": tokens}))
    del wide, d, params
    fd = (plus - minus) / (2 * h)
    round_tol = 2 * GRAD_ULPS * ulp32(loss0) / (2 * h)
    tol = round_tol + GRAD_REL * abs(gd)
    check(all(map(math.isfinite, (loss0, plus, minus, gd))) and
          abs(fd - gd) <= tol,
          f"train: the central difference {fd:.6e} and <grad, d> {gd:.6e} "
          f"differ by {abs(fd - gd):.3e}, tolerance {tol:.3e}")
    print(f"train: gradient check on {tuple(tokens.shape)} in fp32: loss "
          f"{loss0:.6f}, |grad| {n32:.6g}; along a random unit direction "
          f"(h = {h:.4g}): central difference {fd:.6e}, <grad, d> "
          f"{gd:.6e}, difference {abs(fd - gd):.3e} within {tol:.3e} "
          f"({2 * GRAD_ULPS} ulp of the loss over 2h = {round_tol:.3e}, "
          f"plus {GRAD_REL} of |<grad, d>|); the bf16 gradient "
          f"{err16:.4g} of |grad| off the fp32 one; {card}")
    return {"fd": fd, "gd": gd, "tol": tol, "bf16_rel": err16}


def train_phase(cfg, corpus_kw: dict, query_kw: dict, device, sync,
                card: str = "no card", seed: int = 0, published: int = 0,
                resume_layers: int = RESUME_LAYERS):
    """Training at ``cfg``'s width and depth (``repro_torch.train``), fed by
    the pushdown pipeline over ``corpus_kw``'s corpus with ``query_kw``:
    every partition's ``fused_scan_shuffle`` launch at this query's ranks
    held bitwise to the plain version; ``make_host_train_step(remat=True)``
    for ``len(TRAIN_ORDER)`` steps over the pipeline's first batches (the
    first one again last, whose loss must have fallen), timed; the fp32
    directional-derivative check (``grad_check``); then at the width with
    the depth cut to ``resume_layers``, ``train`` straight through to
    ``RESUME_STEPS[1]`` and again saved at ``RESUME_STEPS[0]`` and resumed,
    the final losses within ``RESUME_TOL``, and a ``restore`` of the saved
    state equal bit for bit to the resumed run's. Returns the launches of
    the driven runs (the draws and steps, and the three ``train`` runs).
    ``published`` (when not 0) is the parameter count to hold."""
    import math
    import tempfile

    from repro_torch.data.pipeline import (CorpusQuery, PushdownDataPipeline,
                                           synth_corpus)
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.program import program_for
    from repro_torch.models import api
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import TrainConfig, make_host_train_step, train

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    corpus = synth_corpus(**corpus_kw)
    query = CorpusQuery(**query_kw)
    pipe = PushdownDataPipeline(corpus, query, device=device)
    expr, P = query.predicate(), query.dp_ranks
    for part in pipe._parts:
        got = kops.fused_scan_shuffle(part.cols, expr, part.doc_id, P)
        prog = program_for(expr, part.cols)
        want = ref.fused_scan_shuffle(prog, [part.cols[c] for c in
                                             prog.columns], part.doc_id, P)
        check(all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, want)),
              "train: a partition's fused_scan_shuffle differs from the "
              "plain version")
    sync()
    print(f"train: corpus made and on {device}, {len(pipe._parts)} "
          f"fused_scan_shuffle launches at P={P} held bitwise, in "
          f"{time.perf_counter() - t0:.2f} s")

    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = api.init_params(cfg, gen, device)
    opt = opt_lib.init(model)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == api.count_params(cfg) and
          (not published or n_params == published),
          f"train: {n_params} parameters, count_params "
          f"{api.count_params(cfg)}, published {published or 'n/a'}")
    step = make_host_train_step(cfg, opt_lib.AdamWConfig(**TRAIN_OPT),
                                remat=True)
    drive, launches, _ = launch_counting(sync)
    batches, stats, secs = [], [], []

    def run():
        nonlocal model, opt
        batches.extend(next(pipe) for _ in range(max(TRAIN_ORDER) + 1))
        for i in TRAIN_ORDER:
            sync()
            t = time.perf_counter()
            model, opt, st = step(model, opt, batches[i])
            stats.append({k: float(v) for k, v in st.items()})  # syncs
            secs.append(time.perf_counter() - t)
    drive(run)
    shape = tuple(batches[0]["tokens"].shape)
    tok = math.prod(shape)
    losses = [s["loss"] for s in stats]
    check(all(math.isfinite(s[k]) for s in stats for k in s),
          "train: a step's loss, grad_norm or lr is not finite")
    check(losses[-1] < losses[0], f"train: the loss on the repeated first "
          f"batch did not fall ({losses[0]:.6f} -> {losses[-1]:.6f})")
    want = launches["fused_scan_shuffle"] > 0 if on_card else \
        launches["fused_scan_shuffle"] == 0
    check(want and all(n == 0 for k, n in launches.items()
                       if k != "fused_scan_shuffle"),
          f"train: launches {launches}")
    warm = statistics.median(secs[1:])
    peak = (f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            if on_card else "not measured")
    joined = lambda xs, fmt, sep=" / ": sep.join(  # noqa: E731
        format(x, fmt) for x in xs)
    print(f"train: {cfg.name} {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} parameters, batches {shape} "
          f"(accum, mb, S), remat=True, AdamW {TRAIN_OPT}: "
          f"{len(secs)} steps on batches {list(TRAIN_ORDER)}, "
          f"{joined([x * 1e3 for x in secs], '.1f')} ms a step (median "
          f"after the first {warm * 1e3:.1f} ms, {tok / warm:.0f} "
          f"tokens/s); loss {joined(losses, '.6f', ' -> ')}; grad_norm "
          f"{joined([x['grad_norm'] for x in stats], '.4g')}; lr "
          f"{joined([x['lr'] for x in stats], '.3g')}; peak "
          f"max_memory_allocated {peak}; fused_scan_shuffle launches "
          f"{launches['fused_scan_shuffle']}; {card}")

    del opt
    if on_card:
        torch.cuda.empty_cache()
    B, S = GRAD_SHAPE
    grad_check(model, cfg, batches[0]["tokens"][0, :B, :S], gen, card)
    del model, batches
    if on_card:
        torch.cuda.empty_cache()

    # resume exactness at the width with the depth cut
    small = dataclasses.replace(cfg, num_layers=resume_layers)
    ocfg = opt_lib.AdamWConfig(lr=TRAIN_OPT["lr"], warmup_steps=2,
                               total_steps=RESUME_STEPS[1])
    data = lambda: iter(PushdownDataPipeline(  # noqa: E731
        corpus, query, seed=3, device=device))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tc = lambda steps, every, where: TrainConfig(  # noqa: E731
            steps=steps, ckpt_every=every, ckpt_dir=where, keep=1,
            log_every=1, opt=ocfg)
        full = drive(train, small, data(), tc(RESUME_STEPS[1], 100, None),
                     device=device)
        drive(train, small, data(), tc(RESUME_STEPS[0], RESUME_STEPS[0], d),
              device=device)
        resumed = drive(train, small, data(), tc(RESUME_STEPS[1], 100, d),
                        device=device)
        t_runs = time.perf_counter() - t0
        a, b = full["history"][-1]["loss"], resumed["history"][-1]["loss"]
        check(full["final_step"] == resumed["final_step"] == RESUME_STEPS[1]
              and abs(a - b) < RESUME_TOL,
              f"train: resumed loss {b} against straight-through {a}")
        mgr = ckpt.CheckpointManager(d)
        template = api.init_params(small, torch.Generator(
            device=device).manual_seed(seed + 1), device)
        (got_p, got_o), at = mgr.restore((template, opt_lib.init(template)))
        saved = ckpt._flatten((resumed["params"], resumed["opt"]))
        back = ckpt._flatten((got_p, got_o))
        check(at == RESUME_STEPS[1] and list(saved) == list(back) and all(
            saved[k].dtype == back[k].dtype and torch.equal(
                saved[k].reshape(-1).view(torch.uint8),
                back[k].reshape(-1).view(torch.uint8)) for k in saved),
              "train: a restored leaf differs from the saved state")
        files = sum(f.stat().st_size for f in (
            mgr.dir / f"step_{at:08d}").iterdir())
    print(f"train: resume at {cfg.name}'s width with the depth cut "
          f"{cfg.num_layers} -> {resume_layers} layers: straight through to "
          f"step {RESUME_STEPS[1]} loss {a:.6f}, saved at "
          f"{RESUME_STEPS[0]} and resumed {b:.6f} (difference "
          f"{abs(a - b):.3g}, tolerance {RESUME_TOL}); the restored state "
          f"({len(saved)} leaves, {files} bytes on disk) equal bit for bit "
          f"and dtype; three runs in {t_runs:.2f} s; {card}")
    del full, resumed, template, got_p, got_o, saved, back
    return launches


def print_records(recs, names) -> None:
    """One line per kernel record; ``names`` label records that carry no
    ``name`` of their own."""
    for i, rec in enumerate(recs):
        name = rec.get("name") or names[i]
        regime = f" regime={rec['regime']}" if "regime" in rec else ""
        print(f"kernel: {name} [{rec['shape']}] ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}) library_ms={rec['library_ms']} "
              f"max_abs_err={rec['max_abs_err']:.3g}{regime}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.queryproc import tpch
    from repro_torch.storage.catalog import catalog_from_arrays

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
    arrays = tpch.generate_tables(SF, args.seed)
    cat = catalog_from_arrays(arrays, NODES, RPP)
    torch.cuda.synchronize()
    print(f"catalog: sf={SF} seed={args.seed} "
          f"lineitem={sum(len(p.data) for p in cat.partitions_of('lineitem'))} "
          f"rows in "
          f"{len(cat.partitions_of('lineitem'))} partitions, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, built in "
          f"{time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    records, extra = kernel_phase(cat, cuda_ms)
    print(f"kernel phase: {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on the card")
    print_records([*records.values(), *extra], list(records))

    t0 = time.perf_counter()
    interp = {}
    engine = engine_phase(cat, torch.cuda.synchronize, interp)
    print(f"engine phase: {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tensor = tensor_phase(cat, torch.cuda.synchronize, interp, smi[0])
    del interp
    print(f"tensor phase: {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on the card")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    costed = costed_phase(cat, torch.cuda.synchronize)
    print(f"costed phase: {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on the card")

    t0 = time.perf_counter()
    ccat = catalog_from_arrays(arrays, NODES, RPP, cluster=CLUSTER)
    del arrays
    torch.cuda.synchronize()
    print(f"clustered catalog: lineitem by l_orderkey in "
          f"{len(ccat.partitions_of('lineitem'))} partitions, built in "
          f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    comp, having = compiler_phase(cat, ccat, cuda_ms, torch.cuda.synchronize)
    del ccat
    torch.cuda.empty_cache()
    print(f"compiler phase: {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on the card")
    print_records([having], [])

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sec42 = section42_phase(cat, torch.cuda.synchronize)
    print(f"section 4.2 phase: {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on the card")

    t0 = time.perf_counter()
    cached = cache_phase(cat, torch.cuda.synchronize)
    print(f"cache phase: {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    faulted = fault_phase(cat, torch.cuda.synchronize)
    print(f"fault phase: {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on the card")
    t0 = time.perf_counter()
    streamed = stream_phase(cat, torch.cuda.synchronize, smi[0])
    print(f"stream phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    traced = trace_phase(cat, torch.cuda.synchronize, smi[0])
    print(f"trace phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    tiered = tier_phase(cat, torch.cuda.synchronize, smi[0])
    print(f"tier phase: {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    piped, pipe_record, first = pipeline_phase(
        PIPE_CORPUS, PIPE_QUERY, "cuda", cuda_ms, torch.cuda.synchronize,
        smi[0])
    print(f"pipeline phase: {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on the card")
    print_records([pipe_record], [])
    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    serve_phase(get_config(SERVE_ARCH), first, "cuda",
                torch.cuda.synchronize, smi[0], args.seed)
    del first
    print(f"serve phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    trained = train_phase(get_config(TRAIN_ARCH), PIPE_CORPUS, TRAIN_QUERY,
                          "cuda", torch.cuda.synchronize, smi[0], args.seed,
                          TRAIN_PARAMS)
    print(f"train phase: {time.perf_counter() - t0:.2f} s")
    launches = {n: engine[n] + tensor[n] + costed[n] + comp[n] + sec42[n]
                + cached[n] + faulted[n] + streamed[n] + traced[n]
                + tiered[n] + piped[n] + trained[n] for n in records}
    print("kernels: " + "; ".join(
        f"{n} check=ok launches={launches[n]} (engine {engine[n]}, tensor "
        f"{tensor[n]}, costed {costed[n]}, compiler {comp[n]}, section 4.2 "
        f"{sec42[n]}, cache {cached[n]}, faults {faulted[n]}, stream "
        f"{streamed[n]}, trace {traced[n]}, tier {tiered[n]}, pipeline "
        f"{piped[n]}, train {trained[n]})" for n in records))
    for n in records:
        check(launches[n] > 0, f"{n} never launched on the main path")
    check(trained["fused_scan_shuffle"] > 0,
          "fused_scan_shuffle never launched in the train phase")
    # each query's stages calling grouped_agg is checked in tensor_phase
    check(tensor["grouped_agg"] > 0,
          "grouped_agg never launched in the tensor phase's driven runs")
    for n in ("predicate_bitmap", "fused_scan_agg", "grouped_agg"):
        check(tiered[n] > 0, f"{n} never launched on the process tier")
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
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
