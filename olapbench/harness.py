"""One run of one cell: make the tables, hand them to the port, warm up,
drive the measured window, check the answers, print the last line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic in ``mixes/<traffic>.json``, each query's reference in
``queries/<qid>.py`` and each metric's reader in ``metrics/<metric>.py``.

A mix names either one ``order``, which one closed-loop client sends
through ``compile_and_run`` (``drive``), or several ``streams``, which go
in rounds of one query from each stream through ``run_stream``
(``drive_streams``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import inspect
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from olapbench import compare, devtrace, gen, peaks, refops

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
MAX_FAILED = 8       # queries that may raise before the window gives up


@dataclasses.dataclass
class Done:
    """One query the window completed, as the checks and readers need it."""
    qid: str
    latency_s: float
    real_net_bytes: int
    n_requests: int
    pushback: List[Tuple[str, int, int]]   # (table, partition, bytes)
    pushdown: List[Tuple[str, int, int]]   # (table, rows out, bytes)
    result: Dict
    called_ns: int = 0                     # perf_counter at the call


@dataclasses.dataclass
class Run:
    """What a run measured: what every metric reader reads."""
    cell: Dict
    config: Dict
    mix: Dict
    tables: Dict
    setup_s: float
    window_s: float
    done: List[Done]
    attempted: int
    failed: int
    spans: List[Tuple[int, int, str, int, Optional[int]]]  # traced only:
    #                       (start ns, end ns, name, id, parent id)
    device: Optional[devtrace.DeviceTrace] = None
    hbm_bytes_per_s: Optional[float] = None

    @property
    def latencies_s(self) -> List[float]:
        return [d.latency_s for d in self.done]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(name: str, bench: Optional[Dict] = None):
    """(the cell's entry, its configuration, its mix, the benchmark)."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / conf["file"])
    mix = load_json(HERE / "mixes" / f"{cell['traffic']}.json")
    return cell, config, mix, bench


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics this cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(metric: str) -> Callable[[Run], Optional[float]]:
    """``read`` of ``metrics/<metric>.py``, or, where no file has the whole
    name, of ``metrics/<base>.py`` for a name ``<base>.<suffix>``: one
    reader serves a quantity that is split by the cells it moves."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"olapbench.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def queries_of(mix: Dict) -> List[str]:
    """Every query of a mix once: its ``order``, or its ``streams`` in the
    order each query first appears in them, stream by stream."""
    return list(dict.fromkeys(
        q for s in mix.get("streams", [mix.get("order", [])]) for q in s))


def reference_of(qid: str):
    return importlib.import_module(f"olapbench.queries.{qid}").reference


def make_tables(config: Dict, seed: int, device="cpu") -> Dict:
    """The configuration's tables from ``seed``, made and cast to their
    widths on ``device``, as numpy arrays on the host."""
    made = gen.generate_tables(config["generator_sf"], seed, device)
    return gen.to_host(gen.cast_widths(made, config["widths"]))


def make_catalog(tables: Dict, config: Dict, device):
    from repro_torch.storage.catalog import catalog_from_arrays
    if config["objects_per_table"] != 4 * config["storage_nodes"]:
        raise ValueError("catalog_from_arrays stores every table but lineitem "
                         "in 4 objects a storage node")
    return catalog_from_arrays(tables, config["storage_nodes"],
                               config["lineitem_rows_per_partition"], device,
                               cluster=config["cluster"])


def _checked(kw: Dict, allowed, what: str) -> Dict:
    unknown = sorted(set(kw) - set(allowed))
    if unknown:
        raise ValueError(f"{what} has no {', '.join(unknown)}")
    return kw


def engine_config(config: Dict, mix: Dict, device):
    """The ``EngineConfig`` of a cell: the configuration's storage
    resources, and every key of the mix's ``engine`` as a field of the same
    name (one that ``EngineConfig`` lacks is refused)."""
    from repro_torch.core.cost import StorageResources
    from repro_torch.core.engine import EngineConfig
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    kw = _checked(dict(mix["engine"]), fields - {"res", "device"},
                  "EngineConfig")
    return EngineConfig(res=StorageResources(**config["storage_resources"]),
                        device=device, **kw)


def compile_options(mix: Dict) -> Dict:
    """The mix's ``compile`` keys, passed to every ``compile_and_run`` call
    (``cost_based``, ``fact_selectivity``; another key is refused)."""
    from repro_torch.core.engine import compile_and_run
    params = set(inspect.signature(compile_and_run).parameters)
    return _checked(dict(mix.get("compile", {})),
                    params - {"qid", "catalog", "cfg"}, "compile_and_run")


def _owned(v: torch.Tensor) -> torch.Tensor:
    """A result column that does not keep a larger tensor alive."""
    return v.clone() if v.untyped_storage().nbytes() > 4 * v.nbytes + 4096 \
        else v


def _done(qid: str, latency_s: float, real_net_bytes, requests, outcomes,
          cols: Dict, called_ns: int) -> Done:
    """One completed query's record from its requests, their outcomes and
    its result columns."""
    by_id = {r.req_id: r for r in requests}
    pb, pd = [], []
    for o in outcomes:
        if o.replayed:
            pb.append((o.table, by_id[o.req_id].part.index,
                       int(o.shipped_bytes)))
        else:
            pd.append((o.table, int(o.rows_out), int(o.shipped_bytes)))
    return Done(qid, latency_s, int(real_net_bytes), len(requests), pb, pd,
                {k: _owned(v) for k, v in cols.items()}, called_ns)


def drive(order: List[str], start: int, catalog, cfg, seconds: float,
          sync: Callable[[], None], options: Optional[Dict] = None):
    """The closed loop of one client: each query goes when the last one's
    result is on the device and synchronised, in ``order`` from
    ``start``, until ``seconds`` have passed; ``options`` are the mix's
    ``compile`` keys. Returns (window seconds, completed queries,
    attempted, failed)."""
    options = options or {}
    from repro_torch.core.engine import compile_and_run
    done: List[Done] = []
    attempted = failed = 0
    i = start
    t0 = time.perf_counter()
    end = t0 + seconds
    t = t0
    while t < end and failed < MAX_FAILED:
        qid = order[i % len(order)]
        i += 1
        attempted += 1
        a = time.perf_counter()
        try:
            run = compile_and_run(qid, catalog, cfg, **options)
            sync()
        except Exception:  # a query that raises is a failed request
            failed += 1
            traceback.print_exc(file=sys.stderr)
            t = time.perf_counter()
            continue
        t = time.perf_counter()
        done.append(_done(qid, t - a, run.real_net_bytes, run.requests,
                          run.outcomes, run.result.cols, int(a * 1e9)))
        del run
    return t - t0, done, attempted, failed


class StreamTap:
    """What ``run_stream`` builds for each request and does not hand back,
    recorded while the tap is installed: the planned requests (each
    ``engine.plan_requests`` call's list, whose ``query_id`` the stream
    sets to the entry's key) and every ``runtime.RequestOutcome``. Both
    are wrapped, not changed: the program's calls go through as they are,
    and the byte check reads what they made."""

    def __init__(self):
        self.requests: List = []
        self.outcomes: List = []

    def take(self) -> Tuple[List, List]:
        """What was recorded since the last take, and forget it."""
        out = self.requests, self.outcomes
        self.requests, self.outcomes = [], []
        return out

    def __enter__(self):
        from repro_torch.core import engine, runtime
        plan, outcome = engine.plan_requests, runtime.RequestOutcome

        def planned(*a, **k):
            reqs = plan(*a, **k)
            self.requests.extend(reqs)
            return reqs

        def made(*a, **k):
            o = outcome(*a, **k)
            self.outcomes.append(o)   # one append: safe across the pools
            return o
        self._restore = (plan, outcome)
        engine.plan_requests, runtime.RequestOutcome = planned, made
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine, runtime
        engine.plan_requests, runtime.RequestOutcome = self._restore


def run_round(qids: List[str], catalog, cfg, options: Dict):
    """One round: each query compiled as ``compile_and_run`` compiles it
    (the mix's ``compile`` keys), then all of them submitted together, at
    arrival 0, as one ``run_stream`` call."""
    from repro_torch import compiler
    from repro_torch.core.runtime import StreamQuery, run_stream
    fs = options.get("fact_selectivity")
    if options.get("cost_based"):
        queries = [compiler.compile_query_costed(
            q, catalog, res=cfg.res, corrector=cfg.corrector,
            fact_selectivity=fs, compute_bw=cfg.compute_bw).query
            for q in qids]
    else:
        queries = [compiler.compile_query(q, fs) for q in qids]
    return run_stream([StreamQuery(q) for q in queries], catalog, cfg)


def drive_streams(streams: List[List[str]], start: int, catalog, cfg,
                  seconds: float, sync: Callable[[], None],
                  options: Optional[Dict] = None):
    """The closed loop of rounds: round k takes position ``start + k``
    (modulo a stream's length) of every stream and goes when the last
    round's ``run_stream`` has returned and the device is synchronised,
    until ``seconds`` have passed. Every query of a round is timed from
    the round's call to that synchronisation; a query that appears twice
    in a round runs twice (``run_stream`` keys it ``qid#1``). A round
    that raises counts each of its queries as attempted and failed.
    Returns (window seconds, completed queries, attempted, failed)."""
    options = options or {}
    done: List[Done] = []
    attempted = failed = 0
    k = start
    t0 = time.perf_counter()
    end = t0 + seconds
    t = t0
    with StreamTap() as tap:
        while t < end and failed < MAX_FAILED:
            qids = [s[k % len(s)] for s in streams]
            k += 1
            attempted += len(qids)
            tap.take()
            a = time.perf_counter()
            try:
                stream = run_round(qids, catalog, cfg, options)
                sync()
            except Exception:  # a round that raises fails all its queries
                failed += len(qids)
                traceback.print_exc(file=sys.stderr)
                t = time.perf_counter()
                continue
            t = time.perf_counter()
            requests, outcomes = tap.take()
            by_key: Dict[str, List] = {}
            for r in requests:
                by_key.setdefault(r.query_id, []).append(r)
            outcome_of = {o.req_id: o for o in outcomes}
            for key, entry in stream.per_query.items():
                reqs = by_key.get(key, [])
                done.append(_done(
                    key.partition("#")[0], t - a, entry["real_net_bytes"],
                    reqs, [outcome_of[r.req_id] for r in reqs
                           if r.req_id in outcome_of],
                    stream.results[key].cols, int(a * 1e9)))
            del stream
    return t - t0, done, attempted, failed


def references(tables, qids, device, F=torch.float64) -> Dict[str, Dict]:
    """Each query's reference result, on the host, worked out on
    ``device`` in ``F``."""
    T = refops.RefTables(tables, device)
    out = {q: {c: v.cpu().numpy() for c, v in reference_of(q)(T, F).items()}
           for q in qids}
    del T
    return out


def check(run: Run, layout: compare.Layout, device) -> Dict[str, Dict]:
    """Each number compared, beside its limit, over every completed query,
    the reference worked out on ``device``."""
    want = references(run.tables, sorted({d.qid for d in run.done}), device)
    worst, wrong, bad_bytes, why = 0.0, 0, 0, []
    for d in run.done:
        fault, gap = compare.compare_result(d.result, want[d.qid])
        worst = max(worst, gap)
        if fault is not None:
            wrong += 1
            why.append(f"{d.qid}: {fault}")
        fault = compare.bytes_fault(d, run.mix["accessed"][d.qid], layout)
        if fault is not None:
            bad_bytes += 1
            why.append(f"{d.qid} bytes: {fault}")
    for line in sorted(set(why))[:20]:
        print(f"mismatch: {line}", file=sys.stderr)
    got = {"result_rel_err": worst, "result_mismatches": wrong,
           "bytes_mismatches": bad_bytes}
    return {k: {"value": v, "limit": compare.LIMITS[k]}
            for k, v in got.items()}


def is_correct(compared: Dict[str, Dict], failed: int, n_done: int) -> bool:
    return (failed == 0 and n_done > 0
            and all(c["value"] <= c["limit"] for c in compared.values()))


def _spans(tracer) -> List[Tuple[int, int, str, int, Optional[int]]]:
    base = tracer.t0
    return [(int((base + s.t0) * 1e9), int((base + s.t0 + (s.dur or 0)) * 1e9),
             s.name, s.sid, s.parent) for s in tracer.snapshot()]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's, the JAX package's or the old benchmarks'."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             config_override: Optional[Dict] = None,
             bench: Optional[Dict] = None) -> Dict:
    """One run; returns the result line. ``device="cpu"`` and a smaller
    ``config_override`` serve the CPU tests, which skip the look for a
    chip; ``bench`` stands in for ``BENCHMARK.json`` (a cell that it does
    not hold yet)."""
    cell, config, mix, bench = cell_parts(name, bench)
    config = config_override or config
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    from repro_torch.core.engine import compile_and_run
    from repro_torch.obs import trace as obs_trace

    phases = {"imports": time.perf_counter() - t_start}
    tables = make_tables(config, seed, device)
    phases["tables"] = time.perf_counter() - t_start
    catalog = make_catalog(tables, config, device)
    cfg = engine_config(config, mix, device)
    options = compile_options(mix)
    sync()
    phases["catalog"] = time.perf_counter() - t_start
    streams = mix.get("streams")
    order = mix.get("order")
    for _ in range(mix["warmup_passes"]):
        if streams:
            for k in range(len(streams[0])):
                run_round([s[k % len(s)] for s in streams], catalog, cfg,
                          options)
        else:
            for qid in order:
                compile_and_run(qid, catalog, cfg, **options)
        sync()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    phases["warm-up"] = setup_s

    prof = marks = tracer = None
    if trace:
        tracer = obs_trace.Tracer()
        obs_trace.set_tracer(tracer)
        if on_card:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            marks = devtrace.Marks()
            marks.mark()
    if streams:
        window_s, done, attempted, failed = drive_streams(
            streams, seed % len(streams[0]), catalog, cfg, seconds, sync,
            options)
    else:
        window_s, done, attempted, failed = drive(
            order, seed % len(order), catalog, cfg, seconds, sync, options)
    dev_trace = None
    if trace:
        if on_card:
            marks.mark()
            prof.__exit__(None, None, None)
            dev_trace = devtrace.read(prof, marks)
            del prof
        obs_trace.set_tracer(None)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    for d in done:
        d.result = {k: v.cpu().numpy() for k, v in d.result.items()}
    del catalog
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    run = Run(cell, config, mix, tables, setup_s, window_s, done, attempted,
              failed, _spans(tracer) if tracer is not None else [],
              dev_trace, peaks.hbm_bytes_per_s(kind) if on_card else None)
    metrics = {}
    for m in metrics_of(bench, name, trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    phases["window and trace"] = time.perf_counter() - t_start
    compared = check(run, compare.Layout(tables, config, device), device)
    phases["reference"] = time.perf_counter() - t_start
    line = {"correct": is_correct(compared, failed, len(done)),
            "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                       "count": cell["chips"] if on_card else 0,
                       "memory_peak_bytes": int(peak)}}
    if dev_trace is not None:
        busy = devtrace.device_busy_s(devtrace.clip(dev_trace))
        win = (dev_trace.window[1] - dev_trace.window[0]) / 1e9
        line["device"].update(busy_s=busy, window_s=win)
        line["breakdown"] = {
            "device_ops": devtrace.top_ops(dev_trace),
            "idle_gaps": devtrace.idle_gaps(
                dev_trace, [(a, b, n) for a, b, n, _, _ in run.spans])}
    line["compared"] = compared
    print("phases (s since start): " + ", ".join(
        f"{k} {v:.2f}" for k, v in phases.items()), file=sys.stderr)
    for k, c in compared.items():
        print(f"compared {k}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return line
