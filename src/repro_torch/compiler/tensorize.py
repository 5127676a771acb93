"""Tensorized compute residual: the whole residual IR as padded, masked
tensor programs over device tensors.

Port of ``repro.compiler.tensorize``. The residual interpreter
(``compiler/interpreter.py``) runs one operator at a time and shrinks
every intermediate table to its surviving rows. This backend instead
*lowers* a query's residual (Filter / Project / Map / Aggregate / Join /
SemiJoin / TopK / Sort / Shuffle) into one **stage program per segment**
between PyOps, over tables padded to a power-of-two row bucket with a
validity mask: rows stay in place, filters only clear mask bits.

========== ================================================================
IR node    tensor lowering
========== ================================================================
Filter     the predicate closure (``expressions.compile_expr``) ANDed into
           the validity mask
Project    column subset of the masked table (missing columns drop, as in
           the interpreter)
Map        the derives, called directly on the padded tensors (they are
           written against torch; a padded zero row must not raise)
Aggregate  keyed: a mixed-radix key code over the *observed* per-key
           bounds; sums, means and counts from the ``grouped_agg`` kernel
           over ``gid = where(valid, code, D)`` (ids >= D dropped), min
           and max by ``scatter_reduce``; groups compacted by cumsum +
           searchsorted, no sort. A non-integral key or a code domain past
           ``_AGG_DOM_CAP`` takes the lexsort path: stable sorts with an
           invalid-rows-last primary key, segment sums and counts from
           ``grouped_agg`` with one group a row. Keyless: masked
           whole-column reductions
Join       every right side is a named, materialized leaf. An integral key
           over at most ``_LUT_CAP`` values gets a dense key -> row LUT
           built on the device each run (duplicate right keys replay the
           interpreter: the tensor join is many-to-one); the probe is two
           gathers. Otherwise a stable argsort of the right keys (float64,
           +inf for invalid rows) and ``searchsorted``, with an in-program
           duplicate-key flag
SemiJoin   LUT membership on the mask (anti negates), or the sorted probe
TopK       the first k of a stable descending sort of the ±inf-masked
           scores (``lax.top_k``'s order: among equal scores the lower row
           first)
Sort       stable sorts with an invalid-rows-last primary key; descending
           reverses only the valid prefix (the interpreter's reversed
           order on its all-valid rows)
Shuffle    row-preserving no-op (redistribution marker)
PyOp       segmentation boundary: its function runs on the materialized
           root tables between stages
========== ================================================================

Leaf-adjacent {Filter, Project, Map, Shuffle} chains over Merged/Scan
leaves (and over PyOp outputs) are input preparation: the interpreter
evaluates them (one shared memo a run) before the stage program runs, so
the padded domain is as small as the data.

**Observe first.** The first ``execute`` of a residual runs the
interpreter (whose result it returns) and reads its memo: per keyed
Aggregate the per-key bounds of its input, per Join/SemiJoin whether the
right side takes a LUT. The stage programs bake these in; a later run
whose keys leave the observed domain raises the respec flag, which
re-observes (bounds only widen) and rebuilds the programs, at most
``_RESPEC_CAP`` times before the residual stays on the interpreter.

A stage program is a closure of eager torch ops, built once per artifact
generation; the reference's ``jax.jit`` cache key, ``(stage, generation,
inputs, dtypes, buckets, LUT lengths)``, is kept in ``art.seen`` so that
``jit_hits``/``jit_misses`` count what the reference counts. The
reference's numpy-protocol shim for derives has no counterpart: the
port's derives are torch already.

Failures: a lowering guard (``TensorFallback``) replays the interpreter
for the run; any other error disables the tensor path for the residual
and replays the interpreter (``residual.errors``), except a failure of
the device itself (a kernel build or launch error, ``KernelError``; a
CUDA out-of-memory or runtime error), which propagates.

Columns keep their stored dtype from the merged tables to the result.
Torch's CUDA build cannot index, compare, sort or reduce a uint16/32/64
tensor, so the stage programs move such a column with ``table.gather``,
order and reduce it through its ``sort_key`` and compute on it through
``as_int64``/``as_float64``; key ranges come from the ``sort_key`` too.

``core.runtime.run_residual`` dispatches between the two backends
(``EngineConfig.residual``); ``"auto"`` uses a calibrated merged-row
crossover (``calibrate_residual_threshold``), overridable by
``REPRO_RESIDUAL_THRESHOLD`` / ``REPRO_NO_CALIBRATE``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compiler import interpreter, ir
from repro_torch.device import resolve_device
from repro_torch.kernels import grouped_agg as gak
from repro_torch.kernels._launch import KernelError
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_metrics
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc.operators import keyless_sum
from repro_torch.queryproc.table import (ColumnTable, as_float64, as_int64,
                                         from_key, gather, signed_view,
                                         sort_key)

_MIN_BUCKET = 16
_LUT_CAP = 1 << 23       # max dense key-LUT domain
_AGG_DOM_CAP = 1 << 18   # max mixed-radix aggregate code domain
_RESPEC_CAP = 8          # re-specializations before settling on the oracle


class TensorFallback(Exception):
    """Raised when a lowering guard trips. ``respec=True`` marks guards an
    observation refresh can cure (keys left the observed domain);
    ``respec=False`` marks data the lowering cannot express (duplicate
    right join keys: the tensor join is many-to-one). Either way
    ``execute`` replays the interpreter for this run."""

    def __init__(self, msg: str = "", respec: bool = False):
        super().__init__(msg)
        self.respec = respec


class _MT:
    """Masked table of a stage program: padded columns + validity mask."""
    __slots__ = ("cols", "valid")

    def __init__(self, cols, valid):
        self.cols = cols
        self.valid = valid


@dataclasses.dataclass
class _Stage:
    """One segment. ``jit_roots`` are lowered inside its stage program;
    host-resident roots are prepared by the interpreter; ``pyop`` (if any)
    then runs on the materialized root tables and its output enters the
    environment as ``out_name``. ``names`` / ``luts`` (the program's
    inputs) are filled after the observation by ``_build_stage_fns``."""
    index: int
    roots: Tuple[ir.Node, ...]
    jit_roots: Tuple[ir.Node, ...]
    pyop: Optional[ir.PyOp]
    out_name: Optional[str]
    names: List[str] = dataclasses.field(default_factory=list)
    luts: List[Tuple[str, str, str, bool]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class _Artifact:
    """Compile-once product for one residual object. ``obs`` (aggregate
    bounds and join modes) is None until the first execute; the stage
    programs are built from it and rebuilt on each re-specialization
    (``gen`` bumps, ``seen`` clears)."""
    stages: List[_Stage]
    pyop_names: Dict[int, str]       # id(PyOp) -> env key
    leaf_names: Dict[int, str]       # id(host-resident node) -> env key
    prep_nodes: Dict[str, ir.Node]   # env key -> host-resident node
    preds: Dict[int, Callable]       # id(Filter) -> torch predicate closure
    agg_nodes: List[ir.Aggregate]    # keyed aggregates (observation targets)
    jn_nodes: List[ir.Node]          # Join/SemiJoin nodes (mode targets)
    obs: Optional[Dict] = None       # {"agg": {id: spec}, "join": {id: mode}}
    stage_fns: List[Optional[Callable]] = dataclasses.field(
        default_factory=list)
    seen: set = dataclasses.field(default_factory=set)  # program-cache keys
    gen: int = 0
    respecs: int = 0
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    disabled: bool = False           # lowering failed / respec cap: oracle


@dataclasses.dataclass
class TensorRun:
    """One ``execute`` call's result + program-cache accounting."""
    table: ColumnTable
    jit_hits: int = 0
    jit_misses: int = 0
    fell_back: bool = False
    observed: bool = False
    n_stages: int = 0


# ------------------------------------------------------------ compilation
def _postorder_pyops(node: ir.Node) -> List[ir.PyOp]:
    out: List[ir.PyOp] = []
    seen: set = set()

    def rec(n: ir.Node) -> None:
        if id(n) in seen:
            return
        seen.add(id(n))
        for c in n.inputs():
            rec(c)
        if isinstance(n, ir.PyOp):
            out.append(n)

    rec(node)
    return out


def _host_res(n: ir.Node, memo: Dict[int, bool]) -> bool:
    """Host-resident: materialized outside the stage program — a leaf
    table, an executed PyOp output, or a {Filter,Project,Map,Shuffle}
    chain over one. These become prep units / LUT sources."""
    r = memo.get(id(n))
    if r is None:
        if isinstance(n, (ir.Merged, ir.Scan, ir.PyOp)):
            r = True
        elif isinstance(n, (ir.Filter, ir.Project, ir.Map, ir.Shuffle)):
            r = _host_res(n.child, memo)
        else:
            r = False
        memo[id(n)] = r
    return r


def _assign_leaves(residual: ir.Node, pyops: List[ir.PyOp],
                   pyop_names: Dict[int, str], hmemo: Dict[int, bool]
                   ) -> Tuple[Dict[int, str], Dict[str, ir.Node]]:
    """Name every maximal host-resident subtree the stage programs read:
    bare leaves keep their table name, prep chains get ``__prep{n}``,
    PyOp outputs their stage name. Traversal stops at a named subtree
    except to find embedded PyOps, whose children are earlier stages'
    roots."""
    leaf_names: Dict[int, str] = {}
    prep_nodes: Dict[str, ir.Node] = {}
    seen: set = set()
    ctr = 0

    def name_leaf(n: ir.Node) -> None:
        nonlocal ctr
        if id(n) in leaf_names:
            return
        if isinstance(n, (ir.Merged, ir.Scan)):
            nm = n.table
        elif isinstance(n, ir.PyOp):
            nm = pyop_names[id(n)]
        else:
            nm = f"__prep{ctr}"
            ctr += 1
        leaf_names[id(n)] = nm
        if not isinstance(n, ir.PyOp):
            prep_nodes[nm] = n

    def visit_pyops_under(n: ir.Node) -> None:
        for d in ir.walk(n):
            if isinstance(d, ir.PyOp):
                for c in d.children:
                    visit(c)

    def visit(n: ir.Node) -> None:
        if id(n) in seen:
            return
        seen.add(id(n))
        if _host_res(n, hmemo):
            name_leaf(n)
            visit_pyops_under(n)
            return
        if isinstance(n, (ir.Join, ir.SemiJoin)):
            # build side: always materialized (a LUT source, or a padded
            # leaf input of the sorted probe)
            visit(n.left)
            name_leaf(n.right)
            visit_pyops_under(n.right)
            return
        for c in n.inputs():
            visit(c)

    visit(residual)
    for p in pyops:
        for c in p.children:
            visit(c)
    return leaf_names, prep_nodes


def compile_residual(residual: ir.Node) -> _Artifact:
    """Partition the residual into maximal segments around its PyOps, name
    the host-resident leaves and compile the Filter predicates. The stage
    programs are built after the first observation (``_build_stage_fns``)
    because the aggregate and join lowerings specialize on observed key
    domains."""
    pyops = _postorder_pyops(residual)
    pyop_names = {id(p): f"__pyop{i}" for i, p in enumerate(pyops)}
    hmemo: Dict[int, bool] = {}
    leaf_names, prep_nodes = _assign_leaves(residual, pyops, pyop_names,
                                            hmemo)
    stages: List[_Stage] = []
    for p in pyops:
        roots = tuple(p.children)
        stages.append(_Stage(
            index=len(stages), roots=roots,
            jit_roots=tuple(r for r in roots if not _host_res(r, hmemo)),
            pyop=p, out_name=pyop_names[id(p)]))
    roots = (residual,)
    stages.append(_Stage(
        index=len(stages), roots=roots,
        jit_roots=tuple(r for r in roots if not _host_res(r, hmemo)),
        pyop=None, out_name=None))
    preds = {id(n): ex.compile_expr(n.predicate)
             for n in ir.walk(residual) if isinstance(n, ir.Filter)}
    agg_nodes = [n for n in ir.walk(residual)
                 if isinstance(n, ir.Aggregate) and n.keys]
    jn_nodes = [n for n in ir.walk(residual)
                if isinstance(n, (ir.Join, ir.SemiJoin))]
    return _Artifact(stages=stages, pyop_names=pyop_names,
                     leaf_names=leaf_names, prep_nodes=prep_nodes,
                     preds=preds, agg_nodes=agg_nodes, jn_nodes=jn_nodes)


# ------------------------------------------------------------ observation
def _integral(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


def _key_range(c: torch.Tensor) -> Tuple[int, int]:
    """(min, max) of a bool or integer column's values as Python ints
    (a uint64 one up to 2**64 - 1), reduced over its ``sort_key``."""
    lo, hi = (int(v) for v in torch.aminmax(sort_key(c)))
    shift = 2 ** 63 if c.dtype == torch.uint64 else 0
    return lo + shift, hi + shift


def _as_i64(c: torch.Tensor) -> torch.Tensor:
    """The reference's ``astype(int64)`` of a bool or integer column: a
    uint64 value from 2**63 on wraps, as there."""
    return c.view(torch.int64) if c.dtype == torch.uint64 else as_int64(c)


def _check_i64(lo: int, what: str) -> None:
    """A key domain from 2**63 on has no int64 offsets: the reference's
    codes and LUTs overflow there (an error, which replays the
    interpreter and keeps the residual on it), and so do these."""
    if lo >= 2 ** 63:
        raise OverflowError(f"{what} starts at {lo}, past int64")


def _observe(art: _Artifact, memo: Dict[int, ColumnTable]) -> None:
    """Specialize from the interpreter's memo: per keyed Aggregate, the
    per-key (min, dim) bounds of its input (unioned with earlier
    generations, so re-specialization only widens); per Join/SemiJoin,
    whether the right side takes a dense LUT."""
    prev = art.obs or {"agg": {}, "join": {}}
    agg: Dict[int, Tuple] = dict(prev["agg"])
    join: Dict[int, Tuple] = {}
    for node in art.agg_nodes:
        spec = agg.get(id(node))
        if spec is not None and spec[0] == "lex":
            continue  # non-integral keys are sticky: stay on the sort path
        ct = memo.get(id(node.child))
        if ct is None:
            if spec is None:
                agg[id(node)] = ("code", (0,) * len(node.keys),
                                 (1,) * len(node.keys))
            continue
        cols = [ct.cols.get(k) for k in node.keys]
        if any(c is None or not _integral(c) for c in cols):
            agg[id(node)] = ("lex",)
            continue
        if len(ct) == 0:
            mins = [0] * len(cols)
            maxs = [0] * len(cols)
        else:
            mins, maxs = (list(b) for b in zip(*map(_key_range, cols)))
        if spec is not None:
            mins = [min(a, b) for a, b in zip(mins, spec[1])]
            maxs = [max(mx, om + od - 1)
                    for mx, om, od in zip(maxs, spec[1], spec[2])]
        dims = [mx - mn + 1 for mn, mx in zip(mins, maxs)]
        dom = 1
        for d in dims:
            dom *= d
        agg[id(node)] = (("code", tuple(mins), tuple(dims))
                         if dom <= _AGG_DOM_CAP else ("lex",))
    for j, node in enumerate(art.jn_nodes):
        mode: Tuple = ("sorted",)
        rname = art.leaf_names.get(id(node.right))
        rt = memo.get(id(node.right))
        if rname is not None and rt is not None and node.rkey in rt.cols:
            rk = rt.cols[node.rkey]
            if _integral(rk):
                lo, hi = _key_range(rk) if len(rk) else (0, 0)
                dom = hi - lo + 1
                if dom <= _LUT_CAP:
                    mode = ("lut", f"__lut{j}", rname)
        join[id(node)] = mode
    art.obs = {"agg": agg, "join": join}


def _stage_io(art: _Artifact, st: _Stage
              ) -> Tuple[List[str], List[Tuple[str, str, str, bool]]]:
    """A stage program's inputs: the host-resident leaf names its lowering
    reads, plus the LUT specs (name, right leaf, right key, is_join) to
    build each run. Mirrors ``_lower_node``'s recursion: LUT semi-joins
    never read the right table, LUT joins only for the gathers."""
    names: List[str] = []
    luts: List[Tuple[str, str, str, bool]] = []
    seen: set = set()

    def add(nm: str) -> None:
        if nm not in names:
            names.append(nm)

    def rec(n: ir.Node) -> None:
        if id(n) in seen:
            return
        seen.add(id(n))
        nm = art.leaf_names.get(id(n))
        if nm is not None:
            add(nm)
            return
        if isinstance(n, (ir.Join, ir.SemiJoin)):
            mode = art.obs["join"][id(n)]
            if mode[0] == "lut":
                rec(n.left)
                _, jname, rname = mode
                luts.append((jname, rname, n.rkey, isinstance(n, ir.Join)))
                if isinstance(n, ir.Join):
                    add(rname)
                return
        for c in n.inputs():
            rec(c)

    for r in st.jit_roots:
        rec(r)
    return names, luts


def _build_stage_fns(art: _Artifact) -> None:
    """One stage program per stage that has roots to lower (the
    reference's ``jax.jit`` per stage), and a cleared program cache."""
    fns: List[Optional[Callable]] = []
    for st in art.stages:
        st.names, st.luts = _stage_io(art, st)
        fns.append(_make_stage_fn(st, art) if st.jit_roots else None)
    art.stage_fns = fns
    art.seen = set()


def _make_stage_fn(stage: _Stage, art: _Artifact) -> Callable:
    def stage_fn(inputs):
        ctx: Dict = {"memo": {}, "flags": [], "respec": [],
                     "inputs": inputs, "art": art}
        outs = []
        for root in stage.jit_roots:
            mt = _lower(root, ctx)
            outs.append({"cols": dict(mt.cols), "valid": mt.valid})
        return {"outs": outs, "fallback": _any(ctx["flags"]),
                "respec": _any(ctx["respec"])}

    return stage_fn


def _any(flags: List[torch.Tensor]):
    """OR of 0-d bool tensors (False when there are none)."""
    out = False
    for f in flags:
        out = out | f
    return out


# --------------------------------------------------------------- lowering
def _lower(node: ir.Node, ctx: Dict) -> _MT:
    memo = ctx["memo"]
    if id(node) in memo:
        return memo[id(node)]
    out = _lower_node(node, ctx)
    memo[id(node)] = out
    return out


def _leaf(name: str, ctx: Dict) -> _MT:
    leaf = ctx["inputs"][name]
    return _MT(dict(leaf["cols"]), leaf["valid"])


def _lower_node(node: ir.Node, ctx: Dict) -> _MT:
    nm = ctx["art"].leaf_names.get(id(node))
    if nm is not None:  # host-resident: prep chain / leaf / PyOp output
        return _leaf(nm, ctx)
    if isinstance(node, ir.Shuffle):  # redistribution marker: row-preserving
        return _lower(node.child, ctx)

    if isinstance(node, ir.Filter):
        t = _lower(node.child, ctx)
        mask = ctx["art"].preds[id(node)](t.cols)
        return _MT(t.cols, t.valid & mask)

    if isinstance(node, ir.Project):
        t = _lower(node.child, ctx)
        return _MT({c: t.cols[c] for c in node.columns if c in t.cols},
                   t.valid)

    if isinstance(node, ir.Map):
        t = _lower(node.child, ctx)
        cols = dict(t.cols)
        for name, incols, fn in node.derives:
            cols[name] = torch.as_tensor(fn(*[cols[c] for c in incols]),
                                         device=t.valid.device)
        return _MT(cols, t.valid)

    if isinstance(node, ir.Aggregate):
        return _lower_aggregate(node, _lower(node.child, ctx), ctx)
    if isinstance(node, ir.Join):
        return _lower_join(node, ctx)
    if isinstance(node, ir.SemiJoin):
        return _lower_semijoin(node, ctx)
    if isinstance(node, ir.TopK):
        return _lower_topk(node, _lower(node.child, ctx))
    if isinstance(node, ir.Sort):
        return _lower_sort(node, _lower(node.child, ctx))
    raise TypeError(f"unknown IR node: {node!r}")


def _minmax_sentinel(dtype: torch.dtype, want_max: bool):
    """The extreme of ``dtype`` a reduction starts from: the identity of
    max (``want_max``) or of min, in ``_order_key``'s space."""
    if dtype.is_floating_point:
        return float("inf") if want_max else float("-inf")
    if dtype == torch.bool:
        return int(want_max)
    info = torch.iinfo(dtype)
    return _key_of(info.max if want_max else info.min, dtype)


def _key_of(value: int, dtype: torch.dtype) -> int:
    """``sort_key`` of one bool or integer value of ``dtype``."""
    return value - 2 ** 63 if dtype == torch.uint64 else value


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """What the stage programs sort, compare and reduce for ``v``: a float
    column itself, any other its int64 ``sort_key`` (the same order and
    equalities; torch reduces int64 on every device)."""
    return v if v.is_floating_point() else sort_key(v)


def _from_order_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return k if dtype.is_floating_point else from_key(k, dtype)


def _zeroed(v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``v`` with its invalid rows' bits zeroed, in ``v``'s dtype."""
    s = signed_view(v)
    return torch.where(valid, s, s.new_zeros(())).view(v.dtype)


def _segment_minmax(vals: torch.Tensor, gid: torch.Tensor, n_seg: int,
                    fn: str) -> torch.Tensor:
    """Per-segment min or max of ``vals`` over ``gid`` in [0, n_seg), in
    ``vals``' dtype; a segment no row reaches holds the reduction's
    identity, as ``jax.ops.segment_min``/``segment_max`` leave it."""
    k = _order_key(vals)
    ident = _minmax_sentinel(vals.dtype, want_max=(fn == "min"))
    out = torch.full((n_seg,), ident, dtype=k.dtype, device=k.device)
    out.scatter_reduce_(0, gid, k, "amin" if fn == "min" else "amax")
    return _from_order_key(out, vals.dtype)


def _grouped_sums(node: ir.Aggregate, values: Callable, gid: torch.Tensor,
                  G: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``grouped_agg`` over ``gid`` (int32; ids >= G dropped) for each sum
    and mean of the node, whose value column ``values(col)`` gives at its
    stored dtype (the kernel adds in f64): ({name: sums (G,) f64}, counts
    (G,) int64)."""
    sums: Dict[str, torch.Tensor] = {}
    cnt = None
    for name, fn, col in node.aggs:
        if fn in ("sum", "mean"):
            sums[name], cnt = gak.grouped_agg(gid, values(col).contiguous(),
                                              G)
    if cnt is None:
        _, cnt = gak.grouped_agg(gid, None, G)
    return sums, cnt


def _lower_aggregate(node: ir.Aggregate, t: _MT, ctx: Dict) -> _MT:
    if not node.keys:
        return _agg_keyless(node, t)
    spec = ctx["art"].obs["agg"][id(node)]
    if spec[0] == "code":
        return _agg_code(node, t, spec, ctx)
    return _agg_lex(node, t)


def _agg_keyless(node: ir.Aggregate, t: _MT) -> _MT:
    # keyless: one output row; the all-invalid (empty-input) case selects
    # 0, matching the interpreter's empty-table row
    n_valid = t.valid.sum()
    out = {}
    for name, fn, col in node.aggs:
        arr = t.cols[col] if col else next(iter(t.cols.values()))
        if fn == "count":
            v = n_valid.to(torch.int64)
        elif fn == "sum":
            v = keyless_sum(_zeroed(arr, t.valid))
        elif fn == "mean":
            s = as_float64(_zeroed(arr, t.valid)).sum()
            v = torch.where(n_valid > 0, s / n_valid.clamp(min=1), 0.0)
        else:
            sent = _minmax_sentinel(arr.dtype, want_max=(fn == "min"))
            red = torch.amin if fn == "min" else torch.amax
            k = red(torch.where(t.valid, _order_key(arr), sent))
            zero = 0.0 if arr.is_floating_point() else _key_of(0, arr.dtype)
            v = _from_order_key(torch.where(n_valid > 0, k, zero), arr.dtype)
        out[name] = v.reshape(1)
    return _MT(out, torch.ones(1, dtype=torch.bool, device=t.valid.device))


def _agg_code(node: ir.Aggregate, t: _MT, spec: Tuple, ctx: Dict) -> _MT:
    """Sort-free grouped aggregation: each row's keys encode into one
    mixed-radix code over the observed per-key bounds (ascending code
    order is the ascending lexicographic key order the interpreter
    gives), the sums and counts come from ``grouped_agg`` over the codes,
    and the groups compact by a cumsum + searchsorted over the code
    domain. Rows whose keys left the observed domain raise the respec
    flag; invalid rows take id ``D``, which the kernel drops."""
    _, mins, dims = spec
    D = 1
    for d in dims:
        D *= d
    strides = []
    s = 1
    for d in reversed(dims):
        strides.append(s)
        s *= d
    strides = list(reversed(strides))

    valid = t.valid
    dev = valid.device
    oob = torch.zeros_like(valid)
    code = torch.zeros(valid.shape, dtype=torch.int64, device=dev)
    key_dtypes = []
    for k, mn, d, stp in zip(node.keys, mins, dims, strides):
        col = t.cols[k]
        key_dtypes.append(col.dtype)
        _check_i64(mn, f"aggregate key {k}")
        off = _as_i64(col) - mn
        oob = oob | (off < 0) | (off >= d)
        code = code + off.clamp(0, d - 1) * stp
    ctx["respec"].append((valid & oob).any())

    gid = torch.where(valid, code, D).to(torch.int32)
    sums, cnt = _grouped_sums(node, lambda c: t.cols[c], gid, D)
    present = cnt > 0
    n_groups = present.sum()
    ranks = torch.cumsum(present.to(torch.int64), 0)
    oc = torch.searchsorted(
        ranks, torch.arange(1, D + 1, device=dev)).clamp(0, D - 1)
    out = {}
    for k, mn, d, stp, dt in zip(node.keys, mins, dims, strides, key_dtypes):
        out[k] = (mn + (oc // stp) % d).to(dt)
    for name, fn, col in node.aggs:
        if fn == "count":
            out[name] = cnt[oc]
        elif fn == "sum":
            out[name] = sums[name][oc]
        elif fn == "mean":
            out[name] = (sums[name] / cnt.clamp(min=1))[oc]
        else:  # invalid rows reduce into segment D, which is dropped
            red = _segment_minmax(t.cols[col], gid.to(torch.int64), D + 1,
                                  fn)
            out[name] = gather(red[:D], oc)
    return _MT(out, torch.arange(D, device=dev) < n_groups)


def _lexsort(keys: List[torch.Tensor], primary: torch.Tensor
             ) -> torch.Tensor:
    """``np.lexsort(tuple(reversed(keys)) + (primary,))``: the order by
    ``primary``, then ``keys[0]``, ``keys[1]``, ...; one stable sort of
    each ``_order_key``, least significant first."""
    order = torch.arange(primary.shape[0], device=primary.device)
    for k in [*reversed(keys), primary]:
        order = order[torch.sort(_order_key(k)[order], stable=True).indices]
    return order


def _agg_lex(node: ir.Aggregate, t: _MT) -> _MT:
    """Grouped aggregation for non-integral or huge-domain keys: a
    lexsort of the keys, group-boundary flags, then segment sums and
    counts from ``grouped_agg`` with one group a row (invalid rows take id
    ``n``, which the kernel drops) and segment min/max and group starts by
    ``scatter_reduce``."""
    n = t.valid.shape[0]
    dev = t.valid.device
    key_arrs = [_order_key(t.cols[k]) for k in node.keys]
    # primary sort key pushes invalid rows last; groups are contiguous runs
    # of equal keys among the valid prefix (lexicographic ascending: the
    # interpreter's group order)
    order = _lexsort(key_arrs, (~t.valid).to(torch.int32))
    vs = t.valid[order]
    ks = [a[order] for a in key_arrs]
    changed = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        same = torch.ones(n - 1, dtype=torch.bool, device=dev)
        for a in ks:
            same = same & (a[1:] == a[:-1])
        changed[1:] = ~same
    new_group = vs & changed
    n_groups = new_group.sum()
    gid = torch.where(vs, torch.cumsum(new_group.to(torch.int64), 0) - 1, n)
    rows = torch.arange(n, device=dev)
    starts = _segment_minmax(rows, gid, n + 1, "min")[:n].clamp(0, n - 1)
    out = {k: _from_order_key(a[starts], t.cols[k].dtype)
           for k, a in zip(node.keys, ks)}
    sums, cnt = _grouped_sums(node, lambda c: gather(t.cols[c], order),
                              gid.to(torch.int32), n)
    for name, fn, col in node.aggs:
        if fn == "count":
            out[name] = cnt
        elif fn == "sum":
            out[name] = sums[name]
        elif fn == "mean":
            out[name] = sums[name] / cnt.clamp(min=1)
        else:
            out[name] = _segment_minmax(gather(t.cols[col], order), gid,
                                        n + 1, fn)[:n]
    return _MT(out, rows < n_groups)


def _lut_probe(l: _MT, lkey: str, jname: str, ctx: Dict):
    """Probe a dense key LUT built for this run: two gathers and a few
    compares — the whole join, as far as the stage program goes."""
    li = ctx["inputs"][jname]
    lut, kmin = li["lut"], li["kmin"]
    size = lut.shape[0]
    off = _as_i64(l.cols[lkey]) - kmin
    inb = (off >= 0) & (off < size)
    ridx = lut[off.clamp(0, size - 1)]
    return l.valid & inb & (ridx >= 0), ridx


def _sorted_lookup(l: _MT, r: _MT, lkey: str, rkey: str):
    """Join/semi-join probe for non-LUT rights: a stable sort of the valid
    right keys (invalid -> +inf keeps the array sorted), then
    ``searchsorted`` of the left keys."""
    n = r.valid.shape[0]
    rk = torch.where(r.valid, as_float64(r.cols[rkey]), float("inf"))
    rs, order = torch.sort(rk, stable=True)
    lk = as_float64(l.cols[lkey])
    lo = torch.searchsorted(rs, lk).clamp(0, n - 1)
    found = l.valid & (rs[lo] == lk)
    return order, rs, lo, found


def _lower_join(node: ir.Join, ctx: Dict) -> _MT:
    l = _lower(node.left, ctx)
    mode = ctx["art"].obs["join"][id(node)]
    if mode[0] == "lut":
        _, jname, rname = mode
        found, ridx = _lut_probe(l, node.lkey, jname, ctx)
        r = ctx["inputs"][rname]
        safe = ridx.clamp(min=0)
        cols = dict(l.cols)
        for k, v in r["cols"].items():
            if k != node.rkey or node.lkey != node.rkey:
                cols[k if k not in cols else f"r_{k}"] = gather(v, safe)
        return _MT(cols, found)
    r = _lower(node.right, ctx)
    order, rs, lo, found = _sorted_lookup(l, r, node.lkey, node.rkey)
    ridx = order[lo]
    cols = dict(l.cols)
    for k, v in r.cols.items():
        if k != node.rkey or node.lkey != node.rkey:
            cols[k if k not in cols else f"r_{k}"] = gather(v, ridx)
    # m:1 guard: adjacent equal valid (finite) sorted keys mean a left row
    # could match several right rows — the host replays the oracle
    if rs.shape[0] > 1:
        ctx["flags"].append(
            ((rs[1:] == rs[:-1]) & torch.isfinite(rs[:-1])).any())
    return _MT(cols, found)


def _lower_semijoin(node: ir.SemiJoin, ctx: Dict) -> _MT:
    l = _lower(node.left, ctx)
    mode = ctx["art"].obs["join"][id(node)]
    if mode[0] == "lut":
        found, _ = _lut_probe(l, node.lkey, mode[1], ctx)
    else:
        r = _lower(node.right, ctx)
        _, _, _, found = _sorted_lookup(l, r, node.lkey, node.rkey)
    mask = l.valid & ~found if node.anti else found
    return _MT(l.cols, mask)


def _lower_topk(node: ir.TopK, t: _MT) -> _MT:
    n = t.valid.shape[0]
    k = min(node.k, n)
    v = as_float64(t.cols[node.col])
    scores = torch.where(t.valid, -v if node.ascending else v, float("-inf"))
    # stable: among equal scores the lower row first, as lax.top_k
    idx = torch.sort(scores, descending=True, stable=True).indices[:k]
    return _MT({c: gather(a, idx) for c, a in t.cols.items()},
               torch.arange(k, device=idx.device) < t.valid.sum().clamp(
                   max=k))


def _lower_sort(node: ir.Sort, t: _MT) -> _MT:
    n = t.valid.shape[0]
    order = _lexsort([t.cols[c] for c in node.columns],
                     (~t.valid).to(torch.int32))
    n_valid = t.valid.sum()
    i = torch.arange(n, device=order.device)
    if not node.ascending:
        # reverse only the valid prefix: the interpreter's reversed order
        # on its (all-valid) rows, ties included
        order = order[torch.where(i < n_valid, n_valid - 1 - i, i)]
    return _MT({c: gather(a, order) for c, a in t.cols.items()}, i < n_valid)


# ------------------------------------------------------------- LUT build
def _build_lut(rt: ColumnTable, rkey: str, is_join: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense key -> right-row-index LUT over the right side's key domain
    (-1 = absent), scattered on the device. The length is pow2-bucketed
    so re-runs at similar domains share a program; ``kmin`` rides along
    as a 0-d input."""
    rk = rt.cols[rkey]
    if not _integral(rk):
        raise TensorFallback("non-integral LUT join key")
    n, dev = len(rk), rk.device
    if n == 0:
        return (torch.full((_MIN_BUCKET,), -1, dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    kmin, kmax = _key_range(rk)
    dom = kmax - kmin + 1
    if dom > _LUT_CAP:
        raise TensorFallback("LUT key domain left the observed cap",
                             respec=True)
    _check_i64(kmin, f"LUT key {rkey}")
    lut = torch.full((_bucket(dom),), -1, dtype=torch.int64, device=dev)
    lut.index_put_((_as_i64(rk) - kmin,),
                   torch.arange(n, dtype=torch.int64, device=dev))
    if is_join and int((lut >= 0).sum()) != n:
        raise TensorFallback("duplicate right join keys (m:n)")
    return lut, torch.tensor(kmin, dtype=torch.int64, device=dev)


# ------------------------------------------------------- artifact caching
_ART_CACHE: "OrderedDict[int, Tuple[ir.Node, _Artifact]]" = OrderedDict()
_ART_CACHE_CAP = 128
_ART_LOCK = threading.Lock()


def _artifact(residual: ir.Node) -> _Artifact:
    """Compile-once LRU keyed by residual identity (the node is retained,
    so its id cannot be reused while cached), as the interpreter's
    ``_PRED_CACHE``."""
    with _ART_LOCK:
        hit = _ART_CACHE.get(id(residual))
        if hit is not None and hit[0] is residual:
            _ART_CACHE.move_to_end(id(residual))
            return hit[1]
        tr = obs_trace.get_tracer()
        with tr.span("residual_compile", cat="compiler",
                     shape=ir.describe(residual)) as sp:
            t0 = time.perf_counter()
            art = compile_residual(residual)
            get_metrics().counter("residual.compiles").inc()
            if tr.enabled:
                sp.set(n_stages=len(art.stages),
                       compile_ms=round(1e3 * (time.perf_counter() - t0), 3))
        _ART_CACHE[id(residual)] = (residual, art)
        while len(_ART_CACHE) > _ART_CACHE_CAP:
            _ART_CACHE.popitem(last=False)
        return art


# -------------------------------------------------------------- execution
def _bucket(rows: int) -> int:
    b = _MIN_BUCKET
    while b < rows:
        b <<= 1
    return b


def _pad_table(tab: ColumnTable, device) -> Tuple[Dict, Tuple]:
    """The table padded with zero rows to its bucket, on its own device
    (``device`` for a table without columns), each column in its dtype,
    with its validity mask and its program-cache signature."""
    rows = len(tab)
    b = _bucket(rows)
    dev = tab.device if tab.cols else torch.device(device)
    cols = {}
    for c, a in tab.cols.items():
        cols[c] = a if b == rows else torch.cat(
            [a, signed_view(a).new_zeros(b - rows).view(a.dtype)])
    valid = torch.arange(b, device=dev) < rows
    sig = (b,) + tuple(sorted((c, str(a.dtype)) for c, a in tab.cols.items()))
    return {"cols": cols, "valid": valid}, sig


def _unpad(out: Dict) -> ColumnTable:
    mask = out["valid"]
    return ColumnTable({c: gather(a, mask) for c, a in out["cols"].items()})


def device_of(merged: Dict[str, ColumnTable]) -> torch.device:
    """The merged tables' device (the CPU when no table has a column)."""
    for t in merged.values():
        if t.cols:
            return t.device
    return torch.device("cpu")


def _device_failure(e: BaseException) -> bool:
    """A failure of the device rather than of a lowering: a kernel's build
    or launch error, or a CUDA out-of-memory or runtime error. These
    propagate out of ``execute`` instead of replaying the interpreter."""
    if isinstance(e, (KernelError, torch.cuda.OutOfMemoryError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


def _observe_run(art: _Artifact, residual: ir.Node,
                 merged: Dict[str, ColumnTable]) -> TensorRun:
    """First execute of a residual: run the interpreter, record aggregate
    key bounds and join LUT feasibility from its memo, and build the
    specialized stage programs. The interpreter's table is this run's
    result."""
    tr = obs_trace.get_tracer()
    with tr.span("residual_observe", cat="compiler") as sp:
        t0 = time.perf_counter()
        memo: Dict[int, ColumnTable] = {}
        result = interpreter._run(residual, merged, memo)
        _observe(art, memo)
        _build_stage_fns(art)
        if tr.enabled:
            sp.set(n_stages=len(art.stages),
                   ms=round(1e3 * (time.perf_counter() - t0), 3))
    m = get_metrics()
    m.counter("residual.observes").inc()
    m.counter("residual.tensor.runs").inc()
    return TensorRun(table=result, observed=True, n_stages=len(art.stages))


def _respecialize(art: _Artifact, residual: ir.Node,
                  merged: Dict[str, ColumnTable]) -> ColumnTable:
    """A domain guard tripped: re-observe on the offending input (bounds
    union, so specialization only widens), rebuild the stage programs,
    bump the generation. Capped: a residual whose key domains never
    settle stays on the interpreter."""
    with art.lock:
        art.respecs += 1
        if art.respecs > _RESPEC_CAP:
            art.disabled = True
            return interpreter.run(residual, merged)
        memo: Dict[int, ColumnTable] = {}
        result = interpreter._run(residual, merged, memo)
        _observe(art, memo)
        _build_stage_fns(art)
        art.gen += 1
        get_metrics().counter("residual.respecs").inc()
        return result


def execute(residual: ir.Node, merged: Dict[str, ColumnTable]) -> TensorRun:
    """Run a residual through the tensor backend. Results equal
    ``interpreter.run``'s (the oracle); on a lowering-guard trip the
    oracle is replayed and ``fell_back`` is set."""
    art = _artifact(residual)
    tr = obs_trace.get_tracer()
    m = get_metrics()
    if art.disabled:
        m.counter("residual.fallbacks").inc()
        return TensorRun(table=interpreter.run(residual, merged),
                         fell_back=True, n_stages=len(art.stages))
    if art.obs is None:
        with art.lock:
            if art.obs is None:
                return _observe_run(art, residual, merged)

    dev = device_of(merged)
    hits = misses = 0
    env: Dict[str, ColumnTable] = {}        # PyOp stage outputs
    imemo: Dict[int, ColumnTable] = {}      # shared host-prep memo
    host_tabs: Dict[str, ColumnTable] = {}
    result: Optional[ColumnTable] = None
    fell_back = False

    def host_tab(name: str) -> ColumnTable:
        t = env.get(name)
        if t is not None:
            return t
        t = host_tabs.get(name)
        if t is None:
            t = interpreter._run(art.prep_nodes[name], merged, imemo)
            host_tabs[name] = t
        return t

    try:
        for st in art.stages:
            out_tabs: Dict[int, ColumnTable] = {}
            if st.jit_roots:
                inputs: Dict = {}
                key: Tuple = (st.index, art.gen)
                for name in st.names:
                    inputs[name], sig = _pad_table(host_tab(name), dev)
                    key += (name,) + sig
                for jname, rname, rkey, is_join in st.luts:
                    lut, kmin = _build_lut(host_tab(rname), rkey, is_join)
                    inputs[jname] = {"lut": lut, "kmin": kmin}
                    key += (jname, lut.shape[0])
                stage_hit = key in art.seen
                if stage_hit:
                    hits += 1
                else:
                    misses += 1
                    art.seen.add(key)
                t0 = time.perf_counter()
                out = art.stage_fns[st.index](inputs)
                if bool(out["respec"]):
                    raise TensorFallback(
                        "aggregate keys left the observed domain",
                        respec=True)
                if bool(out["fallback"]):
                    raise TensorFallback(f"stage {st.index}")
                if tr.enabled:
                    tr.event("residual_jit_cache", cat="compiler",
                             stage=st.index, hit=stage_hit,
                             ms=round(1e3 * (time.perf_counter() - t0), 3))
                for root, o in zip(st.jit_roots, out["outs"]):
                    out_tabs[id(root)] = _unpad(o)
            if st.pyop is not None:
                tables = [out_tabs[id(r)] if id(r) in out_tabs
                          else host_tab(art.leaf_names[id(r)])
                          for r in st.roots]
                t = st.pyop.fn(*tables)
                env[st.out_name] = t
                imemo[id(st.pyop)] = t
            else:
                r0 = st.roots[0]
                result = (out_tabs[id(r0)] if id(r0) in out_tabs
                          else host_tab(art.leaf_names[id(r0)]))
    except TensorFallback as e:
        fell_back = True
        m.counter("residual.fallbacks").inc()
        if e.respec:
            result = _respecialize(art, residual, merged)
        if result is None:
            result = interpreter.run(residual, merged)
    except Exception as e:
        if _device_failure(e):
            raise
        # a lowering failed (e.g. a derive that cannot take padded rows):
        # the oracle still answers, and this residual stays on it
        art.disabled = True
        fell_back = True
        m.counter("residual.fallbacks").inc()
        m.counter("residual.errors").inc()
        result = interpreter.run(residual, merged)
    m.counter("residual.tensor.runs").inc()
    m.counter("residual.jit_cache.hits").inc(hits)
    m.counter("residual.jit_cache.misses").inc(misses)
    return TensorRun(table=result, jit_hits=hits, jit_misses=misses,
                     fell_back=fell_back, n_stages=len(art.stages))


def run(residual: ir.Node, merged: Dict[str, ColumnTable]) -> ColumnTable:
    """Interpreter-signature twin: evaluate and return just the table."""
    return execute(residual, merged).table


def lowerings(residual: ir.Node) -> Tuple[List[Tuple], List[Tuple]]:
    """The lowering each keyed aggregate (``("code", mins, dims)`` or
    ``("lex",)``) and each join (``("lut", lut, leaf)`` or
    ``("sorted",)``) of the residual takes, in ``ir.walk`` order; empty
    lists before its first observation."""
    art = _artifact(residual)
    if art.obs is None:
        return [], []
    return ([art.obs["agg"][id(n)] for n in art.agg_nodes],
            [art.obs["join"][id(n)] for n in art.jn_nodes])


# ------------------------------------------------- auto-dispatch crossover
DEFAULT_RESIDUAL_THRESHOLD = 64_000  # merged rows; used when not calibrated
_AUTO_THRESHOLD: Dict[str, float] = {}  # device type -> crossover
_AUTO_LOCK = threading.Lock()


def calibrate_residual_threshold(
        sizes: Tuple[int, ...] = (4_000, 16_000, 64_000),
        repeats: int = 3, device=None) -> float:
    """Measure the interpreter-vs-tensor crossover on a synthetic
    join+aggregate residual (the residual-dominant shape) on ``device``
    (the card when None, as ``device.resolve_device`` resolves it) and
    return the merged-row count above which the warm tensor backend wins
    there. Scans sizes downward and stops at the first interpreter win, so
    a noisy tensor win at a tiny size cannot drag the threshold below a
    size where the interpreter is faster."""
    dev = resolve_device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda" else lambda: None)
    rng = np.random.default_rng(0)
    f = ir.Merged("fact")
    d = ir.Merged("dim")
    residual = ir.Aggregate(ir.Join(f, d, "k", "k"), ("g",),
                            (("s", "sum", "v"), ("c", "count", "v")))
    n_dim = 512
    dim = ColumnTable.from_numpy(
        {"k": np.arange(n_dim, dtype=np.int64),
         "g": rng.integers(0, 32, n_dim).astype(np.int64)}, dev)

    def best_of(fn) -> float:
        fn()
        sync()
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    lowest_tensor_win = None
    for size in sorted(sizes, reverse=True):
        fact = ColumnTable.from_numpy({
            "k": rng.integers(0, n_dim, size).astype(np.int64),
            "v": rng.uniform(0.0, 100.0, size)}, dev)
        merged = {"fact": fact, "dim": dim}
        execute(residual, merged)  # observe pass (returns the oracle)
        t_interp = best_of(lambda: interpreter.run(residual, merged))
        t_tensor = best_of(lambda: execute(residual, merged))
        if t_interp <= t_tensor:
            break
        lowest_tensor_win = size
    if lowest_tensor_win is None:
        return float("inf")  # tensor never won: auto stays on the oracle
    lower = max((s for s in sizes if s < lowest_tensor_win), default=None)
    return (float(lowest_tensor_win) if lower is None
            else float(np.sqrt(lowest_tensor_win * lower)))


def auto_threshold(device=None) -> float:
    """The crossover for ``EngineConfig.residual="auto"`` on ``device``
    (the card when None; the runtime passes the merged tables' device):
    the ``REPRO_RESIDUAL_THRESHOLD`` override, the default under
    ``REPRO_NO_CALIBRATE``, else calibrated on that device type at its
    first use and kept for it."""
    kind = resolve_device(device).type
    with _AUTO_LOCK:
        if kind in _AUTO_THRESHOLD:
            return _AUTO_THRESHOLD[kind]
        env = os.environ.get("REPRO_RESIDUAL_THRESHOLD")
        if env:
            th = float(env)
        elif os.environ.get("REPRO_NO_CALIBRATE"):
            th = float(DEFAULT_RESIDUAL_THRESHOLD)
        else:
            try:
                th = calibrate_residual_threshold(device=kind)
            except Exception as e:  # best effort, unless the device failed
                if _device_failure(e):
                    raise
                th = float(DEFAULT_RESIDUAL_THRESHOLD)
        _AUTO_THRESHOLD[kind] = th
        return th
