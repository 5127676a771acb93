"""Semantic pushed-result cache: each partition's pushed output, kept on
the device, served instead of running the storage-side pass again.

Port of ``repro.core.result_cache``. An entry holds one partition's
result slice and its §4.2 by-products (packed selection words, shuffle
slices, position vector) as device tensors: owned copies (``clone``), since
a batch result is a view into the fused pass's tensors and caching the view
would keep the whole batch's allocation alive under the caching allocator.
The byte budget counts device bytes (``numel() * element_size()``), with
the reference's ``max(64, result + by-products)`` per entry.

Keying
------
An entry is keyed ``(table, partition index, plan key)``; the plan key is
derived from the plan's semantics (predicate repr, output columns, derive
closures' bytecode, constants and captures, agg/top-k/shuffle/having
specs), so two plan objects with equal semantics share entries. A derive
closure that captures a tensor is keyed by its dtype, shape and bytes
(a tensor's repr elides elements). Each entry records the partition's
``version`` stamp; an append or update bumps it, and stale entries are
dropped at their next lookup, so the cache never serves rows of
overwritten bytes. ``apply_bitmap`` plans depend on the compute layer's
words and are never cached.

Containment
-----------
For a pure filter/project(+derive) plan whose predicate columns are in
its output and untouched by derives, a cached entry whose predicate A is
looser than the request's B (``expressions.implies(B, A)``) holds a
superset of B's rows in partition order. Filtering it by B's program on
the device (``CompiledPushPlan.refilter``) gives the uncached path's
rows: subsetting commutes with elementwise derives, and filtering an
ordered superset keeps B's rows in order.

Eviction and threads
--------------------
Inserts evict from the LRU end, weighted by hits: among the
``evict_window`` least-recent entries the least-hit goes first. One lock
guards the index; the served tensors are never written, so the
containment re-filter runs outside it.

Counters and gauges (``obs.metrics``): ``cache.hit``,
``cache.hit.containment``, ``cache.miss``, ``cache.evict``,
``cache.evict.stale``, ``cache.bytes``, ``cache.entries``. ``cost_hint``
moves none of them, so ``cache.hit`` counts exactly the partitions the
executor skipped.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.obs.metrics import get_metrics
from repro_torch.queryproc import expressions as ex
from repro_torch.queryproc.table import ColumnTable
from repro_torch.storage.catalog import Partition

DEFAULT_BUDGET_BYTES = 256 << 20


# ------------------------------------------------------------- plan keying
def _cell_key(v) -> str:
    """A captured value's key: its repr, or for a tensor its dtype, shape
    and a digest of its bytes."""
    if not isinstance(v, torch.Tensor):
        return repr(v)
    t = v.detach().reshape(-1).cpu().contiguous()
    digest = hashlib.blake2b(t.view(torch.uint8).numpy().tobytes(),
                             digest_size=16).hexdigest()
    return f"tensor({t.dtype},{tuple(v.shape)},{digest})"


def _fn_key(fn) -> str:
    """Semantic identity of a derive closure: bytecode, constants and the
    captured cells' keys, so two lambdas computing the same thing from the
    same captures key alike across compiles."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return repr(fn)
    cells = getattr(fn, "__closure__", None)
    closure = tuple(_cell_key(c.cell_contents) for c in cells) if cells \
        else ()
    return f"{code.co_code.hex()}/{code.co_consts!r}/{closure!r}"


def plan_cache_key(plan, with_predicate: bool = True) -> str:
    """The semantic cache key of a PushPlan. With ``with_predicate=False``
    the predicate slot is blanked: the *shape* key under which containment
    donors with different predicates are indexed together."""
    return "|".join([
        plan.table,
        ",".join(plan.columns),
        repr(plan.predicate) if with_predicate else "<pred>",
        ";".join(f"{n}({','.join(ic)})#{_fn_key(fn)}"
                 for n, ic, fn in plan.derive),
        repr(plan.agg), repr(plan.top_k), repr(plan.shuffle),
        f"bm{int(plan.bitmap_only)}ab{int(plan.apply_bitmap)}",
        repr(plan.having),
    ])


@dataclasses.dataclass(frozen=True)
class PlanKeys:
    exact: str               # full semantic key
    shape: Optional[str]     # predicate-blanked key; None: not eligible
    #                          for containment (see the module docstring)
    cacheable: bool          # False for apply_bitmap plans


_KEYS_MEMO: "OrderedDict[int, Tuple[object, PlanKeys]]" = OrderedDict()
_KEYS_CAP = 512
_KEYS_LOCK = threading.Lock()


def plan_keys(plan) -> PlanKeys:
    """The plan's keys, memoized per plan object (guarded by identity)."""
    with _KEYS_LOCK:
        hit = _KEYS_MEMO.get(id(plan))
        if hit is not None and hit[0] is plan:
            _KEYS_MEMO.move_to_end(id(plan))
            return hit[1]
    shape = None
    if (plan.predicate is not None and plan.agg is None
            and plan.top_k is None and plan.shuffle is None
            and not plan.bitmap_only and not plan.apply_bitmap):
        pred_cols = ex.columns_of(plan.predicate)
        derived = {n for n, _, _ in plan.derive}
        if pred_cols <= set(plan.columns) and not (pred_cols & derived):
            shape = plan_cache_key(plan, with_predicate=False)
    keys = PlanKeys(exact=plan_cache_key(plan), shape=shape,
                    cacheable=not plan.apply_bitmap)
    with _KEYS_LOCK:
        _KEYS_MEMO[id(plan)] = (plan, keys)
        while len(_KEYS_MEMO) > _KEYS_CAP:
            _KEYS_MEMO.popitem(last=False)
    return keys


# ----------------------------------------------------------------- entries
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _table_bytes(t: ColumnTable) -> int:
    return sum(_nbytes(v) for v in t.cols.values())


def _copy_table(t: ColumnTable) -> ColumnTable:
    return ColumnTable({c: v.clone() for c, v in t.cols.items()})


def _copy_aux(aux: Dict) -> Tuple[Dict, int]:
    """Owned copies of the by-products, and their device bytes."""
    out: Dict = {}
    extra = 0
    if "bitmap" in aux:
        out["bitmap"] = aux["bitmap"].clone()
        extra += _nbytes(out["bitmap"])
    if "shuffle_parts" in aux:
        out["shuffle_parts"] = [_copy_table(p) for p in aux["shuffle_parts"]]
        extra += sum(_table_bytes(p) for p in out["shuffle_parts"])
    if "position_vector" in aux:
        out["position_vector"] = aux["position_vector"].clone()
        extra += _nbytes(out["position_vector"])
    return out, extra


@dataclasses.dataclass
class CacheEntry:
    key: Tuple[str, int, str]        # (table, partition index, exact key)
    version: int                     # partition version at fill time
    result: ColumnTable              # this partition's output slice
    aux: Dict                        # its by-products (owned copies)
    nbytes: int                      # device bytes counted in the budget
    predicate: Optional[ex.Expr]     # for containment donor checks
    shape: Optional[str]
    hits: int = 0

    def ship_bytes(self) -> int:
        """What serving this entry puts on the wire (the warm ``s_out``):
        ``runtime.result_bytes``'s arithmetic."""
        n = _table_bytes(self.result)
        if "bitmap" in self.aux:
            n += _nbytes(self.aux["bitmap"])
        return max(64, n)


class ResultCache:
    """Thread-safe, byte-budgeted cache of per-(partition, plan) pushed
    outputs on the device. See the module docstring."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 evict_window: int = 8):
        self.budget_bytes = int(budget_bytes)
        self.evict_window = int(evict_window)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, int, str], CacheEntry]" = \
            OrderedDict()
        self._by_shape: Dict[Tuple[str, int, str],
                             List[Tuple[str, int, str]]] = {}
        self.bytes = 0

    def _drop(self, key: Tuple[str, int, str]) -> Optional[CacheEntry]:
        e = self._entries.pop(key, None)
        if e is None:
            return None
        self.bytes -= e.nbytes
        if e.shape is not None:
            sk = (key[0], key[1], e.shape)
            lst = self._by_shape.get(sk)
            if lst is not None:
                if key in lst:
                    lst.remove(key)
                if not lst:
                    del self._by_shape[sk]
        return e

    def _evict_one(self) -> None:
        """Among the ``evict_window`` least-recently used entries, evict
        the least-hit one (ties: the oldest)."""
        window = []
        for key, e in self._entries.items():
            window.append((key, e))
            if len(window) >= self.evict_window:
                break
        self._drop(min(window, key=lambda kv: kv[1].hits)[0])

    def _publish_gauges(self) -> None:
        m = get_metrics()
        m.gauge("cache.bytes").set(float(self.bytes))
        m.gauge("cache.entries").set(float(len(self._entries)))

    # ------------------------------------------------------------- serving
    def serve(self, cplan, part: Partition
              ) -> Optional[Tuple[ColumnTable, Dict, str]]:
        """One partition's pushed output for ``cplan``, or None on a miss.

        Returns ``(result, aux, kind)``, kind ``"exact"`` or
        ``"containment"``; the aux dict carries a ``"cache"`` marker, so
        the runtime's outcomes reconcile with the ``cache.hit`` counter."""
        keys = plan_keys(cplan.plan)
        if not keys.cacheable:
            return None
        m = get_metrics()
        key = (part.table, part.index, keys.exact)
        donor: Optional[CacheEntry] = None
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.version != part.version:
                self._drop(key)
                m.counter("cache.evict.stale").inc()
                self._publish_gauges()
                e = None
            if e is not None:
                self._entries.move_to_end(key)
                e.hits += 1
            elif keys.shape is not None:
                sk = (part.table, part.index, keys.shape)
                # newest donors first: they survived eviction longest
                for ck in reversed(self._by_shape.get(sk, ())):
                    c = self._entries.get(ck)
                    if c is None:
                        continue
                    if c.version != part.version:
                        self._drop(ck)
                        m.counter("cache.evict.stale").inc()
                        self._publish_gauges()
                        continue
                    if ck != key and ex.implies(cplan.plan.predicate,
                                                c.predicate):
                        donor = c
                        self._entries.move_to_end(ck)
                        c.hits += 1
                        break
        if e is not None:
            m.counter("cache.hit").inc()
            return e.result, dict(e.aux, cache="exact"), "exact"
        if donor is not None:
            res = cplan.refilter(donor.result)
            m.counter("cache.hit").inc()
            m.counter("cache.hit.containment").inc()
            return res, {"cache": "containment"}, "containment"
        m.counter("cache.miss").inc()
        return None

    def put(self, cplan, part: Partition, result: ColumnTable,
            aux: Dict) -> None:
        """Install one partition's freshly computed pushed output."""
        keys = plan_keys(cplan.plan)
        if not keys.cacheable:
            return
        res = _copy_table(result)
        stored_aux, extra = _copy_aux(aux)
        nbytes = max(64, _table_bytes(res) + extra)
        if nbytes > self.budget_bytes:
            return  # larger than the whole budget: not worth thrashing for
        entry = CacheEntry(key=(part.table, part.index, keys.exact),
                           version=part.version, result=res, aux=stored_aux,
                           nbytes=nbytes, predicate=cplan.plan.predicate,
                           shape=keys.shape)
        n_evicted = 0
        with self._lock:
            self._drop(entry.key)  # replace in place: exact accounting
            self._entries[entry.key] = entry
            self.bytes += entry.nbytes
            if keys.shape is not None:
                sk = (part.table, part.index, keys.shape)
                self._by_shape.setdefault(sk, []).append(entry.key)
            while self.bytes > self.budget_bytes and len(self._entries) > 1:
                self._evict_one()
                n_evicted += 1
            if self.bytes > self.budget_bytes:
                self._drop(entry.key)
                n_evicted += 1
            self._publish_gauges()
        if n_evicted:
            get_metrics().counter("cache.evict").inc(n_evicted)

    # ------------------------------------------------------- cost probing
    def cost_hint(self, cplan, part: Partition) -> Optional[int]:
        """The bytes a warm serve of ``(cplan, part)`` would ship, or None
        when cold. Silent: no counters, no LRU motion (``plan_requests``
        probes every request). A containment donor's size bounds the
        re-filtered size from above."""
        keys = plan_keys(cplan.plan)
        if not keys.cacheable:
            return None
        with self._lock:
            e = self._entries.get((part.table, part.index, keys.exact))
            if e is not None and e.version == part.version:
                return e.ship_bytes()
            if keys.shape is not None:
                sk = (part.table, part.index, keys.shape)
                for ck in reversed(self._by_shape.get(sk, ())):
                    c = self._entries.get(ck)
                    if (c is not None and c.version == part.version
                            and ex.implies(cplan.plan.predicate,
                                           c.predicate)):
                        return c.ship_bytes()
        return None

    # ------------------------------------------------------- introspection
    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self.bytes,
                    "hits": sum(e.hits for e in self._entries.values())}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_shape.clear()
            self.bytes = 0
            self._publish_gauges()
