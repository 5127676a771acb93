"""Deterministic fault injection and the runtime's recovery contract.

Port of ``repro.core.faults``. The same environment variables, the
same spec grammar and the same draws, so a schedule injects the same
faults at the same (node, path, table, group, attempt) coordinates as the
JAX package's:

- :class:`FaultPlan`: a seedable, schedule-driven injector the runtime
  consults at every storage-execute boundary. Rules are scoped per
  (node, path[, table]) and cover four failure kinds: ``crash`` (the
  worker died), ``timeout`` (the attempt blew its budget), ``transient``
  (a retryable remote error) and ``straggler`` (the request completes,
  late). Draws are pure blake2b hashes of ``(seed, epoch, rule, node,
  path, table, group key, attempt, salt)``: no RNG state, no wall clock.
  Every injection is logged for reconciliation against the runtime's
  counters.
- :class:`RetryPolicy`: capped exponential backoff with deterministic
  jitter under a *charged* deadline budget (timeouts and backoffs consume
  nominal seconds whether or not the process sleeps), and the recovery on
  exhaustion: **demote the group to pushback** (ship the raw projection,
  replay the compiled plan compute-side, on the same kernels) rather than
  raise.
- :class:`CircuitBreaker`: a per-(node, path) consecutive-failure trip
  with half-open probes. The runtime records every storage outcome in it;
  the Arbitrator consults it, so new decisions route around a tripped
  node's pushdown path until a probe succeeds.

Environment (read by ``runtime.execute_split`` when no plan is given):

- ``REPRO_FAULT_SPEC``, e.g.
  ``"pushdown.crash:0.05,node1.pushdown.timeout:0.1,straggler:0.2:0.05"``
- ``REPRO_FAULT_SEED``: integer seed (default 0)
- ``REPRO_FAULT_SLEEP_SCALE``: scales *real* sleeps (backoff, straggler
  delay, timeout charges); 0 makes chaos runs instant while the charged
  arithmetic stays exact.

Host-only policy and bookkeeping; the execution side is in
``core.runtime``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import get_metrics

FAULT_CRASH = "crash"
FAULT_TIMEOUT = "timeout"
FAULT_TRANSIENT = "transient"
FAULT_STRAGGLER = "straggler"
FAULT_KINDS = (FAULT_CRASH, FAULT_TIMEOUT, FAULT_TRANSIENT, FAULT_STRAGGLER)
# kinds that abort the attempt (straggler completes, just late)
FAILURE_KINDS = (FAULT_CRASH, FAULT_TIMEOUT, FAULT_TRANSIENT)


class FaultExhausted(RuntimeError):
    """A request group ran out of retry budget with recovery disabled
    (``RetryPolicy.demote_on_exhaust=False`` — the fail-to-error baseline)
    or failed on a path that has no further fallback."""

    def __init__(self, kind: str, node: int, path: str, table: str,
                 attempts: int):
        super().__init__(
            f"storage {kind} on node {node} ({path}, table={table}) "
            f"persisted through {attempts} attempt(s)")
        self.kind = kind
        self.node = node
        self.path = path
        self.table = table
        self.attempts = attempts


class WorkerFault(RuntimeError):
    """A real storage-worker failure seen at the channel of the process
    tier (``distributed.workers``): the worker process died (``crash``:
    its channel hit EOF, say after a SIGKILL) or a request outlived the
    channel's deadline (``timeout``). The recovery loop treats it as an
    injected fault of the same kind (charged, counted, retried, then
    demoted), except that a real timeout is not slept again. The pool
    ledgers every one in ``WorkerPool.events``."""

    def __init__(self, kind: str, node: int, detail: str = ""):
        if kind not in (FAULT_CRASH, FAULT_TIMEOUT):
            raise ValueError(f"a worker fault is a crash or a timeout, "
                             f"not {kind!r}")
        super().__init__(f"storage worker {kind} on node {node}"
                         + (f": {detail}" if detail else ""))
        self.kind = kind
        self.node = node
        self.detail = detail


class HedgeAborted(RuntimeError):
    """A hedged race's loser saw its abort token between attempts and
    stopped. Raised inside the loser's future, which ``run_stream`` never
    reads (only the winner's result is), so it surfaces nowhere: it stops
    the loser from adding calibration samples, fault draws and demotions
    after the race is decided."""

    def __init__(self, node: int, path: str, table: str):
        super().__init__(f"hedge loser aborted on node {node} "
                         f"({path}, table={table})")
        self.node = node
        self.path = path
        self.table = table


# --------------------------------------------------------------- fault plan
@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection rule. ``prob`` is evaluated independently per
    (group, attempt) draw; ``param`` is the straggler delay in seconds
    (ignored by other kinds). ``node``/``path``/``table`` of ``None``
    match anything; ``max_times`` caps total injections (None = no cap,
    the only stateful part of a plan — deterministic schedules that use
    it depend on draw order, so keep it to single-threaded tests)."""
    kind: str
    prob: float
    param: Optional[float] = None
    node: Optional[int] = None
    path: Optional[str] = None
    table: Optional[str] = None
    max_times: Optional[int] = None

    def matches(self, node: int, path: str, table: str) -> bool:
        return ((self.node is None or self.node == node)
                and (self.path is None or self.path == path)
                and (self.table is None or self.table == table))


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """What the plan injected for one draw."""
    kind: str
    param: Optional[float] = None
    rule: int = 0                      # index of the rule that fired


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One logged injection — the reconciliation ledger entry."""
    kind: str
    node: int
    path: str
    table: str
    key: str
    attempt: int
    salt: str
    rule: int


def _unit_draw(text: str) -> float:
    """Deterministic uniform [0, 1) from a key string (no RNG state)."""
    h = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


class FaultPlan:
    """A deterministic fault schedule over (node, path, table, group).

    ``draw()`` is a pure function of the plan's seed/epoch and the draw
    coordinates, so concurrent callers replay the same schedule in any
    interleaving; every injection is appended to a thread-safe event log
    (:meth:`events`) that tests reconcile exactly against the runtime's
    ``faults.*`` counters and per-request outcome accounting.

    ``epoch`` salts every draw: bump it (:meth:`bump_epoch`) to rehearse
    a *different* deterministic schedule with the same rules — the
    fail-to-error baseline uses this so a restarted query does not hit
    the byte-identical fault again forever.
    """

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        for r in rules:
            if r.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {r.kind!r}")
            if not (0.0 <= r.prob <= 1.0):
                raise ValueError(f"fault prob out of range: {r.prob}")
        self.rules = tuple(rules)
        self.seed = int(seed)
        self.epoch = 0
        self._events: List[FaultEvent] = []
        self._fired: Dict[int, int] = {}       # rule idx -> times fired
        self._lock = threading.Lock()

    # ------------------------------------------------------------ schedule
    def _key(self, rule_idx: int, node: int, path: str, table: str,
             key: str, attempt: int, salt: str) -> str:
        return (f"{self.seed}|{self.epoch}|{rule_idx}|{node}|{path}|"
                f"{table}|{key}|{attempt}|{salt}")

    def draw(self, node: int, path: str, table: str, key: str,
             attempt: int, salt: str = "") -> Optional[FaultAction]:
        """The injection decision for one storage-execute attempt.
        ``key`` identifies the request group deterministically (the
        runtime uses ``"<min req_id>x<n requests>"``); ``salt``
        distinguishes otherwise-identical draws (hedge duplicates)."""
        for i, rule in enumerate(self.rules):
            if not rule.matches(node, path, table) or rule.prob <= 0.0:
                continue
            if rule.max_times is not None:
                with self._lock:
                    if self._fired.get(i, 0) >= rule.max_times:
                        continue
            u = _unit_draw(self._key(i, node, path, table, key, attempt,
                                     salt))
            if u < rule.prob:
                ev = FaultEvent(rule.kind, node, path, table, key, attempt,
                                salt, i)
                with self._lock:
                    self._fired[i] = self._fired.get(i, 0) + 1
                    self._events.append(ev)
                return FaultAction(rule.kind, rule.param, i)
        return None

    def jitter(self, node: int, path: str, table: str, key: str,
               attempt: int) -> float:
        """Deterministic uniform [0, 1) for backoff jitter — same
        coordinates as the draws, different salt, so jitter never
        correlates with the injection schedule."""
        return _unit_draw(self._key(-1, node, path, table, key, attempt,
                                    "jitter"))

    def bump_epoch(self) -> int:
        """Advance to the next deterministic schedule (see class doc)."""
        with self._lock:
            self.epoch += 1
            return self.epoch

    # ---------------------------------------------------------- the ledger
    def events(self) -> List[FaultEvent]:
        with self._lock:
            return list(self._events)

    def counts(self) -> Dict[str, int]:
        """Injected-event totals by kind (the reconciliation headline)."""
        out = {k: 0 for k in FAULT_KINDS}
        with self._lock:
            for ev in self._events:
                out[ev.kind] += 1
        return out

    def clear_events(self) -> None:
        with self._lock:
            self._events.clear()
            self._fired.clear()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FaultPlan(seed={self.seed}, epoch={self.epoch}, "
                f"rules={list(self.rules)!r})")

    # ------------------------------------------------------------- parsing
    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse the ``REPRO_FAULT_SPEC`` grammar: comma-separated
        clauses ``[node<N>.][pushdown|pushback.][<table>.]kind:prob[:param]``.

        Examples::

            crash:0.1                       # 10% of any storage execute
            pushdown.transient:0.2          # pushdown attempts only
            node1.pushdown.timeout:0.05     # node 1's pushdown path
            straggler:0.3:0.05              # 30% of groups finish 50ms late
            node0.lineitem.crash:1.0        # every lineitem group on node 0
        """
        rules: List[FaultRule] = []
        for clause in spec.split(","):
            clause = clause.strip()
            if not clause:
                continue
            head, _, tail = clause.partition(":")
            if not tail:
                raise ValueError(f"fault clause needs kind:prob — {clause!r}")
            parts = head.split(".")
            kind = parts[-1]
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r} in {clause!r}")
            node = path = table = None
            for scope in parts[:-1]:
                if scope.startswith("node") and scope[4:].isdigit():
                    node = int(scope[4:])
                elif scope in ("pushdown", "pushback"):
                    path = scope
                else:
                    table = scope
            nums = tail.split(":")
            prob = float(nums[0])
            param = float(nums[1]) if len(nums) > 1 else None
            rules.append(FaultRule(kind, prob, param, node, path, table))
        return cls(rules, seed=seed)


_ENV_CACHE: Dict[Tuple[str, str], Optional[FaultPlan]] = {}


def env_plan() -> Optional[FaultPlan]:
    """The process-wide plan from ``REPRO_FAULT_SPEC``/``REPRO_FAULT_SEED``
    (None when unset). Cached per (spec, seed) so repeated runtime calls
    share one event ledger — reassign the env vars to get a fresh plan."""
    spec = os.environ.get("REPRO_FAULT_SPEC", "")
    if not spec.strip():
        return None
    seed = os.environ.get("REPRO_FAULT_SEED", "0")
    key = (spec, seed)
    if key not in _ENV_CACHE:
        _ENV_CACHE[key] = FaultPlan.from_spec(spec, seed=int(seed))
    return _ENV_CACHE[key]


def sleep_scale() -> float:
    """Multiplier for *real* sleeps (charged seconds are always nominal)."""
    try:
        return max(0.0, float(os.environ.get("REPRO_FAULT_SLEEP_SCALE",
                                             "1.0")))
    except ValueError:
        return 1.0


# ------------------------------------------------------------ retry policy
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/deadline semantics for one storage request group.

    The deadline is a *charged* budget: every failed attempt charges its
    nominal detection cost (``attempt_timeout_s`` for timeouts,
    ``detect_s`` for crash/transient) and every backoff its nominal
    duration, whether or not the process really slept (real sleeps are
    ``nominal * sleep_scale``; see :func:`sleep_scale`). Charged
    arithmetic makes exhaustion — and therefore demotion, and therefore
    the whole recovery trajectory — machine-independent and replayable.

    On exhaustion (attempts or budget): ``demote_on_exhaust=True`` (the
    contract) demotes the group to pushback; ``False`` raises
    :class:`FaultExhausted` — the fail-to-error baseline the chaos
    benchmark beats."""
    max_attempts: int = 3
    backoff_base_s: float = 0.002
    backoff_mult: float = 2.0
    backoff_cap_s: float = 0.05
    jitter: float = 0.5            # +/- fraction of the backoff
    deadline_s: float = 0.25       # charged budget across all attempts
    attempt_timeout_s: float = 0.03
    detect_s: float = 0.002
    demote_on_exhaust: bool = True
    sleep_scale: Optional[float] = None   # None -> env (REPRO_FAULT_SLEEP_SCALE)

    def charge(self, kind: str) -> float:
        return self.attempt_timeout_s if kind == FAULT_TIMEOUT \
            else self.detect_s

    def backoff_s(self, attempt: int, u: float) -> float:
        """Capped exponential backoff for retry number ``attempt`` (1-based),
        jittered by the deterministic uniform ``u``."""
        b = min(self.backoff_cap_s,
                self.backoff_base_s * self.backoff_mult ** (attempt - 1))
        return b * (1.0 - self.jitter + 2.0 * self.jitter * u)

    def real_scale(self) -> float:
        return self.sleep_scale if self.sleep_scale is not None \
            else sleep_scale()


# ------------------------------------------------------------ hedge policy
@dataclasses.dataclass
class HedgePolicy:
    """Straggler hedging for ``run_stream``'s storage futures.

    The hedge delay is calibrated online: ``multiplier`` times the
    ``percentile``-th percentile of the storage-execute durations seen so
    far in the same stream (at least ``min_delay_s``; no hedging before
    ``min_samples`` of them). ``fixed_delay_s`` pins the delay instead, so
    that hedges fire deterministically."""
    enabled: bool = True
    percentile: float = 95.0
    multiplier: float = 3.0
    min_samples: int = 6
    min_delay_s: float = 0.01
    fixed_delay_s: Optional[float] = None

    def delay_s(self, samples: Sequence[float]) -> Optional[float]:
        """Seconds to wait on a storage future before hedging it (None:
        do not hedge)."""
        if not self.enabled:
            return None
        if self.fixed_delay_s is not None:
            return self.fixed_delay_s
        if len(samples) < self.min_samples:
            return None
        s = sorted(samples)
        rank = min(len(s) - 1,
                   max(0, int(round(self.percentile / 100.0 * (len(s) - 1)))))
        return max(self.min_delay_s, self.multiplier * s[rank])


# --------------------------------------------------------- circuit breaker
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

ROUTE_ALLOW = "allow"
ROUTE_DENY = "deny"
ROUTE_PROBE = "probe"


class CircuitBreaker:
    """Per-(node, path) consecutive-failure breaker with half-open probes.

    State machine per (node, path):

    - ``closed`` — normal routing; ``trip_after`` *consecutive* recorded
      failures opens it.
    - ``open`` — :meth:`route` answers ``deny`` (the Arbitrator sends the
      request down the other path). After ``probe_after`` denials the
      breaker half-opens and grants exactly one ``probe``.
    - ``half_open`` — one probe is in flight; further routing is denied.
      A recorded success closes the breaker, a failure re-opens it (and
      the denial count restarts).

    Counting *routing decisions* rather than wall clock keeps recovery
    deterministic under any thread interleaving — the same property the
    fault schedule has. The runtime records every storage outcome here
    (and publishes the matching ``faults.node<N>.<path>.failures`` /
    ``.successes`` counters next to the ``stream.*`` gauges that
    ``MeasuredLoad`` polls, so a distributed poller sees the same
    signals the breaker trips on). Thread-safe."""

    def __init__(self, trip_after: int = 3, probe_after: int = 8):
        assert trip_after >= 1 and probe_after >= 1
        self.trip_after = trip_after
        self.probe_after = probe_after
        self._state: Dict[Tuple[int, str], str] = {}
        self._consec: Dict[Tuple[int, str], int] = {}
        self._denied: Dict[Tuple[int, str], int] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- routing
    def state(self, node: int, path: str) -> str:
        with self._lock:
            return self._state.get((node, path), BREAKER_CLOSED)

    def route(self, node: int, path: str) -> str:
        """Routing verdict for one *new* decision on (node, path):
        ``allow`` | ``deny`` | ``probe`` (probe = route it, and the next
        recorded outcome decides whether the breaker closes)."""
        key = (node, path)
        with self._lock:
            st = self._state.get(key, BREAKER_CLOSED)
            if st == BREAKER_CLOSED:
                return ROUTE_ALLOW
            if st == BREAKER_HALF_OPEN:
                return ROUTE_DENY            # one probe already in flight
            denied = self._denied.get(key, 0) + 1
            if denied >= self.probe_after:
                self._state[key] = BREAKER_HALF_OPEN
                self._denied[key] = 0
                get_metrics().counter("breaker.probe").inc()
                return ROUTE_PROBE
            self._denied[key] = denied
            get_metrics().counter("breaker.denied").inc()
            return ROUTE_DENY

    # ------------------------------------------------------------ feedback
    def record_failure(self, node: int, path: str) -> None:
        key = (node, path)
        with self._lock:
            st = self._state.get(key, BREAKER_CLOSED)
            n = self._consec.get(key, 0) + 1
            self._consec[key] = n
            if st == BREAKER_HALF_OPEN or \
                    (st == BREAKER_CLOSED and n >= self.trip_after):
                self._state[key] = BREAKER_OPEN
                self._denied[key] = 0
                get_metrics().counter("breaker.trip").inc()

    def record_success(self, node: int, path: str) -> None:
        key = (node, path)
        with self._lock:
            self._consec[key] = 0
            if self._state.get(key, BREAKER_CLOSED) != BREAKER_CLOSED:
                self._state[key] = BREAKER_CLOSED
                self._denied[key] = 0
                get_metrics().counter("breaker.close").inc()

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            keys = set(self._state) | set(self._consec)
            return {f"node{n}.{p}": {
                "state": self._state.get((n, p), BREAKER_CLOSED),
                "consecutive_failures": self._consec.get((n, p), 0),
                "denied_since_open": self._denied.get((n, p), 0),
            } for n, p in sorted(keys)}
