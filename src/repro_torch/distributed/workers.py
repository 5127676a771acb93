"""Multi-process storage tier: storage workers in their own processes.

Port of ``repro.distributed.workers``. One storage-worker process per
catalog node holds that node's partitions and runs pushed plans on them:

- the compute side dispatches ``PushPlan``s over a socketpair in
  length-prefixed frames (u32 frame length | u32 header length | JSON
  header | raw body): tensors travel as a dtype, a shape and their raw
  bytes, plans as a pickle whose functions travel as marshalled code (the
  ``derive`` lambdas), and each worker compiles the plans it receives;
- a pushback fetches the raw accessed-column projection as serialized
  bytes (``fetch_projection``), which the compute side replays;
- every response carries the worker's load (queue depths, in flight, CPU
  occupancy, and its kernel launches so far), which the pool publishes
  into the ``stream.node<N>.exec_queue``/``ship_queue`` gauges that the
  Arbitrator's ``MeasuredLoad`` reads; ``burn()`` adds real pressure;
- worker spans ride back in the response and are adopted under the
  dispatching span;
- a dead channel (EOF after a SIGKILL) or an overdue request raises
  ``core.faults.WorkerFault`` (``crash``/``timeout``), which the runtime's
  retry -> demote loop recovers from the parent's own catalog copy.

Two things differ from the reference, both because of the card:

- Workers are started with ``spawn``, not ``fork``: a child forked after
  its parent initialized CUDA cannot use CUDA, and the parent has by the
  time a pool exists (its catalog lives on the card). A worker gets the
  catalog's device; on CUDA it creates its own context and loads the
  kernel libraries the pool built before spawning it, and a worker that
  cannot do so fails the pool's construction with its error. It never
  runs the plain versions in place of the kernels.
- Tensors are staged through the host: the sender copies them off its
  device (into page-locked host memory, which also waits for the work
  that made them), the receiver reads them with ``torch.frombuffer`` and
  moves them to its device. A pushback is a real copy between processes, the ``wire.*``
  byte counters mean what they mean in the reference, and nothing of a
  killed worker stays mapped in the parent.

``EngineConfig(storage_tier="process")`` or ``worker_pool=pool`` routes a
run through a pool; results equal the in-process tier's for any decision
vector and fault schedule.
"""
from __future__ import annotations

import atexit
import hashlib
import importlib
import io
import itertools
import json
import marshal
import multiprocessing
import os
import pickle
import queue
import signal
import socket
import struct
import threading
import time
import types
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutTimeout
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.core import faults as _faults
from repro_torch.core.executor import (EXECUTOR_REFERENCE, CompiledPushPlan,
                                       compile_push_plan)
from repro_torch.core.plan import execute_push_plan
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_metrics
from repro_torch.queryproc.table import ColumnTable

__all__ = ["WorkerPool", "pool_for", "close_all_pools",
           "encode_plan", "decode_plan"]

_U32 = struct.Struct("<I")
_HELLO = -1            # request id of the frame a worker sends once started
START_TIMEOUT_S = 300.0  # a spawned worker imports torch, creates its CUDA
#                         context and loads the kernels before it answers


# ------------------------------------------------------------- wire framing
def _write_frame(sock: socket.socket, header: Dict, body=b"") -> int:
    """One length-prefixed frame: u32 total | u32 hlen | header | body.
    ``body`` is a bytes-like object or a sequence of them, sent in order
    without joining. Returns the bytes written (the wire-byte unit)."""
    h = json.dumps(header, separators=(",", ":")).encode("utf-8")
    parts = ([body] if isinstance(body, (bytes, bytearray, memoryview))
             else list(body))
    n = sum(memoryview(p).nbytes for p in parts)
    sock.sendall(b"".join((_U32.pack(4 + len(h) + n), _U32.pack(len(h)), h)))
    for p in parts:
        sock.sendall(p)
    return 8 + len(h) + n


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise EOFError("channel closed")
        got += k
    return buf


def _read_frame(sock: socket.socket) -> Tuple[Dict, memoryview, int]:
    """(header, body view, total frame bytes)."""
    total = _U32.unpack(bytes(_read_exact(sock, 4)))[0]
    payload = _read_exact(sock, total)
    hlen = _U32.unpack(bytes(payload[:4]))[0]
    header = json.loads(bytes(payload[4:4 + hlen]).decode("utf-8"))
    return header, memoryview(payload)[4 + hlen:], 4 + total


# ------------------------------------------------------ value/table codec
_DTYPES = {str(d).split(".")[1]: d for d in (
    torch.bool, torch.uint8, torch.int8, torch.int16, torch.uint16,
    torch.int32, torch.uint32, torch.int64, torch.uint64, torch.float16,
    torch.bfloat16, torch.float32, torch.float64)}


class _Cursor:
    """Sequential reader over a frame body (buffers decode in the order
    ``_enc`` appended them)."""

    def __init__(self, body):
        self.body = memoryview(body)
        self.off = 0

    def take(self, n: int) -> memoryview:
        v = self.body[self.off:self.off + n]
        self.off += n
        return v


def _enc_tensor(t: torch.Tensor, bufs: List) -> Dict:
    """The tensor's bytes on the host, appended to ``bufs``. A card tensor
    is copied off the card here, into page-locked memory from the caching
    host allocator (which waits for the work that made it, and copies at
    the bus's rate where ``.cpu()``'s pageable copy faults in fresh pages);
    a contiguous host tensor is sent from its own memory."""
    t = t.detach()
    if t.device.type == "cpu":
        host = t.contiguous()
    else:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
    raw = host.reshape(-1).view(torch.uint8).numpy()
    bufs.append(raw)
    return {"!": "t", "d": str(t.dtype).split(".")[1], "s": list(t.shape),
            "n": raw.nbytes}


def _enc(v, bufs: List):
    """Encode a value tree into a JSON-able header structure plus raw body
    buffers: scalars, tensors, ColumnTables and nested list/tuple/dict,
    everything a push-plan result and its aux dict hold."""
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, int):
        return int(v)
    if isinstance(v, float):
        return float(v)
    if isinstance(v, torch.Tensor):
        return _enc_tensor(v, bufs)
    if isinstance(v, ColumnTable):
        return {"!": "ct",
                "c": [[c, _enc_tensor(v.cols[c], bufs)] for c in v.columns]}
    if isinstance(v, tuple):
        return {"!": "tu", "v": [_enc(x, bufs) for x in v]}
    if isinstance(v, list):
        return {"!": "li", "v": [_enc(x, bufs) for x in v]}
    if isinstance(v, dict):
        return {"!": "di",
                "v": [[_enc(k, bufs), _enc(x, bufs)] for k, x in v.items()]}
    raise TypeError(f"not wire-encodable: {type(v).__name__}")


def _dec_tensor(spec: Dict, cur: _Cursor, device: torch.device
                ) -> torch.Tensor:
    """A tensor on ``device`` from its bytes in the received frame. On the
    host it is a writable view of the frame's bytearray (a copy only where
    the bytes are not aligned to the element size); on the card, a copy
    there."""
    raw = cur.take(spec["n"])
    dtype = _DTYPES[spec["d"]]
    if spec["n"] == 0:
        return torch.empty(spec["s"], dtype=dtype, device=device)
    t = torch.frombuffer(raw, dtype=dtype).reshape(spec["s"])
    if device.type != "cpu":
        return t.to(device)
    return t.clone() if t.data_ptr() % t.element_size() else t


def _dec(v, cur: _Cursor, device: torch.device):
    if isinstance(v, dict):
        t = v["!"]
        if t == "t":
            return _dec_tensor(v, cur, device)
        if t == "ct":
            return ColumnTable({c: _dec_tensor(s, cur, device)
                                for c, s in v["c"]})
        if t == "tu":
            return tuple(_dec(x, cur, device) for x in v["v"])
        if t == "li":
            return [_dec(x, cur, device) for x in v["v"]]
        if t == "di":
            return {_dec(k, cur, device): _dec(x, cur, device)
                    for k, x in v["v"]}
        raise TypeError(f"unknown wire tag {t!r}")
    return v


# ---------------------------------------------------------- PushPlan codec
def _rebuild_fn(code_b: bytes, module: str, name: str, defaults,
                closure_vals):
    """A (possibly lambda) function rebuilt from its marshalled code,
    bound to its defining module's globals on the receiving side (the
    worker imports the same port, so ``torch`` resolves)."""
    code = marshal.loads(code_b)
    try:
        g = importlib.import_module(module).__dict__
    except Exception:  # noqa: BLE001 - a torch-bearing scope instead
        g = {"torch": torch, "__builtins__": __builtins__}
    cells = None
    if closure_vals is not None:
        cells = tuple(types.CellType(v) for v in closure_vals)
    return types.FunctionType(code, g, name, defaults, cells)


class _PlanPickler(pickle.Pickler):
    """A pickler whose function reducer marshals ``__code__``: the
    ``derive`` entries of query plans are lambdas, which plain pickle
    refuses; Expr trees and the PushPlan dataclass pickle as usual."""

    def reducer_override(self, obj):
        if isinstance(obj, types.FunctionType):
            try:
                mod = importlib.import_module(obj.__module__)
                if getattr(mod, obj.__qualname__, None) is obj:
                    return NotImplemented  # importable by name: a global
                    #   reference (which also ends the recursion on
                    #   _rebuild_fn itself)
            except Exception:  # noqa: BLE001 - marshal it instead
                pass
            try:
                code = marshal.dumps(obj.__code__)
            except ValueError:
                return NotImplemented
            closure = None
            if obj.__closure__:
                vals = []
                for cell in obj.__closure__:
                    try:
                        vals.append(cell.cell_contents)
                    except ValueError:
                        vals.append(None)
                closure = tuple(vals)
            return (_rebuild_fn, (code, obj.__module__ or "builtins",
                                  obj.__name__, obj.__defaults__, closure))
        return NotImplemented


def encode_plan(plan) -> bytes:
    buf = io.BytesIO()
    _PlanPickler(buf, protocol=5).dump(plan)
    return buf.getvalue()


def decode_plan(spec: bytes):
    return pickle.loads(spec)


# ----------------------------------------------------------- worker process
def _worker_entry(sock: socket.socket, node_id: int, slots: int,
                  device: str) -> None:
    """The spawned worker's main: set up the device, say so in a start-up
    frame (or send the error and exit), then serve requests."""
    try:
        dev = resolve_device(device)
        torch.set_num_threads(max(1, slots))
        name = "cpu"
        if dev.type == "cuda":
            torch.zeros(1, device=dev)      # this process's CUDA context
            name = torch.cuda.get_device_name(dev)
            from repro_torch.kernels import _build
            _build.build_all()              # loads the pool's libraries
        hello = {"req": _HELLO, "ok": True, "pid": os.getpid(),
                 "device": str(dev), "name": name}
    except BaseException as e:  # noqa: BLE001 - sent to the parent
        try:
            _write_frame(sock, {"req": _HELLO, "ok": False,
                                "error": f"{type(e).__name__}: {e}"})
        finally:
            os._exit(1)
    _write_frame(sock, hello)
    _WorkerServer(sock, node_id, slots, dev).run()


class _WorkerServer:
    """One storage node: holds its partitions on its device, runs pushed
    plans on ``slots`` threads, serves raw projections, and stamps its
    load on every response."""

    def __init__(self, sock: socket.socket, node_id: int, slots: int,
                 device: torch.device):
        self.sock = sock
        self.node = node_id
        self.slots = max(1, slots)
        self.device = device
        self.parts: Dict[Tuple[str, int], ColumnTable] = {}
        self.versions: Dict[Tuple[str, int], int] = {}
        self.plans: Dict[str, CompiledPushPlan] = {}
        self.q: "queue.Queue" = queue.Queue()
        self.pending = {"exec": 0, "fetch": 0}
        self.inflight = 0
        self.done = 0
        self.die_after: Optional[int] = None
        self.lock = threading.Lock()
        self.wlock = threading.Lock()
        self.cpu0 = (time.process_time(), time.perf_counter())

    # ------------------------------------------------------------- protocol
    def run(self) -> None:  # pragma: no cover - runs in the worker process
        for _ in range(self.slots):
            threading.Thread(target=self._work, daemon=True).start()
        while True:
            try:
                header, body, _ = _read_frame(self.sock)
            except (EOFError, OSError):
                os._exit(0)
            kind = header["kind"]
            if kind == "shutdown":
                os._exit(0)
            elif kind == "load":
                self._install(header, body)
                self._reply({"req": header["req"], "ok": True})
            elif kind == "poll":
                self._reply({"req": header["req"], "ok": True})
            elif kind == "die_after":
                with self.lock:
                    self.die_after = int(header["n"])
                self._reply({"req": header["req"], "ok": True})
            elif kind == "burn":
                for _ in range(int(header.get("tasks", 1))):
                    with self.lock:
                        self.pending["exec"] += 1
                    self.q.put(({"kind": "burn", "req": None,
                                 "seconds": header["seconds"]}, b""))
                self._reply({"req": header["req"], "ok": True})
            else:                       # exec | fetch: the work queue
                with self.lock:
                    self.pending["exec" if kind == "exec" else "fetch"] += 1
                self.q.put((header, body))

    def _work(self) -> None:  # pragma: no cover - worker process threads
        while True:
            header, body = self.q.get()
            kind = header["kind"]
            with self.lock:
                if self.die_after is not None and self.done >= self.die_after:
                    # the pinned kill schedule: die with this request (and
                    # any queued behind it) in flight
                    os.kill(os.getpid(), signal.SIGKILL)
                self.pending["exec" if kind in ("exec", "burn")
                             else "fetch"] -= 1
                self.inflight += 1
            spans = None
            bufs: List = []
            try:
                if kind == "burn":
                    end = time.perf_counter() + float(header["seconds"])
                    x = 1.0
                    while time.perf_counter() < end:
                        x = x * 1.0000001 + 1.0   # real CPU occupancy
                    resp: Dict = {}
                elif kind == "exec":
                    resp, bufs, spans = self._exec(header, body)
                else:
                    resp, bufs, spans = self._fetch(header, body)
                hdr = dict(resp, req=header["req"], ok=True)
            except BaseException as e:  # noqa: BLE001 - sent to the parent
                hdr = {"req": header["req"], "ok": False,
                       "error": f"{type(e).__name__}: {e}"}
                bufs = []
            with self.lock:
                self.inflight -= 1
                self.done += 1
            if spans:
                hdr["spans"] = spans
            if hdr["req"] is not None:
                self._reply(hdr, bufs)

    def _reply(self, header: Dict, body=b"") -> None:
        header["load"] = self._load_snapshot()
        with self.wlock:
            try:
                _write_frame(self.sock, header, body)
            except OSError:   # the parent is gone: nothing left to serve
                os._exit(0)

    # ------------------------------------------------------------- handlers
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _install(self, header: Dict, body) -> None:
        cur = _Cursor(body)
        cols = {}
        for c, spec in header["cols"]:
            t = _dec_tensor(spec, cur, self.device)
            # own the bytes: a host view would pin the whole frame
            cols[c] = t.clone() if self.device.type == "cpu" else t
        key = (header["table"], int(header["index"]))
        self.parts[key] = ColumnTable(cols)
        self.versions[key] = int(header["version"])

    def _compiled(self, header: Dict, cur: _Cursor) -> CompiledPushPlan:
        key = header["plan_key"]
        if "plan" in header:
            spec = bytes(cur.take(header["plan"]))
            if key not in self.plans:
                self.plans[key] = compile_push_plan(decode_plan(spec))
        return self.plans[key]

    def _tabs(self, header: Dict) -> List[ColumnTable]:
        out = []
        for (table, index), ver in zip(header["parts"], header["versions"]):
            key = (table, int(index))
            if self.versions.get(key) != int(ver):
                raise RuntimeError(
                    f"stale partition {key}: worker holds "
                    f"v{self.versions.get(key)}, request wants v{ver}")
            out.append(self.parts[key])
        return out

    def _exec(self, header: Dict, body) -> Tuple[Dict, List, List]:
        cur = _Cursor(body)
        cplan = self._compiled(header, cur)
        bms = (_dec(header["bms"], cur, self.device) if "bms" in header
               else None)
        tabs = self._tabs(header)
        t0 = time.perf_counter()
        if header["executor"] == EXECUTOR_REFERENCE:
            out = [execute_push_plan(cplan.plan, t,
                                     None if bms is None else bms[i])
                   for i, t in enumerate(tabs)]
        else:
            parts_res, aux = cplan.execute_batch_parts(tabs, bms)
            out = list(zip(parts_res, aux))
        self._sync()
        dur = time.perf_counter() - t0
        bufs: List = []
        vals = _enc([[res, aux] for res, aux in out], bufs)
        spans = self._spans(header, "worker_execute", dur, tabs, out)
        return {"vals": vals}, bufs, spans

    def _fetch(self, header: Dict, body) -> Tuple[Dict, List, List]:
        cur = _Cursor(body)
        cplan = self._compiled(header, cur)
        tabs = self._tabs(header)
        t0 = time.perf_counter()
        projs = [cplan.raw_projection(t) for t in tabs]
        self._sync()
        dur = time.perf_counter() - t0
        bufs: List = []
        vals = _enc(projs, bufs)
        spans = self._spans(header, "worker_fetch", dur, tabs, None)
        return {"vals": vals}, bufs, spans

    def _spans(self, header: Dict, name: str, dur: float, tabs,
               out) -> Optional[List[Dict]]:
        if not header.get("trace"):
            return None
        attrs = {"node": self.node, "pid": os.getpid(),
                 "table": header["parts"][0][0], "n_parts": len(tabs)}
        if out is not None:
            attrs["rows_out"] = int(sum(len(res) for res, _ in out))
        return [{"name": name, "t0": 0.0, "dur": dur,
                 "remote_parent": header.get("span"), "attrs": attrs}]

    def _load_snapshot(self) -> Dict:
        with self.lock:
            snap = {"exec_q": self.pending["exec"],
                    "ship_q": self.pending["fetch"],
                    "inflight": self.inflight, "done": self.done}
        cpu_t, wall_t = time.process_time(), time.perf_counter()
        dcpu = cpu_t - self.cpu0[0]
        dwall = wall_t - self.cpu0[1]
        if dwall > 1e-3:
            self.cpu0 = (cpu_t, wall_t)
            snap["cpu"] = round(min(1.0, dcpu / (dwall * self.slots)), 4)
        else:
            snap["cpu"] = None
        # this worker's kernel launches since it started (the parent's
        # kernels.launches() cannot see them); feeds no gauge
        snap["launches"] = kernels.launches()
        return snap


# ----------------------------------------------------------- parent channel
class WorkerChannel:
    """The parent's end of one worker's socketpair: the spawned process, a
    writer lock, a reader thread resolving per-request futures, and the
    :class:`core.faults.WorkerFault` of a dead or overdue channel."""

    def __init__(self, node_id: int, slots: int, device: torch.device,
                 timeout_s: Optional[float] = None):
        self.node = node_id
        self.device = device
        self.timeout_s = timeout_s
        parent_sock, child_sock = socket.socketpair()
        ctx = multiprocessing.get_context("spawn")
        self.proc = ctx.Process(target=_worker_entry,
                                args=(child_sock, node_id, slots,
                                      str(device)),
                                name=f"storage-worker-{node_id}",
                                daemon=True)
        self._hello: Future = Future()
        self._pending: Dict[int, Future] = {_HELLO: self._hello}
        self._plock = threading.Lock()
        self._wlock = threading.Lock()
        self._rid = itertools.count()
        self.dead: Optional[str] = None        # fault kind once failed
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.last_load: Optional[Dict] = None
        self.proc.start()
        child_sock.close()
        self.sock = parent_sock
        threading.Thread(target=self._read_loop, daemon=True).start()

    def started(self) -> Dict:
        """Wait for the worker's start-up frame: ``{"pid", "device",
        "name"}``. Raises ``RuntimeError`` with the worker's own error
        when it could not start (no CUDA, a kernel library that does not
        load), or when it sent nothing within ``START_TIMEOUT_S``."""
        try:
            header, _ = self._hello.result(timeout=START_TIMEOUT_S)
        except FutTimeout:
            raise RuntimeError(f"storage worker {self.node} did not start "
                               f"within {START_TIMEOUT_S} s") from None
        except (RuntimeError, _faults.WorkerFault) as e:
            raise RuntimeError(f"storage worker {self.node} could not start "
                               f"on {self.device}: {e}") from e
        return {k: header[k] for k in ("pid", "device", "name")}

    def _read_loop(self) -> None:
        try:
            while True:
                header, body, n = _read_frame(self.sock)
                self.bytes_recv += n
                self.last_load = header.get("load") or self.last_load
                with self._plock:
                    fut = self._pending.pop(header["req"], None)
                if fut is None:
                    continue
                if header.get("ok"):
                    fut.set_result((header, body))
                else:
                    fut.set_exception(RuntimeError(
                        f"worker {self.node} remote error: "
                        f"{header.get('error')}"))
        except (EOFError, OSError):
            self._fail(_faults.FAULT_CRASH)

    def _fail(self, kind: str) -> None:
        self.dead = kind
        with self._plock:
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            fut.set_exception(_faults.WorkerFault(
                kind, self.node, "channel closed mid-request"))

    def request(self, header: Dict, body=b"",
                timeout: Optional[float] = None) -> Tuple[Dict, memoryview]:
        if self.dead is not None:
            raise _faults.WorkerFault(self.dead, self.node, "worker dead")
        rid = next(self._rid)
        header["req"] = rid
        fut: Future = Future()
        with self._plock:
            self._pending[rid] = fut
        try:
            with self._wlock:
                self.bytes_sent += _write_frame(self.sock, header, body)
        except OSError as e:
            with self._plock:
                self._pending.pop(rid, None)
            raise _faults.WorkerFault(_faults.FAULT_CRASH, self.node,
                                      f"send failed: {e}")
        wait = timeout if timeout is not None else self.timeout_s
        try:
            return fut.result(timeout=wait)
        except FutTimeout:
            with self._plock:
                self._pending.pop(rid, None)
            raise _faults.WorkerFault(_faults.FAULT_TIMEOUT, self.node,
                                      f"request overdue ({wait}s)")

    def post(self, header: Dict) -> None:
        """Fire and forget (shutdown): no future, failures ignored."""
        header["req"] = None
        try:
            with self._wlock:
                _write_frame(self.sock, header)
        except OSError:
            pass

    def close(self) -> None:
        self.post({"kind": "shutdown"})
        self.proc.join(timeout=5.0)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=5.0)
        try:
            self.sock.close()
        except OSError:
            pass


# --------------------------------------------------------------- the pool
class WorkerPool:
    """One storage-worker process per catalog node, on the catalog's
    device.

    Construction builds the kernel libraries (on CUDA), spawns every
    worker, waits for each to start, and ships each node's partitions
    over the wire, the nodes in parallel. ``execute_group`` and
    ``fetch_projection`` are the two entry points ``core.runtime``
    dispatches through; both re-ship a partition whose catalog version
    moved since its last ship, publish the worker's load into the
    ``stream.*`` gauges, and raise a channel failure as
    :class:`core.faults.WorkerFault` after adding it to the pool's
    real-fault ledger (:attr:`events`). ``workers`` maps each node to its
    worker's pid and device; ``start_s`` and ``ship_s`` are the seconds
    the construction took to start the workers and to ship the
    partitions."""

    def __init__(self, catalog, pd_slots: int = 2,
                 request_timeout_s: Optional[float] = None):
        self.catalog = catalog
        self.device = catalog.device
        self.nodes = [n.node_id for n in catalog.nodes]
        self._shipped_ver: Dict[int, Dict[Tuple[str, int], int]] = \
            {n: {} for n in self.nodes}
        self._shipped_plans: Dict[int, set] = {n: set() for n in self.nodes}
        self._plan_specs: Dict[int, Tuple[str, bytes, object]] = {}
        self._plock = threading.Lock()
        self.events: List[Dict] = []       # real-fault ledger
        self._elock = threading.Lock()
        self.channels: Dict[int, WorkerChannel] = {}
        self.closed = False
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build_all()   # before spawning: no request pays the build
        try:
            t0 = time.perf_counter()
            for n in self.nodes:
                self.channels[n] = WorkerChannel(n, pd_slots, self.device,
                                                 request_timeout_s)
            self.workers = {n: ch.started()
                            for n, ch in self.channels.items()}
            t1 = time.perf_counter()
            with ThreadPoolExecutor(len(self.nodes)) as ex:
                for f in [ex.submit(self._ship_node, n)
                          for n in self.nodes]:
                    f.result()
            # seconds until every worker had started, then to ship them
            self.start_s, self.ship_s = t1 - t0, time.perf_counter() - t1
        except BaseException:
            self.close()
            raise

    # --------------------------------------------------------- partitions
    def _ship_node(self, node: int) -> None:
        """Ship a node's partitions at construction, without the request
        deadline (setting up is not a request on the query path)."""
        for part in self.catalog.nodes[node].partitions:
            self._ship_partition(node, part, START_TIMEOUT_S)

    def _ship_partition(self, node: int, part,
                        timeout: Optional[float] = None) -> None:
        data = part.data
        bufs: List = []
        cols = [[c, _enc_tensor(data.cols[c], bufs)] for c in data.columns]
        self.channels[node].request(
            {"kind": "load", "table": part.table, "index": part.index,
             "version": part.version, "cols": cols}, bufs, timeout=timeout)
        self._shipped_ver[node][(part.table, part.index)] = part.version

    def _refresh_parts(self, node: int, sub) -> None:
        shipped = self._shipped_ver[node]
        for r in sub:
            if shipped.get((r.table, r.part.index)) != r.part.version:
                self._ship_partition(node, r.part)

    # -------------------------------------------------------------- plans
    def _plan_ref(self, node: int, plan) -> Tuple[str, Optional[bytes]]:
        pid = id(plan)
        with self._plock:
            ent = self._plan_specs.get(pid)
            if ent is None:
                spec = encode_plan(plan)
                key = hashlib.blake2b(spec, digest_size=8).hexdigest()
                # the plan rides along so that id(plan) stays its own
                ent = self._plan_specs[pid] = (key, spec, plan)
            key, spec, _ = ent
            if key in self._shipped_plans[node]:
                return key, None
            return key, spec

    def _request(self, node: int, header: Dict, spec: Optional[bytes],
                 bufs: List, parent) -> Tuple[Dict, memoryview, float]:
        tr = obs_trace.get_tracer()
        if tr.enabled:
            header["trace"] = True
            header["span"] = parent.sid if parent is not None else None
        t_send = time.perf_counter()
        rh, rb = self.channels[node].request(
            header, ([spec] if spec is not None else []) + bufs)
        if spec is not None:
            self._shipped_plans[node].add(header["plan_key"])
        self._publish(node, rh.get("load"))
        self._adopt(tr, rh.get("spans"), parent, t_send)
        return rh, rb, t_send

    # ------------------------------------------------------- tier entries
    def execute_group(self, cplan: CompiledPushPlan, sub, executor: str,
                      bitmaps: Optional[Dict[int, torch.Tensor]] = None,
                      parent: Optional[obs_trace.Span] = None
                      ) -> List[Tuple[ColumnTable, Dict]]:
        """Run one pushdown group on its node's worker and decode the
        per-partition ``(result, aux)`` pairs onto the pool's device: the
        in-process executor's results for the same decision vector."""
        node = sub[0].part.node_id
        try:
            self._refresh_parts(node, sub)
            key, spec = self._plan_ref(node, cplan.plan)
            header: Dict = {"kind": "exec", "plan_key": key,
                            "executor": executor,
                            "parts": [[r.table, r.part.index] for r in sub],
                            "versions": [r.part.version for r in sub]}
            if spec is not None:
                header["plan"] = len(spec)
            bufs: List = []
            if bitmaps:
                header["bms"] = _enc([bitmaps[r.req_id] for r in sub], bufs)
            rh, rb, _ = self._request(node, header, spec, bufs, parent)
            out = [(res, aux) for res, aux in
                   _dec(rh["vals"], _Cursor(rb), self.device)]
            get_metrics().counter("wire.pushdown_result_bytes").inc(len(rb))
            return out
        except _faults.WorkerFault as wf:
            self._record_fault(wf, table=sub[0].table, op="exec")
            raise

    def fetch_projection(self, cplan: CompiledPushPlan, sub,
                         parent: Optional[obs_trace.Span] = None
                         ) -> List[ColumnTable]:
        """The pushback transfer: the worker serializes each partition's
        raw accessed-column projection, and the compute side replays the
        compiled plan over these decoded tables."""
        node = sub[0].part.node_id
        try:
            self._refresh_parts(node, sub)
            key, spec = self._plan_ref(node, cplan.plan)
            header: Dict = {"kind": "fetch", "plan_key": key,
                            "parts": [[r.table, r.part.index] for r in sub],
                            "versions": [r.part.version for r in sub]}
            if spec is not None:
                header["plan"] = len(spec)
            rh, rb, _ = self._request(node, header, spec, [], parent)
            tabs = _dec(rh["vals"], _Cursor(rb), self.device)
            get_metrics().counter("wire.pushback_ship_bytes").inc(len(rb))
            return tabs
        except _faults.WorkerFault as wf:
            self._record_fault(wf, table=sub[0].table, op="fetch")
            raise

    # ----------------------------------------------------------- signals
    def _publish(self, node: int, load: Optional[Dict]) -> None:
        if not load:
            return
        m = get_metrics()
        m.gauge(f"stream.node{node}.exec_queue").set(load["exec_q"])
        m.gauge(f"stream.node{node}.ship_queue").set(load["ship_q"])
        m.gauge(f"storage.node{node}.inflight").set(load["inflight"])
        if load.get("cpu") is not None:
            m.gauge(f"storage.node{node}.cpu").set(load["cpu"])

    def publish_load(self) -> Dict[int, Optional[Dict]]:
        """Poll every live worker and publish its queue depths, in-flight
        count and CPU occupancy into the gauges ``MeasuredLoad`` reads
        (``stream.node<N>.exec_queue``/``ship_queue``, and the
        ``storage.node<N>.*`` extras). Each snapshot also carries the
        worker's kernel launches so far (``"launches"``). A dead worker
        keeps its last published value and maps to None: the breaker,
        not the gauge, routes around it."""
        out: Dict[int, Optional[Dict]] = {}
        for node, ch in self.channels.items():
            try:
                rh, _ = ch.request({"kind": "poll"})
                self._publish(node, rh.get("load"))
                out[node] = rh.get("load")
            except _faults.WorkerFault:
                out[node] = None
        return out

    def _adopt(self, tr, recs, parent, t_send: float) -> None:
        """Stitch worker span records into the compute-side trace: each
        becomes a span under the dispatching span, its clock mapped onto
        the send time (the worker reports t0 from its own start of
        handling)."""
        if not recs or not tr.enabled:
            return
        base = t_send - tr.t0
        for rec in recs:
            sp = tr.start(rec["name"], cat="worker", parent=parent,
                          **rec.get("attrs", {}))
            if sp is obs_trace.NULL_SPAN:
                continue
            sp.attrs["remote_parent"] = rec.get("remote_parent")
            sp.t0 = base + float(rec.get("t0") or 0.0)
            tr.end(sp)
            sp.dur = float(rec.get("dur") or 0.0)
            tr.amend(sp)   # re-emit: a streaming sink saw the wrong dur

    def _record_fault(self, wf: "_faults.WorkerFault", table: str,
                      op: str) -> None:
        with self._elock:
            self.events.append({"kind": wf.kind, "node": wf.node,
                                "table": table, "op": op})

    def fault_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with self._elock:
            for ev in self.events:
                out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out

    # ----------------------------------------------------- chaos controls
    def kill(self, node: int) -> None:
        """SIGKILL one worker process."""
        self.channels[node].proc.kill()

    def die_after(self, node: int, n: int) -> None:
        """Pinned kill schedule: the worker SIGKILLs itself as it is about
        to start work item ``n + 1`` (deterministic by count, mid-wave)."""
        self.channels[node].request({"kind": "die_after", "n": n})

    def burn(self, node: int, seconds: float, tasks: int = 1) -> None:
        """Occupy ``tasks`` work items of one worker with ``seconds`` of
        real CPU each: storage-side pressure the gauges show."""
        self.channels[node].request({"kind": "burn", "seconds": seconds,
                                     "tasks": tasks})

    def wire_bytes(self) -> Dict[str, int]:
        return {"sent": sum(ch.bytes_sent for ch in self.channels.values()),
                "recv": sum(ch.bytes_recv for ch in self.channels.values())}

    def alive(self, node: int) -> bool:
        return self.channels[node].dead is None \
            and self.channels[node].proc.is_alive()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for ch in self.channels.values():
            ch.close()


# ------------------------------------------------------------ pool registry
_POOLS: Dict[int, Tuple[object, WorkerPool]] = {}
_POOLS_LOCK = threading.Lock()


def pool_for(catalog, pd_slots: int = 2) -> WorkerPool:
    """The process-wide pool of ``catalog``, made at first use (the
    registry pins the catalog, so ``id()`` keys stay unambiguous). Engine
    configs with ``storage_tier="process"`` and no ``worker_pool`` route
    here."""
    with _POOLS_LOCK:
        ent = _POOLS.get(id(catalog))
        if ent is not None and not ent[1].closed:
            return ent[1]
        pool = WorkerPool(catalog, pd_slots=pd_slots)
        _POOLS[id(catalog)] = (catalog, pool)
        return pool


def close_all_pools() -> None:
    with _POOLS_LOCK:
        pools = [p for _, p in _POOLS.values()]
        _POOLS.clear()
    for p in pools:
        p.close()


atexit.register(close_all_pools)
