"""Cross-process span tracing on shared-memory event rings.

Design (mirrors the data path's own disciplines so tracing cannot distort
what it measures):

- **One ring per writing thread**, lazily created on first emit, backed by
  a :class:`~repro_torch.ipc.shm.SharedMemoryArena` — the same single-writer
  atomic-store discipline as the IPC rings, so emitting a span is a
  ``struct.pack_into`` + one aligned int64 cursor store: no locks, no
  allocation, no pickling.
- **Fixed 32-byte binary records**: ``u32 kind | u32 arg | u64 t0 |
  u64 t1 | u64 rid`` with ``t0``/``t1`` from ``time.perf_counter_ns()``
  (CLOCK_MONOTONIC on Linux — one timebase for every process on the
  host, so records join across processes without clock translation).
- **Wraparound overwrites the oldest record** and the monotonic cursor
  makes the loss *counted*: ``drops = max(0, cursor - capacity)``.
- **Discovery without IPC**: rings are named
  ``rt-<session>-<pid>-<seq>``; spawned children inherit the session id
  through the environment (`ROCKET_TRACE`/`ROCKET_TRACE_SESSION`), and
  the collector lists ``/dev/shm`` by prefix and maps every ring
  read-only.  Rings are unregistered from the stdlib resource tracker at
  creation so a child's rings *survive its exit* for post-mortem
  collection; the collector (or :func:`disable`) owns the unlink.
- **Disabled means zero**: with tracing off (the default) instrumented
  code performs one attribute check and writes nothing — no ring is ever
  created, and :func:`emitted_count` returning 0 is CI-gated.

The request id (:func:`mint_rid`) is ``pid << 32 | seq`` — unique across
processes without coordination — and rides the existing binary wire meta
under the reserved header key :data:`RID_KEY`, so one request's client
send, reactor drain, gather, handler, and reply spans share a join key.

Copied from ``src/repro/obs/trace.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# -- record layout ----------------------------------------------------------
RECORD_DTYPE = np.dtype([("kind", "<u4"), ("arg", "<u4"),
                         ("t0", "<u8"), ("t1", "<u8"), ("rid", "<u8")])
RECORD_BYTES = RECORD_DTYPE.itemsize            # 32
_RECORD_FMT = "<IIQQQ"                          # kind, arg, t0, t1, rid
assert struct.calcsize(_RECORD_FMT) == RECORD_BYTES

# ring control words (see SharedMemoryArena.control_words)
_W_CURSOR, _W_CAPACITY, _W_PID, _W_TID = 0, 1, 2, 3

ENV_FLAG = "ROCKET_TRACE"
ENV_SESSION = "ROCKET_TRACE_SESSION"
ENV_CAPACITY = "ROCKET_TRACE_CAPACITY"
_PREFIX = "rt"
_SHM_DIR = "/dev/shm"
DEFAULT_CAPACITY = 1 << 14                      # records/ring (512 KB)

# reserved wire-meta header key carrying the request id (the same
# pop-on-arrival idiom as channel.py's heap extent key); only ever added
# while tracing is enabled, so disabled wire bytes are unchanged
RID_KEY = "__rocket_rid__"

# -- span kinds -------------------------------------------------------------
CLIENT_SEND = 1        # RemoteDispatcherClient.request: send on the wire
CLIENT_RECV = 2        # reply decoded client-side (instant)
QUERY_WAIT = 3         # RemoteDispatcherClient.query: wait for completion
CH_SEND = 4            # DataChannel.send wall time (any route)
CH_PUBLISH = 5         # slot claim→publish→doorbell inside _publish
RING_WAIT = 6          # ring slow path: blocked on a slot state flip
REACTOR_DRAIN = 7      # one batched drain pull (recv_many + handoff)
DISPATCH_WAIT = 8      # dispatcher batch window: first request → batch closed
GATHER = 9             # SG gather of leased views into the batch slab
LEASE_HOLD = 10        # zero-copy lease lifetime: delivery → release
HANDLER = 11           # handler/model execution for one batch
REPLY_FILL = 12        # reply reserve-then-fill on the client's transport
GOV_DECIDE = 13        # governor route decision
GOV_OBSERVE = 14       # governor cost observation (instant)
COPY_JOB = 15          # one CopyEngine SG descriptor's memcpy loop
SERVE_BATCH = 16       # BatchedServer.generate_batch (prefill+decode)

KIND_NAMES = {
    CLIENT_SEND: "client.send",
    CLIENT_RECV: "client.recv",
    QUERY_WAIT: "client.query_wait",
    CH_SEND: "channel.send",
    CH_PUBLISH: "channel.publish",
    RING_WAIT: "ring.wait",
    REACTOR_DRAIN: "reactor.drain",
    DISPATCH_WAIT: "dispatcher.batch_wait",
    GATHER: "dispatcher.gather",
    LEASE_HOLD: "lease.hold",
    HANDLER: "dispatcher.handler",
    REPLY_FILL: "reactor.reply_fill",
    GOV_DECIDE: "governor.decide",
    GOV_OBSERVE: "governor.observe",
    COPY_JOB: "copyengine.copy",
    SERVE_BATCH: "serve.generate_batch",
}

# Counter records (the hardware-witness plane, obs/hwcounters.py) share
# the rings and record layout but carry a *counter delta*, not a wall
# interval: duration ``t1 - t0`` is the delta, ``arg`` is the span kind
# of the phase the delta belongs to.  Kinds ≥ CTR_FIRST are therefore
# excluded from wall-time phase totals/histograms.
CTR_FIRST = 32
CTR_KINDS = {
    "instructions": 32,
    "cycles": 33,
    "llc_loads": 34,
    "llc_misses": 35,
    "task_clock_ns": 36,
    "ctx_sw": 37,
    "page_faults": 38,
    "sched_wait_ns": 39,
}
KIND_NAMES.update({v: f"ctr.{k}" for k, v in CTR_KINDS.items()})


class _State:
    """Process-wide tracing switch; ``TRACE.enabled`` is THE hot-path guard."""
    __slots__ = ("enabled", "session", "capacity")

    def __init__(self):
        self.enabled = os.environ.get(ENV_FLAG) == "1"
        self.session = os.environ.get(ENV_SESSION, "")
        self.capacity = int(os.environ.get(ENV_CAPACITY, DEFAULT_CAPACITY))


TRACE = _State()

now = time.perf_counter_ns

_rid_seq = itertools.count(1)
_ring_seq = itertools.count()
_tls = threading.local()
_rings_lock = threading.Lock()
_rings: list["_TraceRing"] = []                 # rings created by THIS process


def mint_rid() -> int:
    """A u64 request id unique across processes: ``pid << 32 | seq``."""
    return ((os.getpid() & 0xFFFFFFFF) << 32) | (next(_rid_seq) & 0xFFFFFFFF)


def _untrack(shm) -> None:
    """Stop the resource tracker auto-unlinking this segment at process
    exit — a spawned child's rings must outlive it for collection; the
    collector (or :func:`disable`) owns the unlink instead."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _unlink_quiet(name: str) -> None:
    """Destroy a ring segment by name without touching the resource
    tracker (every handle was unregistered at open, so the stdlib
    ``SharedMemory.unlink`` — which also unregisters — would unbalance
    the tracker's ledger and make it print KeyErrors at exit)."""
    try:
        import _posixshmem
        _posixshmem.shm_unlink(name if name.startswith("/") else "/" + name)
    except FileNotFoundError:
        pass
    except ImportError:                  # pragma: no cover - non-POSIX
        try:
            from multiprocessing import shared_memory
            seg = shared_memory.SharedMemory(name, create=False)
            seg.close()
            seg.unlink()
        except FileNotFoundError:
            pass


class _TraceRing:
    """One thread's single-writer span ring in shared memory."""

    def __init__(self, arena, capacity: int):
        self._arena = arena
        self._words = arena.control_words()
        self._buf = arena.view(0, capacity * RECORD_BYTES)
        self._capacity = capacity
        self._cursor = int(self._words[_W_CURSOR])
        self.session = TRACE.session
        self.closed = False

    @classmethod
    def create(cls, name: str, capacity: int) -> "_TraceRing":
        """Mint a ring segment (creator side; detached from the tracker)."""
        from repro_torch.ipc.shm import SharedMemoryArena  # runtime import: obs
        # must not import repro_torch.ipc at module load (ipc imports obs.trace)
        arena = SharedMemoryArena(name, size=capacity * RECORD_BYTES,
                                  create=True)
        _untrack(arena._shm)
        words = arena.control_words()
        words[_W_CAPACITY] = capacity
        words[_W_PID] = os.getpid()
        words[_W_TID] = threading.get_ident() & 0x7FFFFFFF
        return cls(arena, capacity)

    def write(self, kind: int, t0: int, t1: int, rid: int, arg: int) -> None:
        """Append one record: pack in place, then one cursor store."""
        struct.pack_into(_RECORD_FMT, self._buf,
                         (self._cursor % self._capacity) * RECORD_BYTES,
                         kind & 0xFFFFFFFF, arg & 0xFFFFFFFF,
                         t0, t1, rid & 0xFFFFFFFFFFFFFFFF)
        self._cursor += 1
        self._words[_W_CURSOR] = self._cursor   # single aligned int64 store

    @property
    def cursor(self) -> int:
        """Monotonic records-written count (drops = cursor - capacity)."""
        return self._cursor

    @property
    def drops(self) -> int:
        """Records overwritten by wraparound (counted, never silent)."""
        return max(0, self._cursor - self._capacity)

    def close(self, unlink: bool = True) -> None:
        """Unmap (and by default destroy) this ring's segment."""
        if self.closed:
            return
        self.closed = True
        self._buf = None
        self._words = None
        self._arena.close()
        if unlink:
            _unlink_quiet(self._arena.name)


def _ring() -> _TraceRing:
    """This thread's ring for the current session (lazily created)."""
    r = getattr(_tls, "ring", None)
    if r is None or r.closed or r.session != TRACE.session:
        name = (f"{_PREFIX}-{TRACE.session}-{os.getpid()}"
                f"-{next(_ring_seq)}")
        r = _TraceRing.create(name, TRACE.capacity)
        _tls.ring = r
        with _rings_lock:
            _rings.append(r)
    return r


# -- emit API ---------------------------------------------------------------

def emit(kind: int, t0: int, rid: int = 0, arg: int = 0,
         t1: Optional[int] = None) -> None:
    """Record one span ``[t0, t1]`` (``t1`` defaults to now). No-op when
    tracing is disabled — callers pre-guard with ``TRACE.enabled`` so the
    disabled cost stays one attribute check."""
    if not TRACE.enabled:
        return
    _ring().write(kind, t0, now() if t1 is None else t1, rid, arg)


def instant(kind: int, rid: int = 0, arg: int = 0) -> None:
    """Record a zero-duration event at the current time."""
    if not TRACE.enabled:
        return
    t = now()
    _ring().write(kind, t, t, rid, arg)


class _Span:
    """Context manager emitting one span on exit (cold paths and tests;
    hot paths inline the guard + :func:`emit` instead)."""
    __slots__ = ("kind", "rid", "arg", "_t0")

    def __init__(self, kind: int, rid: int = 0, arg: int = 0):
        self.kind, self.rid, self.arg = kind, rid, arg
        self._t0 = 0

    def __enter__(self):
        if TRACE.enabled:
            self._t0 = now()
        return self

    def __exit__(self, *exc):
        if TRACE.enabled and self._t0:
            emit(self.kind, self._t0, self.rid, self.arg)
        return False


def span(kind: int, rid: int = 0, arg: int = 0) -> _Span:
    """``with span(KIND, rid): ...`` — convenience span recorder."""
    return _Span(kind, rid, arg)


# -- lifecycle --------------------------------------------------------------

def enable(capacity: Optional[int] = None,
           session: Optional[str] = None) -> str:
    """Turn tracing on process-wide and return the session id.

    The flag, session id, and ring capacity are exported through the
    environment so processes spawned *after* this call inherit them and
    trace into the same session without any further coordination.
    """
    session = session or f"{os.getpid():x}{time.monotonic_ns() & 0xFFFFFF:x}"
    capacity = capacity or TRACE.capacity or DEFAULT_CAPACITY
    os.environ[ENV_FLAG] = "1"
    os.environ[ENV_SESSION] = session
    os.environ[ENV_CAPACITY] = str(capacity)
    TRACE.session = session
    TRACE.capacity = capacity
    TRACE.enabled = True
    return session


def disable(unlink: bool = True) -> None:
    """Turn tracing off and release this process's rings (idempotent)."""
    TRACE.enabled = False
    os.environ.pop(ENV_FLAG, None)
    os.environ.pop(ENV_SESSION, None)
    os.environ.pop(ENV_CAPACITY, None)
    with _rings_lock:
        rings, _rings[:] = list(_rings), []
    for r in rings:
        try:
            r.close(unlink=unlink)
        except Exception:
            pass


def _close_local_rings() -> None:
    """atexit: unmap this process's rings WITHOUT unlinking them — the
    records must survive for the collector, but leaving live memoryview
    exports to interpreter teardown makes ``SharedMemory.__del__`` print
    ignored BufferErrors in every traced child."""
    with _rings_lock:
        rings, _rings[:] = list(_rings), []
    for r in rings:
        try:
            r.close(unlink=False)
        except Exception:
            pass


atexit.register(_close_local_rings)


def emitted_count() -> int:
    """Records written by THIS process (0 when tracing never ran — the
    counted gate behind "tracing disabled writes exactly 0 records")."""
    with _rings_lock:
        return sum(r.cursor for r in _rings)


def dropped_count() -> int:
    """Records lost to wraparound in this process's rings."""
    with _rings_lock:
        return sum(r.drops for r in _rings)


# -- collection -------------------------------------------------------------

@dataclass
class RingDump:
    """One collected ring: identity, loss accounting, and its records."""
    name: str
    pid: int
    tid: int
    drops: int
    records: np.ndarray                 # RECORD_DTYPE, oldest → newest


@dataclass
class TraceView:
    """Every collected ring of a session, with join/export helpers."""
    rings: list = field(default_factory=list)

    @property
    def total_records(self) -> int:
        """Records actually collected across all rings."""
        return sum(len(r.records) for r in self.rings)

    @property
    def total_drops(self) -> int:
        """Records lost to ring wraparound across all rings."""
        return sum(r.drops for r in self.rings)

    @property
    def pids(self) -> set:
        """Distinct writer processes seen in this view."""
        return {r.pid for r in self.rings}

    def records_of(self, kind: int) -> np.ndarray:
        """All records of one span kind, merged across rings."""
        parts = [r.records[r.records["kind"] == kind] for r in self.rings]
        parts = [p for p in parts if len(p)]
        if not parts:
            return np.empty(0, RECORD_DTYPE)
        return np.concatenate(parts)

    def durations_ns(self, kind: int) -> np.ndarray:
        """``t1 - t0`` (ns) for every span of one kind."""
        recs = self.records_of(kind)
        return (recs["t1"] - recs["t0"]).astype(np.int64)

    def kinds_for_rid(self, rid: int) -> dict:
        """kind → (pid, t0, t1) spans carrying this request id."""
        out = {}
        for r in self.rings:
            hit = r.records[r.records["rid"] == rid]
            for rec in hit:
                out.setdefault(int(rec["kind"]), []).append(
                    (r.pid, int(rec["t0"]), int(rec["t1"])))
        return out

    def phase_totals(self) -> dict:
        """kind name → ``(count, total_ns)`` across the whole view.

        Wall-time spans only — counter records (kinds ≥ ``CTR_FIRST``,
        whose "duration" is a counter delta) are excluded; reduce those
        with :func:`repro_torch.obs.hwcounters.counters_from_view`."""
        out = {}
        for kind, name in KIND_NAMES.items():
            if kind >= CTR_FIRST:
                continue
            d = self.durations_ns(kind)
            if len(d):
                out[name] = (int(len(d)), int(d.sum()))
        return out

    def chrome_events(self) -> list:
        """Chrome-trace ``X`` (complete) events, one per record."""
        events = []
        for r in self.rings:
            for rec in r.records:
                kind = int(rec["kind"])
                if kind >= CTR_FIRST:
                    # counter record: the "duration" is a counter delta —
                    # render as a zero-width instant carrying the value
                    events.append({
                        "name": KIND_NAMES.get(kind, f"kind{kind}"),
                        "cat": "hwctr", "ph": "i", "s": "t",
                        "pid": r.pid, "tid": r.tid,
                        "ts": int(rec["t0"]) / 1e3,      # µs
                        "args": {"rid": int(rec["rid"]),
                                 "phase_kind": int(rec["arg"]),
                                 "delta": int(rec["t1"]) - int(rec["t0"])},
                    })
                    continue
                events.append({
                    "name": KIND_NAMES.get(kind, f"kind{kind}"),
                    "cat": "rocket", "ph": "X",
                    "pid": r.pid, "tid": r.tid,
                    "ts": int(rec["t0"]) / 1e3,          # µs
                    "dur": max(int(rec["t1"]) - int(rec["t0"]), 0) / 1e3,
                    "args": {"rid": int(rec["rid"]), "arg": int(rec["arg"])},
                })
        events.sort(key=lambda e: e["ts"])
        return events

    def chrome_trace(self) -> dict:
        """The full Chrome/Perfetto trace object (``traceEvents`` form)."""
        return {"traceEvents": self.chrome_events(),
                "displayTimeUnit": "ms",
                "otherData": {"drops": self.total_drops,
                              "rings": len(self.rings)}}

    def save_chrome(self, path: str) -> None:
        """Write ``trace.json`` loadable by Perfetto / chrome://tracing."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def discover(session: Optional[str] = None) -> list:
    """Ring segment names of a session, found by listing ``/dev/shm``."""
    session = session or TRACE.session
    prefix = f"{_PREFIX}-{session}-"
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:
        return []
    return sorted(n for n in names if n.startswith(prefix))


def _read_ring(name: str) -> Optional[RingDump]:
    """Map one ring read-only and copy out its valid records in order."""
    from repro_torch.ipc.shm import SharedMemoryArena  # runtime import (cycle)
    try:
        arena = SharedMemoryArena(name, create=False)
    except (FileNotFoundError, ValueError):
        return None
    _untrack(arena._shm)            # attach registers again in some setups
    try:
        words = arena.control_words()
        cap = int(words[_W_CAPACITY])
        cur = int(words[_W_CURSOR])
        pid = int(words[_W_PID])
        tid = int(words[_W_TID])
        if cap <= 0:
            return None
        recs = np.frombuffer(arena.view(0, cap * RECORD_BYTES), RECORD_DTYPE)
        if cur <= cap:
            out = recs[:cur].copy()
        else:                       # wrapped: oldest record sits at cursor%cap
            head = cur % cap
            out = np.concatenate([recs[head:], recs[:head]])
        del recs, words
        return RingDump(name=name, pid=pid, tid=tid,
                        drops=max(0, cur - cap), records=out)
    finally:
        arena.close()


def collect(session: Optional[str] = None, unlink: bool = False) -> TraceView:
    """Map every ring of a session read-only and return the joined view.

    ``unlink=True`` destroys the segments after reading (the collector
    owns cleanup — writer processes never unlink their own rings, so a
    client's records survive its exit)."""
    view = TraceView()
    for name in discover(session):
        dump = _read_ring(name)
        if dump is not None:
            view.rings.append(dump)
        if unlink:
            _unlink_quiet(name)
    return view
