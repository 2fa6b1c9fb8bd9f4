"""Serving-side ROCKET runtime: request dispatcher, handlers, query handler.

Mirrors the paper's server architecture (Fig. 7 / Listing 1):

- clients call ``request(mode=..., op=..., data=...)`` -> job id (or a
  blocking result in sync mode);
- a :class:`RequestDispatcher` routes messages to registered per-op
  handlers; in pipelined mode requests are *batched* (application-level
  request batching, §IV-C) before the handler runs;
- a :class:`QueryHandler` tracks completions; ``query(job_id)`` applies the
  hybrid polling strategy (size-aware deferral + short passive waits).

**Zero-copy batch formation** (the single-copy serving datapath): a request
may arrive carrying a :class:`~repro_torch.ipc.channel.RecvLease` — its ``data``
is then a numpy view straight into the client's shared-memory ring slot.
During batch formation the dispatcher *gathers* those views into a pooled
batch buffer (one scatter-gather descriptor per batch on the process-wide
:class:`~repro_torch.core.copyengine.CopyEngine` — the only server-side payload
memcpy per request) and releases every lease immediately after the gather,
before the handler runs, so ring slots recycle at copy speed rather than
model speed.  Handlers registered with ``slab_fn`` receive the pooled
batch buffer directly (no second per-row packing copy); plain ``batch_fn``
handlers receive row views into it.

**SLO lanes** (deadline-aware serving): every request carries a
``(priority, deadline_ns)`` pair (defaults: lane 0, no deadline).  Batch
formation pops a priority heap ordered ``(priority, deadline, seq)``
instead of a FIFO — lane 0 drains first, earliest deadline first within a
lane — and at pop time a :class:`~repro_torch.core.latency.ServiceTimeModel`
(observed per-op service EWMA over the transfer model) predicts whether
the request can still make its deadline; one that can't is **shed**:
counted in ``DispatcherStats.shed`` and completed immediately with
:class:`DeadlineExceeded` (an error reply on the wire, never a silent
drop).  Completions that ran anyway but landed late count
``deadline_miss``.

Copied from ``src/repro/core/dispatcher.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from __future__ import annotations

import heapq
import itertools
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.core.copyengine import SGList, get_engine
from repro_torch.core.latency import LatencyModel, ServiceTimeModel
from repro_torch.core.policy import ExecutionMode, OffloadPolicy
from repro_torch.core.queuepair import BufferPool
from repro_torch.ft import inject as _inject
from repro_torch.obs import hwcounters as _hw
from repro_torch.obs import trace as _trace


class CircuitOpen(RuntimeError):
    """Fast-fail error for an op quarantined by its circuit breaker.

    A handler that keeps failing gets its op *contained*: instead of
    burning batch slots (and dispatcher worker time) on work that will
    fail anyway, every request for the op is completed immediately with
    this error until a half-open probe succeeds.  Like a shed, it is a
    counted error reply (``DispatcherStats.breaker_fast_fails``) — never
    a silent drop.
    """


class DeadlineExceeded(RuntimeError):
    """A request was shed (or would complete) past its deadline.

    Raised to the submitter through the normal completion path — a shed is
    an *immediate error reply*, never a silent drop: the request is counted
    (``DispatcherStats.shed``), its lease released, and its callback/query
    completed with this exception before any batch slot is spent on it.
    """


@dataclass
class Request:
    job_id: int
    op: str
    data: Any
    mode: ExecutionMode
    submit_t: float = field(default_factory=time.perf_counter)
    nbytes: int = 0
    # completion callback (multi-client serving): when set, the worker thread
    # calls ``callback(job_id, result_or_exception)`` instead of parking the
    # result in the QueryHandler — the IPC fabric uses this to demultiplex
    # batched results back to the right client transport.
    callback: Optional[Callable[[int, Any], None]] = None
    # zero-copy serving: the ring-slot lease backing ``data``.  The
    # dispatcher owns its release: after the batch gather (pipelined), or
    # after completion for solo execution.  Anything with a ``release()``
    # and a ``held`` attribute qualifies (tests pass stubs).
    lease: Optional[Any] = None
    # trace request id (0 = untraced): propagated from the wire by the
    # serving fabric so dispatcher spans join the cross-process timeline
    rid: int = 0
    # SLO lane: 0 = highest priority; batch formation pops lanes in order
    priority: int = 0
    # absolute deadline in time.perf_counter_ns() ticks (0 = none); set by
    # the client (cross-process CLOCK_MONOTONIC timebase) or the fabric's
    # default.  A request the service model predicts past this is shed.
    deadline_ns: int = 0

    def _release_lease(self) -> None:
        if self.lease is not None:
            lease, self.lease = self.lease, None
            try:
                lease.release()
            except Exception:
                # the client's transport may already be reaped (client died
                # mid-batch): a stale lease has nothing left to recycle, and
                # a release failure must never kill the serving worker loop
                pass


@dataclass
class _Failure:
    """Wrapper parking a handler exception in the QueryHandler (so a result
    that happens to *be* an Exception instance is not misread as an error)."""
    error: Exception


@dataclass
class DispatcherStats:
    requests: int = 0
    batches: int = 0
    batched_requests: int = 0
    queries: int = 0
    query_polls: int = 0
    mean_batch: float = 0.0
    gathers: int = 0             # batch-formation gathers (SG submissions)
    gathered_requests: int = 0   # requests copied slot → batch buffer
    slab_batches: int = 0        # batches handed to a slab_fn handler
    shed: int = 0                # requests refused pre-execution (counted,
                                 # each one got a DeadlineExceeded reply)
    deadline_miss: int = 0       # requests completed but past their deadline
    lane_requests: dict = field(default_factory=dict)  # per-priority intake
    lane_shed: dict = field(default_factory=dict)      # per-priority sheds
    breaker_opened: int = 0      # closed->open transitions (incl. reopen)
    breaker_recovered: int = 0   # half-open probe succeeded: op back in service
    breaker_fast_fails: int = 0  # requests fast-failed with CircuitOpen
    dedup_hits: int = 0          # replayed requests served from the window


class _LaneQueue:
    """Priority-lane request queue: min-heap on (priority, deadline, seq).

    Replaces the FIFO batch-formation feed: the front of the queue is
    always the most urgent pending request — lowest priority value first,
    earliest deadline inside a lane (no-deadline requests sort last in
    their lane), submit order as the final tiebreak.

    ``get(match=...)`` only pops while the *front* satisfies the
    predicate: when a higher-urgency request of a different op/lane
    arrives mid-window, the batch closes instead of reordering past it.
    A ``put(None)`` sentinel sorts after all real work and stops one
    worker (push one per worker).
    """

    _NO_DEADLINE = 1 << 62

    def __init__(self):
        self._heap: list = []
        self._cond = threading.Condition()
        self._seq = itertools.count()

    def put(self, req: Optional[Request]) -> None:
        with self._cond:
            if req is None:
                entry = (1 << 30, self._NO_DEADLINE, next(self._seq), None)
            else:
                entry = (req.priority, req.deadline_ns or self._NO_DEADLINE,
                         next(self._seq), req)
            heapq.heappush(self._heap, entry)
            self._cond.notify()

    def get(self, timeout: Optional[float] = None,
            match: Optional[Callable[[Request], bool]] = None
            ) -> Optional[Request]:
        """Pop the front request; ``None`` = stop sentinel.  Raises
        :class:`queue.Empty` on timeout or (with ``match``) when the
        front request doesn't satisfy the predicate."""
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        with self._cond:
            while True:
                if self._heap:
                    front = self._heap[0][3]
                    if front is None:
                        heapq.heappop(self._heap)
                        return None
                    if match is not None and not match(front):
                        raise queue.Empty
                    return heapq.heappop(self._heap)[3]
                remain = (deadline - time.perf_counter()
                          if deadline is not None else None)
                if remain is not None and remain <= 0:
                    raise queue.Empty
                self._cond.wait(remain)

    def __len__(self) -> int:
        with self._cond:
            return len(self._heap)


class _CircuitBreaker:
    """Per-op failure containment: closed → open → half-open → closed.

    ``threshold`` consecutive handler-invocation failures open the
    breaker; while open, requests fast-fail with :class:`CircuitOpen`.
    After ``cooldown_s`` the breaker goes half-open and admits exactly
    ONE probe invocation — success closes it (op back in service),
    failure reopens it for another cooldown.  Failures are counted per
    handler *invocation* (a failing batch is one failure, not K), so the
    breaker tracks "the handler is broken", not "traffic is heavy".
    """

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.state = "closed"
        self._consecutive = 0
        self._opened_t = 0.0
        self._probing = False
        self._lock = threading.Lock()

    def admit(self) -> bool:
        """May a request for this op run right now?  (Half-open: only the
        single probe.)"""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if time.perf_counter() - self._opened_t < self.cooldown_s:
                    return False
                self.state = "half-open"
                self._probing = False
            if self._probing:           # half-open: one probe at a time
                return False
            self._probing = True
            return True

    def record(self, ok: bool) -> Optional[str]:
        """Feed one handler-invocation outcome; returns the transition it
        caused (``"opened"``/``"recovered"``) or ``None``."""
        with self._lock:
            if ok:
                self._consecutive = 0
                if self.state != "closed":
                    self.state = "closed"
                    self._probing = False
                    return "recovered"
                return None
            self._consecutive += 1
            if self.state == "half-open":
                self.state = "open"
                self._opened_t = time.perf_counter()
                self._probing = False
                return "opened"
            if self.state == "closed" and self._consecutive >= self.threshold:
                self.state = "open"
                self._opened_t = time.perf_counter()
                return "opened"
            return None

    def export(self) -> dict:
        """Replicable breaker state (perf_counter stamps don't cross
        processes, so the open-cooldown clock restarts on import)."""
        with self._lock:
            return {"state": self.state, "consecutive": self._consecutive}

    def import_state(self, st: dict) -> None:
        """Adopt a peer's breaker state; an imported ``open`` breaker
        starts a fresh cooldown from now (conservative: the replica
        re-probes no earlier than the primary would have)."""
        with self._lock:
            self.state = st.get("state", "closed")
            self._consecutive = int(st.get("consecutive", 0))
            self._probing = False
            if self.state == "half-open":
                self.state = "open"
            if self.state == "open":
                self._opened_t = time.perf_counter()


class _DedupWindow:
    """Bounded idempotency window for exactly-once request replay.

    A reconnecting client resubmits requests whose replies it never saw;
    the original may (a) never have arrived, (b) still be executing, or
    (c) have completed with the reply lost on the torn-down transport.
    Keyed by the client's idempotent id, the window turns all three into
    exactly-once *execution*: (a) runs normally, (b) attaches the replay's
    reply callback to the in-flight entry, (c) replies immediately from
    the cached result.  Entries are LRU-evicted past ``capacity`` —
    sized (``OffloadPolicy.retry.dedup_window``) to comfortably cover a
    client's unacked window across a reconnect.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._entries: OrderedDict = OrderedDict()   # key -> [state, payload]
        self._lock = threading.Lock()

    def admit(self, key) -> tuple:
        """Register ``key`` as in-flight; returns ``(is_replay, state,
        cached)`` where state is ``"new"``/``"inflight"``/``"done"``."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self._entries[key] = ["inflight", []]
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                return False, "new", None
            self._entries.move_to_end(key)
            if ent[0] == "done":
                return True, "done", ent[1]
            return True, "inflight", None

    def attach(self, key, callback) -> bool:
        """Queue a replay's callback behind the in-flight original; False
        if the entry completed meanwhile (caller replies from cache)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent[0] == "inflight":
                ent[1].append(callback)
                return True
            return False

    def result(self, key):
        with self._lock:
            ent = self._entries.get(key)
            return ent[1] if ent is not None and ent[0] == "done" else None

    def settle(self, key, out) -> list:
        """Record the original's completion; returns the queued replay
        callbacks to fire with the same result."""
        with self._lock:
            ent = self._entries.get(key)
            waiters = ent[1] if ent is not None and ent[0] == "inflight" \
                else []
            self._entries[key] = ["done", out]
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
            return waiters

    def export(self) -> list:
        """Settled entries as ``(key, result)`` pairs, LRU order —
        the replication-delta half of exactly-once: a standby importing
        these suppresses re-execution of everything the primary already
        completed.  In-flight entries are NOT exported (their results
        don't exist yet; replays will re-execute on the replica, still
        producing exactly one reply since the original's died with the
        primary)."""
        with self._lock:
            return [(k, v[1]) for k, v in self._entries.items()
                    if v[0] == "done"]

    def import_entries(self, entries) -> int:
        """Install settled entries from a peer's :meth:`export`; returns
        how many landed (the LRU cap still applies)."""
        n = 0
        with self._lock:
            for key, out in entries:
                self._entries[key] = ["done", out]
                self._entries.move_to_end(key)
                n += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return n


class QueryHandler:
    """Completion tracking + hybrid polling for result queries."""

    def __init__(self, latency: LatencyModel, policy: OffloadPolicy):
        self._results: dict[int, Any] = {}
        self._events: dict[int, threading.Event] = {}
        self._meta: dict[int, Request] = {}
        self._lock = threading.Lock()
        self.latency = latency
        self.policy = policy
        self.polls = 0

    def register(self, req: Request) -> None:
        with self._lock:
            self._events[req.job_id] = threading.Event()
            self._meta[req.job_id] = req

    def complete(self, job_id: int, result: Any) -> None:
        with self._lock:
            self._results[job_id] = result
            ev = self._events.get(job_id)
        if ev is not None:
            ev.set()

    def query(self, job_id: int, timeout: float = 60.0) -> Any:
        with self._lock:
            ev = self._events.get(job_id)
            req = self._meta.get(job_id)
        if ev is None:
            raise KeyError(f"unknown job {job_id}")
        if not ev.is_set() and req is not None:
            # size-aware deferral before polling (remaining predicted latency)
            pred = self.latency.defer_seconds(req.nbytes, self.policy.defer_fraction)
            remain = pred - (time.perf_counter() - req.submit_t)
            if remain > 0:
                time.sleep(min(remain, timeout))
        deadline = time.perf_counter() + timeout
        quantum = self.policy.poll_interval_us * 1e-6
        while not ev.is_set():
            self.polls += 1
            if time.perf_counter() > deadline:
                raise TimeoutError(f"job {job_id} timed out")
            ev.wait(quantum)
        with self._lock:
            out = self._results.pop(job_id)
            self._events.pop(job_id, None)
            self._meta.pop(job_id, None)
        return out


class RequestDispatcher:
    """Routes requests to registered handlers; batches in pipelined mode."""

    def __init__(self, policy: OffloadPolicy = OffloadPolicy(),
                 latency: Optional[LatencyModel] = None,
                 max_batch_wait_s: float = 0.002,
                 workers: int = 1,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 0.25):
        self.policy = policy
        self.latency = latency or LatencyModel()
        self.queries = QueryHandler(self.latency, policy)
        self.stats = DispatcherStats()
        # admission predictor: per-op observed service EWMA over the
        # transfer model — drives deadline-miss shedding in the serve loop
        self.service = ServiceTimeModel(self.latency)
        # per-op circuit breakers (containment): ``breaker_threshold``
        # consecutive handler failures quarantine the op with fast-fail
        # CircuitOpen replies until a half-open probe recovers it; 0
        # disables breakers entirely
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self._breakers: dict[str, _CircuitBreaker] = {}
        # exactly-once replay window for reconnecting clients (idempotent
        # request ids from the wire; see _DedupWindow)
        self._dedup = _DedupWindow(policy.retry.dedup_window)
        self._handlers: dict[str, Callable] = {}
        self._batch_handlers: dict[str, Callable] = {}
        self._slab_handlers: dict[str, Callable] = {}
        self._pool = BufferPool(max_per_key=4)   # pooled batch buffers
        self._q = _LaneQueue()
        self._ids = itertools.count()
        self._max_wait = max_batch_wait_s
        self._slock = threading.Lock()           # stats (workers > 1 race)
        self._running = True
        # a worker pool (sized to the fabric's reactor shards) lets batches
        # execute concurrently — all workers pop the same lane queue, so
        # global lane order is preserved even with several execution lanes
        self._workers = [threading.Thread(target=self._serve_loop,
                                          daemon=True)
                         for _ in range(max(1, workers))]
        for w in self._workers:
            w.start()
        self._worker = self._workers[0]          # backwards-compat alias

    # -- handler registration (paper: workload-specific handlers) ------------
    def register_handler(self, op: str, fn: Callable,
                         batch_fn: Optional[Callable] = None,
                         slab_fn: Optional[Callable] = None) -> None:
        """``fn(data) -> result``; optional ``batch_fn(list[data]) -> list``;
        optional ``slab_fn(slab, shapes) -> list`` receiving the pooled
        gather buffer directly — ``slab[i]``'s leading ``shapes[i]`` region
        holds request *i*'s payload (zero-padded to the batch max), so the
        handler consumes the batch with **no additional packing copy**."""
        self._handlers[op] = fn
        if batch_fn is not None:
            self._batch_handlers[op] = batch_fn
        if slab_fn is not None:
            self._slab_handlers[op] = slab_fn

    # -- containment: per-op circuit breakers ---------------------------------
    def _breaker(self, op: str) -> Optional[_CircuitBreaker]:
        if self._breaker_threshold <= 0:
            return None
        br = self._breakers.get(op)
        if br is None:
            br = self._breakers.setdefault(
                op, _CircuitBreaker(self._breaker_threshold,
                                    self._breaker_cooldown_s))
        return br

    def breaker_state(self, op: str) -> str:
        """This op's breaker state (``closed``/``open``/``half-open``) —
        introspection for tests and dashboards."""
        br = self._breakers.get(op)
        return br.state if br is not None else "closed"

    def _breaker_note(self, br: Optional[_CircuitBreaker], ok: bool) -> None:
        """Feed one handler-invocation outcome; count transitions."""
        if br is None:
            return
        transition = br.record(ok)
        if transition == "opened":
            with self._slock:
                self.stats.breaker_opened += 1
        elif transition == "recovered":
            with self._slock:
                self.stats.breaker_recovered += 1

    def _call_handler(self, fn: Callable, *args):
        """Every handler invocation funnels through here: the
        ``dispatcher.handler.error`` injection site (a stand-in for an
        arbitrary handler bug) guards the call."""
        if _inject._PLANE is not None \
                and _inject.fire("dispatcher.handler.error") is not None:
            raise _inject.InjectedFault("injected handler failure")
        return fn(*args)

    # -- client API (paper Listing 1) -----------------------------------------
    def request(self, op: str, data: Any,
                mode: ExecutionMode | str | None = None,
                priority: int = 0, deadline_ns: int = 0) -> int | Any:
        mode = ExecutionMode(mode) if mode is not None else self.policy.mode
        req = Request(next(self._ids), op, data, mode,
                      nbytes=int(np.asarray(data).nbytes)
                      if isinstance(data, np.ndarray) else 0,
                      priority=priority, deadline_ns=deadline_ns)
        self._count_in(req)
        if mode == ExecutionMode.SYNC:
            # inline fast path — still SLO-accounted (an expired deadline
            # sheds here too, a late completion is a counted miss) and
            # still breaker-contained (a quarantined op fast-fails inline
            # callers exactly like queued ones)
            err = self._shed_verdict(req)
            if err is not None:
                raise err
            br = self._breaker(op)
            if br is not None and not br.admit():
                with self._slock:
                    self.stats.breaker_fast_fails += 1
                raise CircuitOpen(f"op {op!r} quarantined (circuit open)")
            t0 = time.perf_counter()
            try:
                out = self._call_handler(self._handlers[op], data)
            except Exception:
                self._breaker_note(br, False)
                raise
            self._breaker_note(br, True)
            self.service.observe(op, time.perf_counter() - t0)
            self._note_late(req)
            return out
        self.queries.register(req)
        self._q.put(req)
        return req.job_id

    def _dedup_admit(self, key: Any,
                     on_complete: Optional[Callable[[int, Any], None]],
                     lease: Optional[Any]) -> tuple[bool, Optional[Callable]]:
        """Exactly-once admission for an idempotent request id.

        Returns ``(handled, callback)``.  ``handled`` means the request is
        a replay and was fully resolved here (cached result replied, or
        the caller's callback attached to the in-flight original) — do not
        enqueue it.  Otherwise ``callback`` is the (possibly wrapped)
        completion callback to enqueue with: for a first-seen key it
        settles the dedup window and fires any waiters that attached while
        the request was in flight."""
        if key is None:
            return False, on_complete
        is_replay, state, cached = self._dedup.admit(key)
        if not is_replay:
            def settle(job_id, out, _key=key, _cb=on_complete):
                # the cached copy outlives any lease/slab the result may
                # alias — materialize before it enters the window
                if isinstance(out, np.ndarray):
                    out = np.array(out)
                waiters = self._dedup.settle(_key, out)
                if _cb is not None:
                    _cb(job_id, out)
                for w in waiters:
                    try:
                        w(job_id, out)
                    except Exception:
                        pass
            return False, settle
        with self._slock:
            self.stats.dedup_hits += 1
        if lease is not None:        # replay never consumes the payload
            try:
                lease.release()
            except Exception:
                pass
        if state == "inflight" and (
                on_complete is None
                or self._dedup.attach(key, on_complete)):
            return True, None        # original completion will reply
        cached = self._dedup.result(key) if cached is None else cached
        if on_complete is not None:
            try:
                on_complete(-1, cached)
            except Exception:
                pass
        return True, None

    def submit(self, op: str, data: Any,
               mode: ExecutionMode | str | None = None,
               on_complete: Optional[Callable[[int, Any], None]] = None,
               lease: Optional[Any] = None,
               priority: int = 0, deadline_ns: int = 0,
               dedup: Any = None) -> int:
        """Enqueue a request without ever blocking the caller.

        Unlike :meth:`request`, sync mode is *not* executed inline: every
        mode goes through the worker thread (sync/async solo, pipelined
        batchable), so a polling thread — the IPC reactor — can hand off
        work from many clients without stalling its sweep.  When
        ``on_complete`` is given it fires from the worker thread with
        ``(job_id, result_or_exception)`` and the result bypasses the
        QueryHandler; otherwise fetch it with :meth:`query`.

        ``lease`` is the zero-copy ring-slot lease backing ``data`` (views
        into shared memory); the dispatcher releases it after batch gather
        or solo completion — never before the payload has been consumed.

        ``dedup`` is an optional idempotent request id (any hashable):
        a key already seen inside the dedup window is NOT re-executed —
        a cached result is replied immediately, or the callback is
        attached to the in-flight original (requires ``on_complete``).
        This is the server half of reconnect-with-replay: a client may
        resubmit after a lost reply without double-executing the handler.
        """
        mode = ExecutionMode(mode) if mode is not None else self.policy.mode
        handled, on_complete = self._dedup_admit(dedup, on_complete, lease)
        if handled:
            return -1
        req = Request(next(self._ids), op, data, mode,
                      nbytes=int(np.asarray(data).nbytes)
                      if isinstance(data, np.ndarray) else 0,
                      callback=on_complete, lease=lease,
                      priority=priority, deadline_ns=deadline_ns)
        self._count_in(req)
        if on_complete is None:
            self.queries.register(req)
        self._q.put(req)
        return req.job_id

    def submit_many(self, items: Sequence[dict]) -> list[int]:
        """Enqueue a batch of requests in one pass (same semantics per
        item as :meth:`submit`; keys: ``op``, ``data``, optional ``mode``,
        ``on_complete``, ``lease``).

        This is the reactor's frame-drain feed: a client's coalesced
        frame arrives as one list, and all K requests land in the batch
        window together — the serve loop's first ``get`` then assembles
        the whole batch without waiting out ``max_batch_wait_s`` between
        members, so a microbatch on the wire becomes a batch in the
        handler without K separate submit round-trips.  Optional item
        keys ``priority`` and ``deadline_ns`` place the request in its
        SLO lane (see :class:`_LaneQueue`); optional key ``dedup`` is the
        idempotent request id (see :meth:`submit`) — replayed items are
        resolved from the dedup window and report job id ``-1``."""
        reqs = []
        jobs = []
        for it in items:
            mode = it.get("mode")
            mode = (ExecutionMode(mode) if mode is not None
                    else self.policy.mode)
            data = it["data"]
            handled, cb = self._dedup_admit(
                it.get("dedup"), it.get("on_complete"), it.get("lease"))
            if handled:
                jobs.append(-1)
                continue
            req = Request(
                next(self._ids), it["op"], data, mode,
                nbytes=int(np.asarray(data).nbytes)
                if isinstance(data, np.ndarray) else 0,
                callback=cb, lease=it.get("lease"),
                rid=it.get("rid", 0), priority=it.get("priority", 0),
                deadline_ns=it.get("deadline_ns", 0))
            reqs.append(req)
            jobs.append(req.job_id)
        for req in reqs:
            self._count_in(req)
            if req.callback is None:
                self.queries.register(req)
            self._q.put(req)
        return jobs

    def query(self, job_id: int, timeout: float = 60.0) -> Any:
        self.stats.queries += 1
        out = self.queries.query(job_id, timeout)
        self.stats.query_polls = self.queries.polls
        if isinstance(out, _Failure):
            raise out.error
        return out

    # -- admission: counted intake + deadline-miss shedding ---------------------
    def _count_in(self, req: Request) -> None:
        with self._slock:
            self.stats.requests += 1
            lanes = self.stats.lane_requests
            lanes[req.priority] = lanes.get(req.priority, 0) + 1

    def _shed_verdict(self, req: Request) -> Optional[DeadlineExceeded]:
        """Counted shed decision: when the service model predicts the
        request past its deadline, count it (total + per lane) and return
        the error to deliver; ``None`` admits the request."""
        if not req.deadline_ns:
            return None
        now_ns = time.perf_counter_ns()
        pred_ns = int(self.service.predict_s(req.op, req.nbytes) * 1e9)
        if now_ns + pred_ns <= req.deadline_ns:
            return None
        with self._slock:
            self.stats.shed += 1
            lane = self.stats.lane_shed
            lane[req.priority] = lane.get(req.priority, 0) + 1
        late_ms = (now_ns + pred_ns - req.deadline_ns) / 1e6
        return DeadlineExceeded(
            f"shed op={req.op!r} lane={req.priority}: predicted completion "
            f"{late_ms:.2f} ms past deadline")

    def _note_late(self, req: Request) -> None:
        """Count a completion that landed past its deadline (ran anyway)."""
        if req.deadline_ns and time.perf_counter_ns() > req.deadline_ns:
            with self._slock:
                self.stats.deadline_miss += 1

    def _maybe_shed(self, req: Request) -> bool:
        """Shed a request the service model predicts past its deadline.

        Called at pop time (batch formation), where queueing delay has
        already consumed part of the budget.  A shed is never silent: the
        lease is released, ``stats.shed`` counted, and the submitter gets
        an immediate :class:`DeadlineExceeded` completion instead of a
        batch slot."""
        err = self._shed_verdict(req)
        if err is None:
            return False
        req._release_lease()
        self._complete(req, err)
        return True

    # -- server loop -----------------------------------------------------------
    def _serve_loop(self) -> None:
        while self._running:
            try:
                req = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if req is None:
                break
            if self._maybe_shed(req):
                continue
            if req.mode == ExecutionMode.PIPELINED:
                t0 = _trace.now() if _trace.TRACE.enabled else 0
                c0 = _hw.begin() if _hw.PROF.enabled else None

                def same_lane(r, _op=req.op, _prio=req.priority):
                    return (r.op == _op and r.priority == _prio
                            and r.mode == ExecutionMode.PIPELINED)

                batch = [req]
                deadline = time.perf_counter() + self._max_wait
                while len(batch) < self.policy.max_batch:
                    remain = deadline - time.perf_counter()
                    if remain <= 0:
                        break
                    try:
                        # lane-ordered batch fill: only pop while the queue
                        # front matches this batch's (op, lane); a more
                        # urgent arrival closes the window instead of being
                        # reordered behind it (it stays at the front for
                        # the next iteration)
                        nxt = self._q.get(timeout=remain, match=same_lane)
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._running = False
                        break
                    if self._maybe_shed(nxt):
                        continue
                    batch.append(nxt)
                if t0:      # the batch-formation window wait, per batch
                    _trace.emit(_trace.DISPATCH_WAIT, t0, rid=batch[0].rid,
                                arg=len(batch))
                if c0 is not None:
                    _hw.end(c0, "batch_wait", rid=batch[0].rid)
                self._execute(batch)
            else:
                self._execute([req])

    # -- batch formation: slot views → pooled batch buffer ---------------------
    #: ceiling on one pooled gather slab: with the bulk-heap datapath a
    #: "row" can be hundreds of MB, and padding every row of a batch to the
    #: largest one would multiply that by max_batch — beyond this the batch
    #: falls back to per-row handling on the leased views (still zero
    #: receive copies; just no slab)
    GATHER_SLAB_MAX_BYTES = 256 << 20

    def _gatherable(self, batch: list[Request]) -> bool:
        datas = [r.data for r in batch]
        if not (all(isinstance(d, np.ndarray) and d.ndim >= 1 for d in datas)
                and len({d.dtype for d in datas}) == 1
                and len({d.ndim for d in datas}) == 1):
            return False
        ndim = datas[0].ndim
        maxdims = tuple(max(d.shape[k] for d in datas) for k in range(ndim))
        slab_bytes = (len(datas) * int(np.prod(maxdims))
                      * datas[0].dtype.itemsize)
        return slab_bytes <= self.GATHER_SLAB_MAX_BYTES

    def _gather(self, batch: list[Request]):
        """One SG gather per batch: copy every request's payload view into
        a pooled slab (THE server-side payload memcpy), zero the padding,
        then release every lease — the slots recycle before the handler
        runs.  Returns ``(slab, shapes, rows)``."""
        t0 = _trace.now() if _trace.TRACE.enabled else 0
        c0 = _hw.begin() if _hw.PROF.enabled else None
        datas = [r.data for r in batch]
        ndim = datas[0].ndim
        maxdims = tuple(max(d.shape[k] for d in datas) for k in range(ndim))
        slab = self._pool.acquire((len(batch),) + maxdims, datas[0].dtype)
        sg = SGList()
        rows = []
        for i, d in enumerate(datas):
            if d.shape != maxdims:
                slab[i].fill(0)          # pad region (memset, not a copy)
            dst = slab[i][tuple(slice(0, s) for s in d.shape)]
            sg.add_array(d, dst)
            rows.append(dst)
        get_engine().run_sg(sg, injection=self.policy.injection_enabled(),
                            tag="gather")
        with self._slock:
            self.stats.gathers += 1
            self.stats.gathered_requests += len(batch)
        for r in batch:
            r._release_lease()           # released right after the gather
        if t0:
            _trace.emit(_trace.GATHER, t0, rid=batch[0].rid, arg=len(batch))
        if c0 is not None:
            _hw.end(c0, "sg_gather", rid=batch[0].rid,
                    nbytes=sum(d.nbytes for d in datas))
        return slab, [d.shape for d in datas], rows

    def _recycle_slab(self, slab: np.ndarray, results: Sequence) -> None:
        # a handler may legally return views into the slab (echo-style);
        # recycling it would let the next batch overwrite live results, so
        # only pooled-reuse when nothing aliases it
        for out in results:
            if isinstance(out, np.ndarray) and np.may_share_memory(out, slab):
                return
        self._pool.release(slab)

    def _execute(self, batch: list[Request]) -> None:
        if not batch:
            return
        op = batch[0].op
        br = self._breaker(op)
        if br is not None and not br.admit():
            # quarantined op: fast-fail the whole batch with error replies
            # instead of invoking the handler — leases still released
            err = CircuitOpen(f"op {op!r} quarantined (circuit open)")
            with self._slock:
                self.stats.breaker_fast_fails += len(batch)
            for r in batch:
                r._release_lease()
                self._complete(r, err)
            return
        with self._slock:
            self.stats.batches += 1
            self.stats.batched_requests += len(batch)
            self.stats.mean_batch = (self.stats.batched_requests
                                     / self.stats.batches)
        t_exec = time.perf_counter()
        sfn = self._slab_handlers.get(op)
        bfn = self._batch_handlers.get(op)
        leased = any(r.lease is not None for r in batch)
        pipelined = batch[0].mode == ExecutionMode.PIPELINED
        slab = None
        t0 = _trace.now() if _trace.TRACE.enabled else 0
        c0 = _hw.begin() if _hw.PROF.enabled else None
        # errors are contained per request: a failing handler completes its
        # job(s) with the exception instead of killing the worker loop
        try:
            if (pipelined and (sfn is not None or bfn is not None)
                    and (leased or sfn is not None)
                    and self._gatherable(batch)):
                try:
                    slab, shapes, rows = self._gather(batch)
                    if sfn is not None:
                        self.stats.slab_batches += 1
                        results = self._call_handler(sfn, slab, shapes)
                    else:
                        results = self._call_handler(bfn, rows)
                    if len(results) != len(batch):
                        # surface the handler bug now — zip truncation would
                        # leave the tail requests uncompleted forever
                        raise RuntimeError(
                            f"batch handler for {op!r} returned "
                            f"{len(results)} results for {len(batch)} "
                            f"requests")
                    self._breaker_note(br, True)
                except Exception as e:
                    results = [e] * len(batch)
                    self._breaker_note(br, False)
            elif bfn is not None and len(batch) > 1:
                try:
                    results = self._call_handler(
                        bfn, [r.data for r in batch])
                    if len(results) != len(batch):
                        raise RuntimeError(
                            f"batch handler for {op!r} returned "
                            f"{len(results)} results for {len(batch)} "
                            f"requests")
                    self._breaker_note(br, True)
                except Exception as e:
                    results = [e] * len(batch)
                    self._breaker_note(br, False)
            else:
                # solo path: each call is its own handler invocation, so
                # each feeds the breaker individually (a batch counts once)
                results = []
                for r in batch:
                    try:
                        results.append(
                            self._call_handler(self._handlers[op], r.data))
                        self._breaker_note(br, True)
                    except Exception as e:
                        results.append(e)
                        self._breaker_note(br, False)
            if t0:      # batch compute: gather (nested sub-span) + handler
                _trace.emit(_trace.HANDLER, t0, rid=batch[0].rid,
                            arg=len(batch))
            if c0 is not None:
                # like the HANDLER span, this contains sg_gather as a
                # nested sub-scope; handler-only = handler − sg_gather
                _hw.end(c0, "handler", rid=batch[0].rid,
                        nbytes=sum(r.nbytes for r in batch))
            # feed the admission predictor with each request's share of
            # the batch wall time, and count completions that nonetheless
            # landed past their deadline (miss ≠ shed: the work ran)
            share_s = (time.perf_counter() - t_exec) / len(batch)
            self.service.observe(op, share_s)
            now_ns = time.perf_counter_ns()
            late = sum(1 for r in batch
                       if r.deadline_ns and now_ns > r.deadline_ns)
            if late:
                with self._slock:
                    self.stats.deadline_miss += late
            for r, out in zip(batch, results):
                # a query-path result computed from a still-leased view (or
                # the recyclable slab) must not alias memory about to be
                # reused — copy it out before the lease/slab goes away
                if (r.callback is None and isinstance(out, np.ndarray)
                        and r.lease is not None and isinstance(r.data,
                                                               np.ndarray)
                        and np.may_share_memory(out, r.data)):
                    out = np.array(out)
                self._complete(r, out)
        finally:
            # solo/fallback paths executed on the leased views directly:
            # release only now, after replies/results are materialized
            for r in batch:
                r._release_lease()
            if slab is not None:
                self._recycle_slab(slab, results)

    def _complete(self, req: Request, out: Any) -> None:
        if req.callback is not None:
            try:
                req.callback(req.job_id, out)
            except Exception:
                # reply path failed (e.g. client transport already gone);
                # the job is still settled — don't kill the worker loop
                pass
        else:
            self.queries.complete(
                req.job_id, _Failure(out) if isinstance(out, Exception)
                else out)

    # -- state replication (warm-standby failover) ------------------------------
    def export_state(self) -> dict:
        """The dispatcher's fast-moving replicable state: settled dedup
        entries (exactly-once across promotion), per-op breaker states,
        and the service-time EWMAs that drive deadline shedding.  This is
        the "delta log" a warm standby pulls between full snapshots —
        small (no params), picklable, and refreshed on every pull."""
        return {
            "dedup": self._dedup.export(),
            "breakers": {op: br.export()
                         for op, br in self._breakers.items()},
            "service": dict(self.service._per_op),
        }

    def import_state(self, state: dict) -> dict:
        """Adopt a peer dispatcher's :meth:`export_state`; returns counts
        of what landed (``dedup_entries``/``breakers``/``service_ops``)."""
        n_dedup = self._dedup.import_entries(state.get("dedup", []))
        breakers = state.get("breakers", {})
        for op, st in breakers.items():
            br = self._breaker(op)
            if br is not None:
                br.import_state(st)
        service = state.get("service", {})
        self.service._per_op.update(service)
        return {"dedup_entries": n_dedup, "breakers": len(breakers),
                "service_ops": len(service)}

    def close(self) -> None:
        self._running = False
        for _ in self._workers:
            self._q.put(None)            # one stop sentinel per worker
        for w in self._workers:
            w.join(timeout=self.policy.retry.join_timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
