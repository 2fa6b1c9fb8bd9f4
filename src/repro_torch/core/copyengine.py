"""Process-wide software-DSA copy engine (§IV "unified runtime capability").

The paper's central design point is that memory-operation offloading only
pays off when *one* engine coordinates submission, completion, and cache
visibility for every IPC path.  This module is that engine for the repro:
a single per-process :class:`CopyEngine` that the tier-1 transfer engine
(:mod:`repro_torch.core.engine`), every IPC :class:`~repro_torch.ipc.channel.DataChannel`,
and the serving dispatcher's batch-gather all submit to.  It models the DSA
hardware interface faithfully:

- **scatter-gather descriptors** — one :class:`Descriptor` per pytree
  submission carrying an :class:`SGList` of per-leaf copy entries (one
  submission per tree, *not* one task per leaf);
- **work queues** — submissions name a ``wq`` key; descriptors on the same
  key execute serially in FIFO order (a dedicated WQ), distinct keys run
  concurrently on the worker pool (shared engines behind the WQs), and a
  stalled queue never head-of-line blocks the others: a build that cannot
  proceed (full ring) raises :class:`WouldBlock` and the engine *parks*
  that queue with a retry deadline instead of letting the worker wait
  inside it;
- **batched doorbells** — a submitter only "rings" (condition notify) when
  its queue goes non-empty; submissions that land while the engine is
  already busy piggyback on the outstanding doorbell
  (``stats.submitted - stats.doorbells`` = doorbells saved by batching);
- **completion records** — every submission returns a :class:`CopyJob`
  whose ``wait()`` applies the repo-wide hybrid polling (size-aware
  deferral from the calibrated latency model, then short passive waits);
- **cache-injection hint** — per-descriptor ``injection`` tags the copy
  *temporal* (the paper's LLC-injection path: the consumer finds the
  bytes warm) or *streaming* (data not re-read soon; on hardware this
  would use non-temporal stores).  numpy exposes no non-temporal store,
  so the hint drives the per-kind counters the benchmarks read rather
  than a different copy loop (see ``_copy_entry`` for why a chunked
  Python-level "streaming" loop is actively harmful under the GIL).
  The default follows
  :meth:`repro_torch.core.policy.OffloadPolicy.injection_enabled`.

Every memcpy the runtime performs on a datapath — engine staging, channel
sends, receive-side unpack copies, dispatcher batch gathers, reply slot
fills — is executed or at least *counted* here, tagged by path, which is
what makes copies-per-request a counted (not timed) regression metric
(see ``benchmarks/fig13_copy_path.py`` and ``tests/test_copy_path.py``).

Copied from ``src/repro/core/copyengine.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.latency import LatencyModel
from repro_torch.core.policy import OffloadPolicy
from repro_torch.obs import trace as _trace



# ---------------------------------------------------------------------------
# shared stats (deduplicates the old EngineStats/ChannelStats copy-paste)
# ---------------------------------------------------------------------------

@dataclass
class HybridPollStats:
    """Hybrid-polling + offload-split counters shared by every movement
    path (tier-1 engine, IPC channels, copy-engine jobs): one dataclass
    instead of per-layer copy-pasted fields."""
    inline: int = 0              # below-threshold/sync work done by the caller
    offloaded: int = 0           # submissions delegated to an engine thread
    polls: int = 0               # completion-flag checks after deferral
    deferred_sleep_s: float = 0.0   # predicted-latency sleeps (hidden time)
    blocked_wait_s: float = 0.0     # residual synchronous waiting

    def snapshot(self) -> dict:
        """A plain-dict copy (for logging/benchmark rows)."""
        return dict(self.__dict__)


@dataclass
class CopyEngineStats(HybridPollStats):
    """Engine-wide submission/copy/doorbell counters, plus per-tag copy
    and byte counts (``tagged``/``tagged_bytes``) for the counted
    copies-per-request metric."""
    submitted: int = 0           # descriptors submitted
    completed: int = 0
    failed: int = 0
    sg_entries: int = 0          # leaf copy entries across all descriptors
    copies: int = 0              # memcpys executed/accounted
    bytes_copied: int = 0
    temporal: int = 0            # cache-injected (plain copyto) copies
    streaming: int = 0           # chunked streaming copies
    doorbells: int = 0           # times a submitter actually rang
    wakeups: int = 0             # worker wakeups that found work
    parked: int = 0              # WouldBlock retries (stalled-queue backoff)
    tagged: dict = field(default_factory=lambda: defaultdict(int))
    tagged_bytes: dict = field(default_factory=lambda: defaultdict(int))
    # counted control-plane events (no timing): integrated paths report
    # e.g. coalesced frames/messages and per-send pickle calls here so
    # doorbells-per-message and pickle-calls-per-send are process-wide
    # counted metrics the CI gate can read, like copies-per-request
    events: dict = field(default_factory=lambda: defaultdict(int))

    def snapshot(self) -> dict:
        """Plain-dict copy with the tag maps materialized."""
        out = dict(self.__dict__)
        out["tagged"] = dict(self.tagged)
        out["tagged_bytes"] = dict(self.tagged_bytes)
        out["events"] = dict(self.events)
        return out


# ---------------------------------------------------------------------------
# scatter-gather descriptors
# ---------------------------------------------------------------------------

class WouldBlock(Exception):
    """Raised by ``Descriptor.build`` when its resource (typically a ring
    slot) is not available yet: the engine *parks* the work queue and
    retries after ``retry_after_s`` instead of letting a worker thread
    block inside the build — so a stalled channel (full ring, slow
    consumer) costs zero engine workers and can never head-of-line block
    the other datapaths."""

    def __init__(self, retry_after_s: float = 5e-4):
        super().__init__(f"resource not ready; retry in {retry_after_s}s")
        self.retry_after_s = retry_after_s


class SGEntry:
    """One leaf copy: contiguous ``src`` bytes into same-size ``dst``."""

    __slots__ = ("src", "dst", "nbytes")

    def __init__(self, src: np.ndarray, dst: np.ndarray, nbytes: int):
        self.src = src
        self.dst = dst
        self.nbytes = nbytes


class SGList:
    """A scatter-gather list: the copy entries of one descriptor, plus a
    free-form ``ctx`` slot the prologue can use to pass state (a slot
    writer, a staged tree) to the completion callback."""

    __slots__ = ("entries", "nbytes", "ctx")

    def __init__(self):
        self.entries: list[SGEntry] = []
        self.nbytes = 0
        self.ctx: Any = None

    def add(self, src, dst) -> None:
        """Append one entry; ``src`` is flattened to a contiguous u8 view,
        ``dst`` may be an ndarray or a writable buffer slice."""
        src = np.asarray(src)
        if not src.flags["C_CONTIGUOUS"]:
            src = np.ascontiguousarray(src)
        self.entries.append(SGEntry(src, dst, src.nbytes))
        self.nbytes += src.nbytes

    def add_array(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Append a same-shape array→array entry (no flattening), for
        gathers into typed batch-buffer slices."""
        self.entries.append(SGEntry(src, dst, np.asarray(src).nbytes))
        self.nbytes += np.asarray(src).nbytes

    def __len__(self) -> int:
        return len(self.entries)


def split_sg(sg: SGList, chunk_bytes: int) -> list[SGList]:
    """Split one SG list into <= ``chunk_bytes`` chunks for pipelined
    submission (the heap fill path: each chunk is its own descriptor on
    the same work queue, so FIFO holds while completion granularity and
    doorbell batching stay fine-grained on multi-hundred-MB payloads).

    Entries must be flat same-length uint8 views (how the heap fill builds
    them); a logical copy split across chunks is *accounted* once by the
    submitter via ``count_copies``, not once per chunk.
    """
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    chunks: list[SGList] = [SGList()]
    for e in sg.entries:
        if e.src.dtype != np.uint8 or e.src.ndim != 1:
            raise ValueError("split_sg requires flat uint8 entries")
        off = 0
        while off < e.nbytes:
            cur = chunks[-1]
            take = min(chunk_bytes - cur.nbytes, e.nbytes - off)
            if take <= 0:
                chunks.append(SGList())
                continue
            cur.entries.append(SGEntry(e.src[off:off + take],
                                       e.dst[off:off + take], take))
            cur.nbytes += take
            off += take
    return [c for c in chunks if c.entries]


class Descriptor:
    """One submission: an SG list (given up front or built late by
    ``build`` on the engine thread — e.g. after a blocking slot acquire),
    an optional ``complete`` callback (publish/doorbell; its return value
    becomes the job result), an ``injection`` hint, and a path ``tag``."""

    __slots__ = ("sg", "build", "complete", "nbytes", "injection", "tag",
                 "count_copies")

    def __init__(self, sg: Optional[SGList] = None,
                 build: Optional[Callable[[], Optional[SGList]]] = None,
                 complete: Optional[Callable[[Optional[SGList]], Any]] = None,
                 nbytes: int = 0, injection: Optional[bool] = None,
                 tag: str = "copy", count_copies: Optional[int] = None):
        self.sg = sg
        self.build = build
        self.complete = complete
        self.nbytes = nbytes
        self.injection = injection
        self.tag = tag
        # logical copies this descriptor represents (default: one per SG
        # entry).  Chunked submissions — one leaf split over many entries/
        # descriptors — pass the leaf count here so copies-per-request
        # stays a *logical* counted metric (bytes stay exact either way).
        self.count_copies = count_copies


# ---------------------------------------------------------------------------
# completion records
# ---------------------------------------------------------------------------

class CopyJob:
    """Completion record for one descriptor (the paper's completion flag +
    job id); ``wait()`` is the hybrid-polling check shared by the tier-1
    engine's :class:`~repro_torch.core.engine.TransferJob` and the channels'
    :class:`~repro_torch.ipc.channel.SendHandle`."""

    _ids = itertools.count()

    def __init__(self, nbytes: int, policy: OffloadPolicy,
                 latency: LatencyModel,
                 stats: Optional[HybridPollStats] = None):
        self.job_id = next(self._ids)
        self.nbytes = nbytes
        self.submit_t = time.perf_counter()
        self.finished_t: Optional[float] = None
        self._policy = policy
        self._latency = latency
        self._stats = stats
        self._event = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None

    # -- engine side ----------------------------------------------------------
    def _finish(self, value: Any) -> None:
        self._value = value
        # completion-record timestamp: submit_t..finished_t is the
        # submitter-visible cost of the offloaded route (queue wait + copy
        # + publish), the feedback the adaptive governor learns from —
        # no extra clock reads on the submitter's hot path
        self.finished_t = time.perf_counter()
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self.finished_t = time.perf_counter()
        self._event.set()

    # -- submitter side -------------------------------------------------------
    def done(self) -> bool:
        """True once the engine posted the completion record (never blocks)."""
        return self._event.is_set()

    def failed(self) -> bool:
        """True when the descriptor completed with an exception."""
        return self._event.is_set() and self._exc is not None

    def wait(self, timeout_s: float = 30.0) -> Any:
        """Hybrid-polling completion: size-aware deferral (sleep most of
        the predicted copy latency), a short yield-only spin, then passive
        ``poll_interval_us`` waits; raises the descriptor's exception or
        ``TimeoutError``."""
        if not self._event.is_set():
            stats = self._stats
            pol, lat = self._policy, self._latency
            if self.nbytes > 0:
                pred = lat.defer_seconds(self.nbytes, pol.defer_fraction)
                remain = pred - (time.perf_counter() - self.submit_t)
                if remain > 0:
                    remain = min(remain, timeout_s)
                    time.sleep(remain)
                    if stats is not None:
                        stats.deferred_sleep_s += remain
            t0 = time.perf_counter()
            deadline = t0 + timeout_s
            spin_deadline = t0 + pol.spin_us * 1e-6
            while not self._event.is_set():          # spin phase
                if stats is not None:
                    stats.polls += 1
                if time.perf_counter() >= spin_deadline:
                    break
                time.sleep(0)
            quantum = pol.poll_interval_us * 1e-6
            while not self._event.is_set():          # quantum phase (UMWAIT)
                if stats is not None:
                    stats.polls += 1
                if time.perf_counter() > deadline:
                    if stats is not None:
                        stats.blocked_wait_s += time.perf_counter() - t0
                    raise TimeoutError(
                        f"copy job {self.job_id} not complete in {timeout_s}s")
                self._event.wait(quantum)
            if stats is not None:
                stats.blocked_wait_s += time.perf_counter() - t0
        if self._exc is not None:
            raise self._exc
        return self._value


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class CopyEngine:
    """Process-wide copy engine: work queues + worker pool + completion
    records.  Construct directly for tests; production code shares one
    instance via :func:`get_engine`."""

    def __init__(self, policy: Optional[OffloadPolicy] = None,
                 latency: Optional[LatencyModel] = None, workers: int = 4):
        self.policy = policy or OffloadPolicy()
        self.latency = latency or LatencyModel()
        self.stats = CopyEngineStats()
        self._queues: dict = {}            # wq key -> deque[(descr, job)]
        self._ready: deque = deque()       # keys with work, no active worker
        self._parked: dict = {}            # wq key -> retry-not-before time
        self._active: set = set()
        self._cv = threading.Condition()
        self._stop = False
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"rocket-copyeng-{i}")
            for i in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    # -- copy execution (also used inline via run_sg) -------------------------
    def _copy_entry(self, e: SGEntry, streaming: bool) -> None:
        # the injection hint selects *accounting* (temporal vs streaming
        # counters), not a different copy loop: numpy has no non-temporal
        # stores, and a Python-level chunk loop re-acquires the GIL between
        # chunks — with any other thread runnable (a client's receiver, the
        # reactor) each re-acquisition can wait out the 5 ms GIL switch
        # interval, turning a ~1 ms 4 MB copy into ~25 ms (measured).  One
        # copyto = one GIL release = full memcpy bandwidth.
        del streaming
        src, dst = e.src, e.dst
        if isinstance(dst, np.ndarray) and dst.shape == src.shape:
            np.copyto(dst, src)
        else:
            np.copyto(dst, src.reshape(-1).view(np.uint8))

    def run_sg(self, sg: SGList, injection: Optional[bool] = None,
               tag: str = "copy", count_copies: Optional[int] = None,
               account: bool = True) -> None:
        """Execute an SG list on the *caller's* thread (inline/below-
        threshold paths), with the same injection selection and counting
        as an offloaded descriptor.  ``count_copies`` overrides the
        logical copy count (chunked fills: one leaf, many entries).
        ``account=False`` skips the counter update — for per-message
        copies inside a coalesced frame, which the channel accounts once
        per frame via :meth:`count` (identical totals, one engine-lock
        round-trip instead of K on the small-message hot path)."""
        inject = (self.policy.injection_enabled() if injection is None
                  else injection)
        t0 = _trace.now() if _trace.TRACE.enabled else 0
        for e in sg.entries:
            self._copy_entry(e, streaming=not inject)
        if t0:
            _trace.emit(_trace.COPY_JOB, t0,
                        arg=min(sg.nbytes, 0xFFFFFFFF))
        if account:
            self._account(sg.entries, sg.nbytes, inject, tag, count_copies)

    def count_event(self, name: str, n: int = 1) -> None:
        """Count a control-plane event (frame published, message coalesced,
        meta pickle call) — the non-copy analogue of :meth:`count`, read by
        the benchmark gates as a timing-independent metric."""
        with self._cv:
            self.stats.events[name] += n

    def count(self, tag: str, copies: int, nbytes: int,
              injection: bool = True) -> None:
        """Account copies performed by an integrated path without routing
        the memcpy itself through the engine (e.g. ``recv(copy=True)``
        unpack copies) — keeps the copies-per-request metric complete."""
        with self._cv:
            self.stats.copies += copies
            self.stats.bytes_copied += nbytes
            if injection:
                self.stats.temporal += copies
            else:
                self.stats.streaming += copies
            self.stats.tagged[tag] += copies
            self.stats.tagged_bytes[tag] += nbytes

    def _account(self, entries, nbytes: int, inject: bool, tag: str,
                 count: Optional[int] = None) -> None:
        count = len(entries) if count is None else count
        with self._cv:
            self.stats.sg_entries += len(entries)
            self.stats.copies += count
            self.stats.bytes_copied += nbytes
            if inject:
                self.stats.temporal += count
            else:
                self.stats.streaming += count
            self.stats.tagged[tag] += count
            self.stats.tagged_bytes[tag] += nbytes

    # -- submission -----------------------------------------------------------
    def submit(self, descr: Descriptor, wq: Any = None,
               policy: Optional[OffloadPolicy] = None,
               latency: Optional[LatencyModel] = None,
               stats: Optional[HybridPollStats] = None) -> CopyJob:
        """Queue one descriptor (ENQCMD analogue) and return its completion
        record.  ``wq`` keys serialize: descriptors on the same key run
        FIFO; ``wq=None`` gives the descriptor a private key (unordered,
        maximally parallel).  ``policy``/``latency``/``stats`` configure
        the *submitter's* hybrid-polling wait and counters."""
        job = CopyJob(descr.nbytes, policy or self.policy,
                      latency or self.latency, stats)
        key = object() if wq is None else wq
        with self._cv:
            if self._stop:
                raise RuntimeError("CopyEngine is closed")
            self.stats.submitted += 1
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
            q.append((descr, job))
            # batched doorbell: ring only when this key just became
            # runnable — work landing behind an outstanding doorbell (or an
            # active worker) piggybacks without a second ring
            if key not in self._active and len(q) == 1:
                self._ready.append(key)
                self.stats.doorbells += 1
                self._cv.notify()
        return job

    # -- worker loop ----------------------------------------------------------
    def _execute(self, descr: Descriptor, job: CopyJob) -> Optional[float]:
        """Run one descriptor; returns a retry delay when its build parked
        (WouldBlock), None when the job completed (either way)."""
        try:
            sg = descr.sg
            if descr.build is not None:
                built = descr.build()
                sg = built if sg is None else sg
            if sg is not None and len(sg):
                inject = (self.policy.injection_enabled()
                          if descr.injection is None else descr.injection)
                t0 = _trace.now() if _trace.TRACE.enabled else 0
                for e in sg.entries:
                    self._copy_entry(e, streaming=not inject)
                if t0:
                    _trace.emit(_trace.COPY_JOB, t0,
                                arg=min(sg.nbytes, 0xFFFFFFFF))
                self._account(sg.entries, sg.nbytes, inject, descr.tag,
                              descr.count_copies)
            value = descr.complete(sg) if descr.complete is not None else None
            with self._cv:
                self.stats.completed += 1
            job._finish(value)
        except WouldBlock as wb:                 # park: retry, don't block
            return wb.retry_after_s
        except BaseException as e:               # completion carries the error
            with self._cv:
                self.stats.failed += 1
            job._fail(e)
        # drop the descriptor's buffer exports now: an idle worker's loop
        # locals would otherwise pin shared-memory views (slot writers,
        # heap extents) until the next submission, turning transport close
        # into a BufferError
        descr.sg = descr.build = descr.complete = None
        return None

    def _pop_ready(self) -> Optional[tuple]:
        """Under the cv: next (key, descr, job) to run, unparking due keys;
        None when nothing is runnable (caller computes the wait)."""
        now = time.perf_counter()
        for key in [k for k, t in self._parked.items() if t <= now]:
            del self._parked[key]
            self._ready.append(key)
        if not self._ready:
            return None
        key = self._ready.popleft()
        self._active.add(key)
        descr, job = self._queues[key].popleft()
        self.stats.wakeups += 1
        return key, descr, job

    def _worker(self) -> None:
        while True:
            with self._cv:
                while True:
                    item = self._pop_ready()
                    if item is not None or self._stop:
                        break
                    wait = 0.1
                    if self._parked:
                        wait = min(wait, max(
                            1e-4, min(self._parked.values())
                            - time.perf_counter()))
                    self._cv.wait(wait)
                if item is None:                 # stopping, nothing runnable
                    if self._parked:             # fail parked work loudly
                        for key in list(self._parked):
                            del self._parked[key]
                            for descr, job in self._queues.pop(key, ()):
                                job._fail(RuntimeError(
                                    "CopyEngine closed while the submission "
                                    "waited for its resource"))
                        continue
                    return
                key, descr, job = item
            retry_after = self._execute(descr, job)
            with self._cv:
                self._active.discard(key)
                if retry_after is not None:      # parked: keep FIFO, back off
                    self._queues[key].appendleft((descr, job))
                    self._parked[key] = time.perf_counter() + retry_after
                    self.stats.parked += 1
                    self._cv.notify()            # sleepers recompute waits
                    continue
                q = self._queues.get(key)
                if q:
                    self._ready.append(key)
                    self._cv.notify()
                else:
                    self._queues.pop(key, None)

    # -- introspection / lifecycle --------------------------------------------
    def tagged_snapshot(self) -> dict:
        """Copy/byte counts per path tag (stable dict copies)."""
        with self._cv:
            return {"copies": dict(self.stats.tagged),
                    "bytes": dict(self.stats.tagged_bytes)}

    def queue_depth(self) -> int:
        """Descriptors queued but not yet picked up (all work queues)."""
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the workers after the queues drain (owned engines only —
        never call on the shared :func:`get_engine` instance mid-flight)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# the process-wide instance
# ---------------------------------------------------------------------------

_default: Optional[CopyEngine] = None
_default_lock = threading.Lock()


def get_engine() -> CopyEngine:
    """The process-wide engine every datapath shares (created lazily, so
    spawned children build their own on first use)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = CopyEngine()
    return _default


def set_engine(engine: Optional[CopyEngine]) -> Optional[CopyEngine]:
    """Swap the process-wide engine (tests); returns the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, engine
    return prev
