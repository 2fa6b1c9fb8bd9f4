"""Hardware-witness plane: `perf_event_open` counters for the hot path.

The paper states its efficiency claims in *instructions* and *LLC
behavior*; wall clock on a small shared CI host swings ~5x.  This module
gives every phase of the serving hot path a hardware witness — counter
deltas read around the same scopes the span tracer times — with the
same disciplines as the rest of `repro_torch.obs`:

- **Zero dependencies.**  The binding is raw ctypes `syscall(2)` +
  `read(2)` + `ioctl(2)`; no `perf` binary, no python-perf, nothing to
  install.
- **One `read()` per scope.**  Counters open as one *group*
  (`PERF_FORMAT_GROUP`) per thread, so a scope boundary costs a single
  syscall returning every counter at once.
- **Graceful degradation, counted.**  Capability is probed once and
  every reading carries its *witness tier*:

  ========== =====================================================
  tier       source
  ========== =====================================================
  `perf-hw`  perf group led by a hardware event (instructions,
             cycles, LLC loads/misses + software events)
  `perf-sw`  perf syscall works but the PMU is hidden (typical VM):
             task-clock, context-switches, page-faults only
  `rusage`   `getrusage(RUSAGE_THREAD)` + `/proc/thread-self/
             schedstat` (paranoid level / seccomp forbids perf)
  `none`     nothing available — scopes are *counted* as
             unavailable, never silently dropped
  ========== =====================================================

- **Disabled means zero.**  Profiling off (the default) costs one
  attribute check per instrumented site (`PROF.enabled`); no fd is ever
  opened and `scope_count()` stays exactly 0 — the same counted
  contract as `trace.emitted_count()`.

When span tracing is *also* enabled, every accounted scope additionally
emits its counter deltas as ordinary 32-byte records on the per-thread
trace rings (kinds ≥ `trace.CTR_FIRST`, delta stored as `t1 - t0`, the
phase kind in `arg`, the request id in `rid`) — so counters join the
cross-process trace export with no new machinery.

Usage::

    from repro_torch.obs import hwcounters as hw

    hw.enable()                       # children spawned after this inherit
    run_workload()
    print(hw.snapshot()["phases"])    # per-phase counter totals
    hw.disable()

Benchmarks that measure a closed region directly (not the serving hot
path) use a standalone :class:`Meter`, which works at the probed tier
regardless of `PROF.enabled`::

    m = hw.Meter()
    with m:
        busy_section()
    m.totals["task_clock_ns"], m.tier

CLI (the CI capability probe)::

    python -m repro_torch.obs.hwcounters --probe --smoke

Copied from ``src/repro/obs/hwcounters.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import platform
import struct
import threading
import time
from typing import Optional

from repro_torch.obs import trace as _trace

# -- perf_event_open ABI ------------------------------------------------------

# syscall numbers by architecture (perf_event_open)
_SYSCALL_NR = {
    "x86_64": 298, "i686": 336, "i386": 336,
    "aarch64": 241, "arm64": 241, "riscv64": 241,
    "ppc64le": 319, "ppc64": 319, "s390x": 331,
}

PERF_TYPE_HARDWARE = 0
PERF_TYPE_SOFTWARE = 1
PERF_TYPE_HW_CACHE = 3

# PERF_TYPE_HARDWARE configs
_HW_CPU_CYCLES = 0
_HW_INSTRUCTIONS = 1
# PERF_TYPE_SOFTWARE configs
_SW_TASK_CLOCK = 1
_SW_PAGE_FAULTS = 2
_SW_CTX_SWITCHES = 3
# PERF_TYPE_HW_CACHE config = id | (op << 8) | (result << 16); LL=2,
# READ=0, ACCESS=0, MISS=1
_LLC_LOADS = 2
_LLC_MISSES = 2 | (1 << 16)

PERF_FORMAT_TOTAL_TIME_ENABLED = 1 << 0
PERF_FORMAT_TOTAL_TIME_RUNNING = 1 << 1
PERF_FORMAT_GROUP = 1 << 3

_IOC_ENABLE = 0x2400
_IOC_RESET = 0x2403
_IOC_FLAG_GROUP = 1

# perf_event_attr, version 0 (64 bytes): type, size, config,
# sample_period, sample_type, read_format, flags bitfield, then two u32
# (wakeup_events, bp_type) we leave zero.  Flags: disabled(0) on the
# leader only, exclude_kernel(5), exclude_hv(6).
_ATTR_SIZE = 64
_ATTR_FMT = "<IIQQQQQII"
_FLAG_DISABLED = 1 << 0
_FLAG_EXCLUDE_KERNEL = 1 << 5
_FLAG_EXCLUDE_HV = 1 << 6

# Counter name → (perf type, config, needs-PMU).  Order is group order:
# the first *openable* event becomes the group leader.
EVENTS = (
    ("instructions", PERF_TYPE_HARDWARE, _HW_INSTRUCTIONS, True),
    ("cycles", PERF_TYPE_HARDWARE, _HW_CPU_CYCLES, True),
    ("llc_loads", PERF_TYPE_HW_CACHE, _LLC_LOADS, True),
    ("llc_misses", PERF_TYPE_HW_CACHE, _LLC_MISSES, True),
    ("task_clock_ns", PERF_TYPE_SOFTWARE, _SW_TASK_CLOCK, False),
    ("ctx_sw", PERF_TYPE_SOFTWARE, _SW_CTX_SWITCHES, False),
    ("page_faults", PERF_TYPE_SOFTWARE, _SW_PAGE_FAULTS, False),
)

#: every counter name any tier may report (rusage adds sched_wait_ns)
COUNTER_NAMES = tuple(e[0] for e in EVENTS) + ("sched_wait_ns",)

TIERS = ("perf-hw", "perf-sw", "rusage", "none")

#: env flag a parent sets so spawned children profile into the same run
ENV_FLAG = "ROCKET_HWPROF"
#: env override capping the tier (degrade-only; tests use it)
ENV_TIER = "ROCKET_HWPROF_TIER"

# serving-phase name → trace span kind (the `arg` of counter records)
PHASES = {
    "ring_poll": _trace.REACTOR_DRAIN,
    "batch_wait": _trace.DISPATCH_WAIT,
    "sg_gather": _trace.GATHER,
    "lease_hold": _trace.LEASE_HOLD,
    "handler": _trace.HANDLER,
    "reserve_fill": _trace.REPLY_FILL,
    "publish": _trace.CH_PUBLISH,
    "governor": _trace.GOV_DECIDE,
    "reply_drain": _trace.CLIENT_RECV,
}
_PHASE_BY_KIND = {v: k for k, v in PHASES.items()}

_libc = None


def _get_libc():
    """The process libc (cached) for raw `syscall(2)` / `ioctl(2)`."""
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                            use_errno=True)
    return _libc


def _perf_open(typ: int, config: int, group_fd: int, leader: bool,
               exclude_kernel: bool = True) -> int:
    """One `perf_event_open` for the calling thread (pid=0, cpu=-1).

    Returns the fd, or ``-errno`` on failure (never raises)."""
    nr = _SYSCALL_NR.get(platform.machine())
    if nr is None:
        return -38                                   # ENOSYS
    flags = 0
    if exclude_kernel:
        flags |= _FLAG_EXCLUDE_KERNEL | _FLAG_EXCLUDE_HV
    read_format = (PERF_FORMAT_GROUP | PERF_FORMAT_TOTAL_TIME_ENABLED
                   | PERF_FORMAT_TOTAL_TIME_RUNNING)
    if leader:
        flags |= _FLAG_DISABLED
    attr = struct.pack(_ATTR_FMT, typ, _ATTR_SIZE, config,
                       0, 0, read_format, flags, 0, 0)
    buf = ctypes.create_string_buffer(attr, _ATTR_SIZE)
    libc = _get_libc()
    ctypes.set_errno(0)
    fd = libc.syscall(nr, ctypes.byref(buf), 0, -1, group_fd, 0)
    if fd < 0:
        return -(ctypes.get_errno() or 1)
    return fd


def _open_event(name: str, typ: int, config: int, group_fd: int,
                leader: bool) -> int:
    """Open one event with the permission-degradation policy.

    Prefer counting user+kernel (syscall cost belongs to the phase that
    paid it); when the paranoid level forbids that, retry user-only —
    except for ``ctx_sw``, which counts *nothing* in user-only mode
    (switches happen in the kernel), so a kernel-excluded open would be
    a zero that looks like a reading.  Such hosts get ctx_sw
    supplemented from `getrusage` instead."""
    fd = _perf_open(typ, config, group_fd, leader, exclude_kernel=False)
    if fd >= 0:
        return fd
    if name == "ctx_sw":
        return -13                                   # EACCES: use rusage
    return _perf_open(typ, config, group_fd, leader, exclude_kernel=True)


# -- capability probe ---------------------------------------------------------

class Capability:
    """What the host lets us count: resolved tier + probe evidence."""

    def __init__(self, tier: str, paranoid: Optional[int],
                 events: tuple, errors: dict, forced: Optional[str] = None):
        self.tier = tier
        self.paranoid = paranoid          # /proc/sys/kernel/perf_event_paranoid
        self.events = events              # counter names the tier provides
        self.errors = errors              # event name → errno of failed open
        self.forced = forced              # ENV_TIER cap, if it applied

    def to_dict(self) -> dict:
        """JSON-serializable form (recorded into bench artifacts)."""
        return {"tier": self.tier, "paranoid": self.paranoid,
                "events": list(self.events),
                "errors": {k: v for k, v in self.errors.items()},
                "forced": self.forced}

    def __repr__(self) -> str:
        return f"Capability(tier={self.tier!r}, events={self.events!r})"


def _read_paranoid() -> Optional[int]:
    """Current `perf_event_paranoid`, or None off-Linux."""
    try:
        with open("/proc/sys/kernel/perf_event_paranoid") as f:
            return int(f.read().strip())
    except OSError:
        return None


def _rusage_works() -> bool:
    """True when per-thread getrusage is available (Linux)."""
    try:
        import resource
        resource.getrusage(resource.RUSAGE_THREAD)
        return True
    except Exception:
        return False


_CAP: Optional[Capability] = None
_CAP_LOCK = threading.Lock()


def probe(refresh: bool = False) -> Capability:
    """Probe (once, cached) what this host can count.

    Opens a throwaway perf group on the calling thread and closes it;
    applies the ``ROCKET_HWPROF_TIER`` degrade-only cap."""
    global _CAP
    with _CAP_LOCK:
        if _CAP is not None and not refresh:
            return _CAP
        errors: dict = {}
        opened: list = []
        fds: list = []
        group_fd = -1
        for name, typ, config, _hw in EVENTS:
            fd = _open_event(name, typ, config, group_fd,
                             leader=group_fd == -1)
            if fd < 0:
                errors[name] = os.strerror(-fd)
                continue
            fds.append(fd)
            opened.append(name)
            if group_fd == -1:
                group_fd = fd
        for fd in fds:
            os.close(fd)
        if opened and "ctx_sw" not in opened and _rusage_works():
            opened.append("ctx_sw")      # supplemented from getrusage
            errors["ctx_sw"] = errors.get("ctx_sw", "") + " (using rusage)"
        hw_names = {e[0] for e in EVENTS if e[3]}
        if any(n in hw_names for n in opened):
            tier, events = "perf-hw", tuple(opened)
        elif opened:
            tier, events = "perf-sw", tuple(opened)
        elif _rusage_works():
            tier = "rusage"
            events = ("task_clock_ns", "ctx_sw", "page_faults",
                      "sched_wait_ns")
        else:
            tier, events = "none", ()
        forced = os.environ.get(ENV_TIER)
        if forced in TIERS and TIERS.index(forced) > TIERS.index(tier):
            tier = forced                            # degrade only
            if tier == "rusage":
                events = (("task_clock_ns", "ctx_sw", "page_faults",
                           "sched_wait_ns") if _rusage_works() else ())
                if not events:
                    tier = "none"
            elif tier == "none":
                events = ()
            elif tier == "perf-sw":
                events = tuple(n for n in opened if n not in hw_names)
        else:
            forced = None
        _CAP = Capability(tier, _read_paranoid(), events, errors, forced)
        return _CAP


# -- per-thread readers -------------------------------------------------------

class _PerfReader:
    """One thread's enabled perf group; `read()` is a single syscall
    (plus one `getrusage` when ctx_sw needs supplementing — see
    :func:`_open_event`)."""

    __slots__ = ("fds", "names", "_size", "_res")

    def __init__(self, names):
        self.fds: list = []
        self.names: tuple = ()
        got = []
        group_fd = -1
        for name, typ, config, _hw in EVENTS:
            if name not in names:
                continue
            fd = _open_event(name, typ, config, group_fd,
                             leader=group_fd == -1)
            if fd < 0:
                continue
            self.fds.append(fd)
            got.append(name)
            if group_fd == -1:
                group_fd = fd
        self._res = None
        if got and "ctx_sw" not in got and _rusage_works():
            import resource
            self._res = resource
            got.append("ctx_sw")
        self.names = tuple(got)
        if group_fd >= 0:
            libc = _get_libc()
            libc.ioctl(group_fd, _IOC_RESET, _IOC_FLAG_GROUP)
            libc.ioctl(group_fd, _IOC_ENABLE, _IOC_FLAG_GROUP)
        # group read layout: nr, time_enabled, time_running, value×nr
        self._size = 8 * (3 + len(self.fds))

    def read(self) -> Optional[tuple]:
        """Raw cumulative counter values, group-ordered (one syscall)."""
        if not self.fds:
            return None
        try:
            buf = os.read(self.fds[0], self._size)
        except OSError:
            return None
        vals = struct.unpack_from(f"<{len(buf) // 8}Q", buf)
        # vals = (nr, enabled, running, v0, v1, ...); with one group and
        # ≤7 events there is no multiplexing, so values are exact
        out = vals[3:3 + len(self.fds)]
        if self._res is not None:
            ru = self._res.getrusage(self._res.RUSAGE_THREAD)
            out = out + (ru.ru_nvcsw + ru.ru_nivcsw,)
        return out

    def close(self) -> None:
        """Close the group's fds (idempotent)."""
        fds, self.fds = self.fds, []
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass


class _RusageReader:
    """Fallback tier: `getrusage(RUSAGE_THREAD)` + thread schedstat."""

    __slots__ = ("names", "_res", "_sched_fd")

    def __init__(self):
        import resource
        self._res = resource
        self.names = ("task_clock_ns", "ctx_sw", "page_faults",
                      "sched_wait_ns")
        try:
            self._sched_fd = os.open("/proc/thread-self/schedstat",
                                     os.O_RDONLY)
        except OSError:
            self._sched_fd = -1

    def read(self) -> Optional[tuple]:
        """Cumulative (cpu_ns, ctx switches, faults, runqueue-wait ns)."""
        r = self._res
        try:
            ru = r.getrusage(r.RUSAGE_THREAD)
        except Exception:
            return None
        wait_ns = 0
        if self._sched_fd >= 0:
            try:
                parts = os.pread(self._sched_fd, 128, 0).split()
                wait_ns = int(parts[1])
            except (OSError, IndexError, ValueError):
                pass
        return (int((ru.ru_utime + ru.ru_stime) * 1e9),
                ru.ru_nvcsw + ru.ru_nivcsw,
                ru.ru_minflt + ru.ru_majflt,
                wait_ns)

    def close(self) -> None:
        """Release the schedstat fd (idempotent)."""
        fd, self._sched_fd = self._sched_fd, -1
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass


class _NoneReader:
    """Tier `none`: reads return nothing, scopes still get counted."""

    __slots__ = ()
    names: tuple = ()

    def read(self) -> Optional[tuple]:
        """Always None — the accounting layer counts it as unavailable."""
        return None

    def close(self) -> None:
        """Nothing to release."""


def _make_reader(cap: Capability):
    """Build the per-thread reader matching the resolved tier."""
    if cap.tier in ("perf-hw", "perf-sw"):
        r = _PerfReader(cap.events)
        if r.names:
            return r
        r.close()                          # raced with a capability change
    if cap.tier in ("perf-hw", "perf-sw", "rusage") and _rusage_works():
        return _RusageReader()
    return _NoneReader()


# -- profiler state & accounting ---------------------------------------------

class _ProfState(threading.local):
    """Module profiling switch + per-thread reader slot.

    ``enabled`` is intentionally *not* thread-local — it lives on the
    class so one `enable()` turns every thread's instrumented sites on
    (the thread-local part is only the lazily-built reader)."""

    enabled = False                        # class attr: process-global
    tier = "none"

    def __init__(self):
        self.reader = None


PROF = _ProfState()

_ACC_LOCK = threading.Lock()
_phases: dict = {}                         # phase → {counter/meta → int}
_scopes = 0                                # accounted scopes (the 0-gate)
_unavailable = 0                           # scopes with no reading (tier none)
_readers: list = []                        # every reader built, for disable()


def _thread_reader():
    """This thread's counter reader, built lazily on first scope."""
    r = PROF.reader
    if r is None:
        r = _make_reader(probe())
        PROF.reader = r
        with _ACC_LOCK:
            _readers.append(r)
    return r


def begin() -> Optional[tuple]:
    """Open a counter scope on the calling thread.

    Hot-path protocol (mirrors the tracer's ``t0 = now() if enabled``):
    call only behind a ``PROF.enabled`` check; pass the token to
    :func:`end`.  Returns None when profiling is disabled."""
    if not _ProfState.enabled:
        return None
    r = _thread_reader()
    return (r, r.read(), time.perf_counter_ns())


def end(token: tuple, phase: str, nbytes: int = 0, rid: int = 0) -> None:
    """Close a scope: account counter deltas to ``phase``.

    With tracing also enabled, each nonzero delta is emitted as a
    counter record on this thread's trace ring (kind per counter,
    ``arg`` = the phase's span kind, duration = the delta)."""
    r, c0, t0 = token
    c1 = r.read()
    t1 = time.perf_counter_ns()
    global _scopes, _unavailable
    with _ACC_LOCK:
        _scopes += 1
        acc = _phases.get(phase)
        if acc is None:
            acc = _phases[phase] = {"count": 0, "bytes": 0, "wall_ns": 0}
        acc["count"] += 1
        acc["bytes"] += nbytes
        acc["wall_ns"] += t1 - t0
        if c0 is None or c1 is None:
            _unavailable += 1
            deltas = ()
        else:
            deltas = tuple(max(b - a, 0) for a, b in zip(c0, c1))
            for name, d in zip(r.names, deltas):
                acc[name] = acc.get(name, 0) + d
    if deltas and _trace.TRACE.enabled:
        kind_arg = PHASES.get(phase, 0)
        for name, d in zip(r.names, deltas):
            if d:
                _trace.emit(_trace.CTR_KINDS[name], t0, rid=rid,
                            arg=kind_arg, t1=t0 + d)


def account_wall(phase: str, t0_ns: int, nbytes: int = 0) -> None:
    """Account a wall-clock-only phase (no counter read).

    Used for `lease_hold`, whose delivery and release happen on
    *different* threads — per-thread counter deltas would be
    meaningless, but the hold time still belongs in the phase table."""
    if not _ProfState.enabled:
        return
    global _scopes
    t1 = time.perf_counter_ns()
    with _ACC_LOCK:
        _scopes += 1
        acc = _phases.get(phase)
        if acc is None:
            acc = _phases[phase] = {"count": 0, "bytes": 0, "wall_ns": 0}
        acc["count"] += 1
        acc["bytes"] += nbytes
        acc["wall_ns"] += t1 - t0_ns


class CounterScope:
    """Context-manager face of :func:`begin`/:func:`end` for cold paths.

    ::

        with hwcounters.CounterScope("handler", nbytes=n, rid=rid):
            run_batch()

    A no-op (no fd, no syscall, no accounting) while profiling is
    disabled — the counted-zero contract."""

    __slots__ = ("phase", "nbytes", "rid", "_token")

    def __init__(self, phase: str, nbytes: int = 0, rid: int = 0):
        self.phase = phase
        self.nbytes = nbytes
        self.rid = rid
        self._token = None

    def __enter__(self) -> "CounterScope":
        if _ProfState.enabled:
            self._token = begin()
        return self

    def __exit__(self, *exc) -> None:
        token, self._token = self._token, None
        if token is not None:
            end(token, self.phase, nbytes=self.nbytes, rid=self.rid)


class Meter:
    """Standalone accumulating counter meter for benchmark sections.

    Independent of `PROF.enabled` — constructing one is the explicit
    opt-in.  Reusable: enter/exit repeatedly and deltas accumulate, so
    a benchmark can meter just its busy sections across many steps.

    Attributes: ``tier`` (witness tier of the readings), ``totals``
    (counter name → accumulated delta, plus ``wall_ns``), ``entries``.
    """

    def __init__(self):
        cap = probe()
        self._reader = _make_reader(cap)
        self.tier = (cap.tier if not isinstance(self._reader, _NoneReader)
                     else "none")
        if isinstance(self._reader, _RusageReader):
            self.tier = "rusage" if cap.tier != "none" else "none"
        self.totals: dict = {"wall_ns": 0}
        self.entries = 0
        self._c0 = None
        self._t0 = 0

    def __enter__(self) -> "Meter":
        self._c0 = self._reader.read()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        c1 = self._reader.read()
        self.totals["wall_ns"] += time.perf_counter_ns() - self._t0
        self.entries += 1
        if self._c0 is not None and c1 is not None:
            for name, a, b in zip(self._reader.names, self._c0, c1):
                self.totals[name] = self.totals.get(name, 0) + max(b - a, 0)
        self._c0 = None

    def close(self) -> None:
        """Release the meter's fds."""
        self._reader.close()


# -- lifecycle ----------------------------------------------------------------

def enable(tier: Optional[str] = None) -> str:
    """Turn phase profiling on; returns the resolved witness tier.

    Exports ``ROCKET_HWPROF=1`` (and the tier cap, if given) so
    processes spawned afterwards profile too.  ``tier`` can only
    degrade below the probed capability — you cannot force `perf-hw`
    on a host without a PMU."""
    if tier is not None:
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r} (expected {TIERS})")
        os.environ[ENV_TIER] = tier
        probe(refresh=True)
    cap = probe()
    _ProfState.enabled = True
    _ProfState.tier = cap.tier
    os.environ[ENV_FLAG] = "1"
    return cap.tier


def disable() -> None:
    """Turn profiling off and release every thread's counter fds.

    Accumulated phase totals survive (read them with :func:`snapshot`);
    :func:`reset` clears them."""
    _ProfState.enabled = False
    os.environ.pop(ENV_FLAG, None)
    os.environ.pop(ENV_TIER, None)
    with _ACC_LOCK:
        readers, _readers[:] = _readers[:], []
    for r in readers:
        r.close()
    PROF.reader = None


def reset() -> None:
    """Zero the phase accumulators and the scope/unavailable counts."""
    global _scopes, _unavailable
    with _ACC_LOCK:
        _phases.clear()
        _scopes = 0
        _unavailable = 0


def maybe_enable_from_env() -> bool:
    """Child-process half of env inheritance: enable iff the parent did.

    Called at fabric/worker startup (mirrors the tracer's env
    handshake); returns whether profiling is now on."""
    if os.environ.get(ENV_FLAG) == "1" and not _ProfState.enabled:
        enable()
    return _ProfState.enabled


def scope_count() -> int:
    """Scopes accounted since the last :func:`reset` (0 when disabled —
    the counted contract `--check` gates on)."""
    with _ACC_LOCK:
        return _scopes


def snapshot() -> dict:
    """Current profile: tier, scope counts, per-phase counter totals.

    Nested-dict shape flattens under `MetricsRegistry` to keys like
    ``hw.phases.sg_gather.instructions``.  Phases with recorded bytes
    also report ``insn_per_byte`` / ``llc_miss_per_byte`` when the tier
    provides those counters."""
    cap = probe()
    with _ACC_LOCK:
        phases = {p: dict(acc) for p, acc in _phases.items()}
        scopes, unavailable = _scopes, _unavailable
    for acc in phases.values():
        b = acc.get("bytes", 0)
        if b > 0:
            if acc.get("instructions"):
                acc["insn_per_byte"] = round(acc["instructions"] / b, 4)
            if acc.get("llc_misses"):
                acc["llc_miss_per_byte"] = round(acc["llc_misses"] / b, 6)
    return {"tier": _ProfState.tier if _ProfState.enabled else cap.tier,
            "enabled": int(_ProfState.enabled),
            "scopes": scopes, "unavailable": unavailable,
            "phases": phases}


def phase_totals() -> dict:
    """Flat copy of the raw per-phase accumulators:
    ``{phase: {counter: int}}`` (no derived ratios) — cheap to diff."""
    with _ACC_LOCK:
        return {p: dict(acc) for p, acc in _phases.items()}


def counters_from_view(view) -> dict:
    """Reduce counter records in a collected trace to per-phase sums.

    Returns ``{phase_name: {counter_name: total}}`` — the cross-process
    join: counter records written by any traced process land on its
    rings and fold together here, keyed by the phase kind in ``arg``."""
    out: dict = {}
    for name, kind in _trace.CTR_KINDS.items():
        recs = view.records_of(kind)
        for rec in recs:
            phase = _PHASE_BY_KIND.get(int(rec["arg"]), f"kind{rec['arg']}")
            acc = out.setdefault(phase, {})
            acc[name] = acc.get(name, 0) + int(rec["t1"]) - int(rec["t0"])
    return out


# -- CLI: the CI capability probe + smoke -------------------------------------

def _smoke() -> dict:
    """Meter a known busy loop; returns the readings for the gate.

    The gate: if the probe claims a perf tier but the smoke reads all
    zeros, something is broken (not merely unavailable) — fail."""
    m = Meter()
    deadline = time.perf_counter() + 0.05
    x = 0
    while time.perf_counter() < deadline:
        with m:
            for i in range(20000):
                x += i * i
    m.close()
    return {"tier": m.tier, "entries": m.entries, "totals": m.totals,
            "spin_result": x % 7}


def main(argv=None) -> int:
    """`python -m repro_torch.obs.hwcounters [--probe] [--smoke] [--json]`."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="store_true",
                    help="print host capability (tier, paranoid, events)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the busy-loop smoke; fail if a perf tier "
                         "reads all zeros")
    ap.add_argument("--json", action="store_true", help="JSON output")
    args = ap.parse_args(argv)
    if not (args.probe or args.smoke):
        args.probe = args.smoke = True
    out: dict = {}
    if args.probe:
        out["capability"] = probe(refresh=True).to_dict()
    rc = 0
    if args.smoke:
        s = _smoke()
        out["smoke"] = s
        if s["tier"].startswith("perf"):
            if not any(v for k, v in s["totals"].items() if k != "wall_ns"):
                out["error"] = ("probe claims perf tier "
                                f"{s['tier']!r} but smoke read zeros")
                rc = 1
    if args.json:
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        cap = out.get("capability", {})
        if cap:
            print(f"tier={cap['tier']} paranoid={cap['paranoid']} "
                  f"events={','.join(cap['events']) or '-'}")
            for name, err in sorted(cap.get("errors", {}).items()):
                print(f"  unavailable: {name}: {err}")
        if "smoke" in out:
            t = out["smoke"]["totals"]
            keys = ", ".join(f"{k}={v}" for k, v in sorted(t.items()))
            print(f"smoke[{out['smoke']['tier']}] "
                  f"entries={out['smoke']['entries']}: {keys}")
        if "error" in out:
            print(f"FAIL: {out['error']}")
    return rc


if __name__ == "__main__":                           # pragma: no cover
    raise SystemExit(main())
