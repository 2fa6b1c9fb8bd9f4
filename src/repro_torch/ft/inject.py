"""Deterministic fault-injection plane for the IPC stack.

Every failure mode the reliability layer claims to survive must be
*producible on demand*, deterministically, in-process — not by racing
``os.kill`` against a heap fill and hoping.  This module provides that:
a process-global :class:`FaultPlane` holding a seeded, replayable
schedule of named injection **sites**, consulted by one-line guards
threaded through the hot paths.

Design constraints (same order as the tracing plane, `obs/trace.py`):

1. **Disabled means zero.**  No plane installed (the default) costs one
   module-attribute load + ``is None`` check per instrumented site.  No
   RNG state exists, nothing allocates.
2. **Deterministic and replayable.**  A decision is a pure function of
   ``(seed, site, n)`` where ``n`` is the site's invocation count — a
   keyed blake2s hash, stable across processes, platforms, and Python
   hash randomization.  Two planes with the same seed and spec, driven
   through the same site-hit sequence, fire identically;
   :meth:`FaultPlane.schedule_bytes` serializes the fired log so tests
   can assert byte-identical replay.
3. **Witnessed.**  Every fire is appended to an in-order log and counted
   per site, so a chaos run can report exactly which faults it exercised.

Registered sites (the instrumented guard points):

==========================  ==================================================
site                        effect at the guard
==========================  ==================================================
``ring.publish.torn``       corrupt the slot's meta bytes just before the
                            READY flip (a torn/partial publish)
``ring.publish.drop``       publish the slot as a zero-meta skip sentinel
                            (the message silently vanishes in flight)
``ring.poll.stall``         sleep ``stall_s`` inside the consumer's poll
``channel.meta.corrupt``    flip one byte of the encoded wire meta
``channel.doorbell.delay``  sleep ``stall_s`` between payload fill and the
                            doorbell (publish)
``heap.exhausted``          force ``BulkHeap.try_alloc`` to report
                            exhaustion even when extents are free
``heap.leak``               suppress one extent ``free`` — the extent leaks
                            until the stamp-based reaper reclaims it
``reactor.reply.stall``     sleep ``stall_s`` in ``Connection.reply``
``dispatcher.handler.error``  raise ``InjectedFault`` from the handler
``worker.crash``            ``os._exit(17)`` the serving process at the
                            dispatch point (crash mid-batch / mid-heap-fill)
``ckpt.shard.corrupt``      flip one byte of a checkpoint shard served to a
                            replication puller (CRC must catch it; ``arg``
                            is the XOR value, default 0xFF)
``standby.promote.stall``   sleep ``stall_s`` inside the standby's promote
                            path, before it binds the rendezvous (drills the
                            supervisor's promote timeout → cold fallback)
``standby.lag``             skip one replication sync round on the standby
                            (sleep ``stall_s`` instead of pulling), growing
                            the replication lag deterministically
==========================  ==================================================

Usage::

    plane = FaultPlane(seed=7, faults={
        "heap.exhausted": FaultSpec(at=(3,)),          # 4th alloc fails
        "channel.meta.corrupt": FaultSpec(rate=0.01),  # 1% of sends
    })
    install(plane)
    ...                      # run the workload
    uninstall()
    assert plane.fired("heap.exhausted") == 1

Spawned children do not inherit the plane automatically (counters are
per-process state); pass the plane — it pickles — or use
:func:`to_env` / :func:`maybe_install_from_env` for ``spawn`` entries
that cannot take extra arguments.

Copied from ``src/repro/ft/inject.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time
from dataclasses import dataclass

__all__ = [
    "FaultSpec",
    "FaultPlane",
    "InjectedFault",
    "install",
    "uninstall",
    "plane",
    "fire",
    "stall",
    "SITES",
    "ENV_VAR",
    "to_env",
    "maybe_install_from_env",
]

#: every name an instrumented guard may consult; ``FaultPlane`` rejects
#: unknown names at construction so a typo'd schedule fails loudly
#: instead of silently never firing.
SITES = frozenset({
    "ring.publish.torn",
    "ring.publish.drop",
    "ring.poll.stall",
    "channel.meta.corrupt",
    "channel.doorbell.delay",
    "heap.exhausted",
    "heap.leak",
    "reactor.reply.stall",
    "dispatcher.handler.error",
    "worker.crash",
    "ckpt.shard.corrupt",
    "standby.promote.stall",
    "standby.lag",
})

#: env var carrying a JSON-encoded plane spec for ``spawn`` children
#: (see :func:`to_env`).
ENV_VAR = "REPRO_FAULT_PLANE"


class InjectedFault(RuntimeError):
    """The error raised by ``dispatcher.handler.error`` fires: a stand-in
    for an arbitrary handler bug, distinguishable from real failures."""


@dataclass(frozen=True)
class FaultSpec:
    """When and how one site fires.

    ``at`` fires on exactly those 0-based invocation indices; ``rate``
    adds seeded Bernoulli fires on every other hit.  ``max_fires`` caps
    total fires (-1 = unbounded).  ``stall_s`` parameterizes the
    stall/delay sites; ``arg`` is free for site-specific use (e.g. the
    byte value XOR'd into corrupted meta).
    """
    rate: float = 0.0
    at: tuple = ()
    max_fires: int = -1
    stall_s: float = 0.0
    arg: int = 0


class FaultPlane:
    """A seeded, replayable schedule over the named injection sites."""

    def __init__(self, seed: int = 0, faults: dict | None = None):
        faults = dict(faults or {})
        unknown = set(faults) - SITES
        if unknown:
            raise ValueError(f"unknown fault site(s): {sorted(unknown)}; "
                             f"choose from {sorted(SITES)}")
        self.seed = int(seed)
        self.faults = {site: (spec if isinstance(spec, FaultSpec)
                              else FaultSpec(**spec))
                       for site, spec in faults.items()}
        self._lock = threading.Lock()
        self._hits: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        self._log: list[tuple[str, int]] = []

    # -- determinism core -------------------------------------------------
    def _draw(self, site: str, n: int) -> float:
        """Uniform [0,1) draw, a pure function of (seed, site, n)."""
        h = hashlib.blake2s(f"{self.seed}:{site}:{n}".encode(),
                            digest_size=8).digest()
        return struct.unpack("<Q", h)[0] / float(1 << 64)

    def would_fire(self, site: str, n: int) -> bool:
        """Pure decision (no counters, no cap): does ``site`` fire on its
        ``n``-th hit under this seed/spec?  The replayable schedule is
        this function tabulated."""
        spec = self.faults.get(site)
        if spec is None:
            return False
        if n in spec.at:
            return True
        return spec.rate > 0.0 and self._draw(site, n) < spec.rate

    # -- hot-path entry ---------------------------------------------------
    def should(self, site: str):
        """Count one hit at ``site``; return its :class:`FaultSpec` if
        this hit fires (and log it), else ``None``."""
        spec = self.faults.get(site)
        if spec is None:
            return None
        with self._lock:
            n = self._hits.get(site, 0)
            self._hits[site] = n + 1
            if spec.max_fires >= 0 and self._fired.get(site, 0) >= spec.max_fires:
                return None
            if not self.would_fire(site, n):
                return None
            self._fired[site] = self._fired.get(site, 0) + 1
            self._log.append((site, n))
            return spec

    # -- witnesses --------------------------------------------------------
    def hits(self, site: str) -> int:
        """Times ``site`` was consulted (fired or not)."""
        return self._hits.get(site, 0)

    def fired(self, site: str) -> int:
        """Times ``site`` actually fired."""
        return self._fired.get(site, 0)

    @property
    def log(self) -> list:
        """In-order fired events as ``(site, invocation_index)``."""
        with self._lock:
            return list(self._log)

    def schedule_bytes(self) -> bytes:
        """Canonical serialization of the fired log — byte-identical
        across replays of the same seed/spec/hit-sequence."""
        return "\n".join(f"{s}:{n}" for s, n in self.log).encode()

    def counters(self) -> dict:
        """Flat ``site -> fired`` map for metrics/report plumbing."""
        with self._lock:
            return dict(self._fired)

    # -- spawn plumbing ---------------------------------------------------
    def __getstate__(self):
        # config only: counters/logs are per-process observation state
        return {"seed": self.seed, "faults": self.faults}

    def __setstate__(self, state):
        self.__init__(state["seed"], state["faults"])

    def spec_json(self) -> str:
        """JSON spec (seed + faults) for env-var transport to children."""
        return json.dumps({
            "seed": self.seed,
            "faults": {site: {"rate": s.rate, "at": list(s.at),
                              "max_fires": s.max_fires, "stall_s": s.stall_s,
                              "arg": s.arg}
                       for site, s in self.faults.items()},
        }, sort_keys=True)

    @classmethod
    def from_spec_json(cls, text: str) -> "FaultPlane":
        obj = json.loads(text)
        return cls(obj["seed"],
                   {site: FaultSpec(rate=s["rate"], at=tuple(s["at"]),
                                    max_fires=s["max_fires"],
                                    stall_s=s["stall_s"], arg=s["arg"])
                    for site, s in obj["faults"].items()})


# process-global plane; instrumented sites guard on ``_PLANE is not None``
# so the uninstalled cost is one attribute load + identity check.
_PLANE: FaultPlane | None = None


def install(p: FaultPlane) -> None:
    """Install ``p`` as this process's fault plane."""
    global _PLANE
    _PLANE = p


def uninstall() -> None:
    """Remove the installed plane (sites go back to zero-cost)."""
    global _PLANE
    _PLANE = None


def plane() -> FaultPlane | None:
    """The installed plane, or ``None``."""
    return _PLANE


def fire(site: str):
    """Hot-path guard: the installed plane's decision for one hit at
    ``site`` (its ``FaultSpec`` when firing), or ``None``."""
    p = _PLANE
    return p.should(site) if p is not None else None


def stall(site: str) -> bool:
    """Convenience for the stall/delay sites: sleep ``spec.stall_s`` if
    ``site`` fires; returns whether it fired."""
    spec = fire(site)
    if spec is None:
        return False
    if spec.stall_s > 0.0:
        time.sleep(spec.stall_s)
    return True


def to_env(p: FaultPlane, env: dict | None = None) -> dict:
    """Put ``p``'s spec into ``env`` (default ``os.environ``) so spawn
    children can pick it up via :func:`maybe_install_from_env`."""
    if env is None:
        env = os.environ
    env[ENV_VAR] = p.spec_json()
    return env


def maybe_install_from_env() -> FaultPlane | None:
    """Install a plane from :data:`ENV_VAR` if present; for ``spawn``
    entry points that cannot thread a plane argument."""
    text = os.environ.get(ENV_VAR)
    if not text:
        return None
    p = FaultPlane.from_spec_json(text)
    install(p)
    return p
