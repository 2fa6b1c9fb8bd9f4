"""Persistent shared-buffer management (the paper's queue pairs, §IV-C).

ROCKET eliminates page faults by pre-mapping a fixed memory pool per client
connection and reusing it for every transfer.  The JAX analogues:

- :class:`BufferPool` — preallocated, reused host staging buffers (numpy),
  so the input pipeline never re-allocates per step (first-touch/remap cost
  is paid once);
- :class:`QueuePair` — a client's persistent tx/rx slot rings for the
  serving runtime (fixed shapes -> no recompilation, stable addresses);
- ``donate`` conventions — step-persistent device buffers (params, optimizer
  state, KV cache) are donated through jit so XLA reuses the allocation.

Copied from ``src/repro/core/queuepair.py``: the port keeps its own copy and
imports nothing of the JAX package.  ``BufferPool`` gained an ``alloc``
hook for pinned staging memory; nothing else changed.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class PoolStats:
    hits: int = 0            # reused an existing buffer (pinned-path analogue)
    misses: int = 0          # had to allocate (page-fault-path analogue)
    released: int = 0

    @property
    def reuse_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class BufferPool:
    """Reusable host staging buffers keyed by (shape, dtype).

    ``alloc(shape, dtype)`` makes a new numpy buffer on a miss (default
    ``np.empty``); the port's transfer engine passes one backed by pinned
    host memory when it moves batches to a CUDA device."""

    def __init__(self, max_per_key: int = 8, alloc=np.empty):
        self._alloc = alloc
        self._free: dict = defaultdict(list)
        self._lock = threading.Lock()
        self._max = max_per_key
        self.stats = PoolStats()

    def acquire(self, shape, dtype) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            free = self._free[key]
            if free:
                self.stats.hits += 1
                return free.pop()
            self.stats.misses += 1
        buf = self._alloc(shape, dtype)
        buf.fill(0)           # first-touch now (pre-mapping), not at use time
        return buf

    def release(self, buf: np.ndarray) -> None:
        key = (tuple(buf.shape), buf.dtype.str)
        with self._lock:
            if len(self._free[key]) < self._max:
                self._free[key].append(buf)
            self.stats.released += 1

    def preallocate(self, shape, dtype, count: int) -> None:
        """Pre-map the pool at connection setup (paper §IV-C)."""
        bufs = [self.acquire(shape, dtype) for _ in range(count)]
        with self._lock:
            self.stats.misses -= count       # setup cost is not a runtime miss
        for b in bufs:
            self.release(b)


def drain_to_depth(inflight, lock: threading.Lock, depth: int,
                   wait_fn) -> None:
    """Bounded-queue-pair backpressure: while more than ``depth`` jobs are
    in flight, pop the oldest under ``lock`` and block on it *outside* the
    lock, so concurrent submitters/drainers aren't serialized behind a full
    transfer latency.  Shared by the tier-1 engine and the IPC channels;
    ``inflight`` is a :class:`collections.deque` (O(1) popleft — the old
    ``list.pop(0)`` was O(n) per prune).
    """
    while True:
        with lock:
            if len(inflight) <= depth:
                return
            oldest = inflight.popleft()
        wait_fn(oldest)


@dataclass
class Slot:
    buf: np.ndarray
    seq: int = -1             # request sequence occupying the slot (-1 = free)


class QueuePair:
    """Persistent per-client tx/rx slot rings (RDMA-QP-inspired, §IV-C)."""

    def __init__(self, n_slots: int, tx_shape, rx_shape, dtype=np.float32):
        self.tx = [Slot(np.zeros(tx_shape, dtype)) for _ in range(n_slots)]
        self.rx = [Slot(np.zeros(rx_shape, dtype)) for _ in range(n_slots)]
        self._next = 0
        self._lock = threading.Lock()

    def acquire_tx(self, seq: int) -> Optional[Slot]:
        with self._lock:
            for _ in range(len(self.tx)):
                slot = self.tx[self._next]
                self._next = (self._next + 1) % len(self.tx)
                if slot.seq < 0:
                    slot.seq = seq
                    return slot
        return None            # ring full -> caller applies backpressure

    def release(self, slot: Slot) -> None:
        with self._lock:
            slot.seq = -1
