"""ROCKET offload policy: execution modes, offload control, cache injection.

Direct transcription of the paper's configuration surface (§IV-B):

- ``mode``  ∈ {sync, async, pipelined} — synchronization/overlap strategy;
- ``device`` ∈ {inline, offload} — the paper's {cpu, dsa} knob; ``inline``
  keeps the movement on the compute stream, ``offload`` delegates it to the
  async engine (host thread-pool / TPU DMA, tier-dependent);
- ``cache_injection`` — the paper's LLC-injection knob; on TPU this is VMEM
  residency (kernels) / device-buffer pinning (tier 1).  ``None`` applies the
  paper's mode-specific default: on for sync, conditional for async
  (single-client only), off for pipelined (Table III, §V).
- ``offload_threshold_bytes`` — size-based offload control (Table III "Data
  Size"): transfers below the threshold stay inline.

Copied from ``src/repro/core/policy.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional


class ExecutionMode(str, enum.Enum):
    SYNC = "sync"
    ASYNC = "async"
    PIPELINED = "pipelined"


class Device(str, enum.Enum):
    INLINE = "inline"      # paper: cpu memcpy
    OFFLOAD = "offload"    # paper: dsa engine


@dataclass(frozen=True)
class RetryPolicy:
    """Every timeout, retry, and liveness deadline in one place.

    Before this existed, ``worker.py``/``reactor.py`` carried the same
    four magic numbers (2.0/5.0/10.0/60.0 s) as scattered keyword
    defaults; heartbeat staleness and reconnect backoff would have become
    two more.  All of them are *policy*, so they live on
    ``OffloadPolicy.retry`` and are tuned in one place.
    """
    # -- request/reply deadlines ------------------------------------------
    reply_timeout_s: float = 5.0        # server-side reply publish
    query_timeout_s: float = 60.0       # client-side completion wait
    connect_timeout_s: float = 30.0     # listener rendezvous + arena attach
    # -- shutdown deadlines -----------------------------------------------
    shutdown_send_timeout_s: float = 2.0   # best-effort control sends at close
    join_timeout_s: float = 10.0        # process/thread join at stop()
    linger_timeout_s: float = 30.0      # producer drain-then-exit deadline
    recv_poll_s: float = 0.05           # serve-loop blocking-recv quantum
    # -- client reconnect/backoff (ft plane) ------------------------------
    max_reconnects: int = 4             # bounded: give up after this many
    backoff_initial_s: float = 0.05     # first retry delay, doubled per try
    backoff_max_s: float = 1.0          # backoff ceiling
    # -- liveness (heartbeat words, transport control words 12/13) --------
    heartbeat_interval_s: float = 0.2   # min gap between stamps per side
    heartbeat_stale_s: float = 2.0      # no stamp for this long => peer dead
    # -- server-side exactly-once dedup window (replayed requests) --------
    dedup_window: int = 1024            # cached reply ids per fabric

    def backoff_s(self, attempt: int) -> float:
        """Delay before reconnect ``attempt`` (0-based): doubling from
        ``backoff_initial_s`` capped at ``backoff_max_s``."""
        return min(self.backoff_initial_s * (2.0 ** attempt),
                   self.backoff_max_s)


@dataclass(frozen=True)
class OffloadPolicy:
    mode: ExecutionMode = ExecutionMode.PIPELINED
    device: Device = Device.OFFLOAD
    cache_injection: Optional[bool] = None
    offload_threshold_bytes: int = 1 << 20       # breakeven well above 4KB raw [23]
    pipeline_depth: int = 2                      # outstanding transfers (pipelined)
    max_batch: int = 8                           # request batching (pipelined)
    # hybrid polling (§IV-C): sleep defer_fraction*L, then short-interval poll
    defer_fraction: float = 0.95
    poll_interval_us: float = 25.0               # UMWAIT-quantum analogue
    # busy-yield window before the quantum sleeps: on kernels with coarse
    # timer granularity (sleep(25us) can cost ~1ms) a short spin keeps
    # streaming paths at memcpy speed while staying CPU-polite when idle
    spin_us: float = 200.0
    # single-copy serving datapath: the reactor receives requests as
    # zero-copy leases and the dispatcher gathers slot views straight into
    # pooled batch buffers (one payload memcpy per request server-side);
    # False restores the copy-out receive path (the pre-CopyEngine
    # behaviour, kept for fig13_copy_path A/B measurement)
    zero_copy_serving: bool = True
    # large-message datapath (ipc/heap.py): a payload >= this goes through
    # the connection's bulk heap instead of a ring slot whenever a heap is
    # attached (payloads larger than the slot *must*; smaller ones may,
    # keeping fat streams out of the slot arena).  The ring then carries
    # only the compact extent descriptor.
    heap_threshold_bytes: int = 8 << 20
    # chunk size for offloaded heap fills: async/pipelined sends split the
    # fill into chunk-sized SG submissions on the channel's work queue so
    # the copy of message k+1 overlaps the peer's drain of message k and a
    # single fat fill cannot monopolize an engine worker between doorbells
    heap_chunk_bytes: int = 8 << 20
    # small-message fast path (send coalescing): async/pipelined messages
    # at/below coalesce_bytes are packed into one ring slot as a microbatch
    # frame of up to coalesce_max sub-messages (FLAG_COALESCED), amortizing
    # slot claim, meta encode, and doorbell K-ways.  0 disables the static
    # path; the adaptive governor may still coalesce (it uses
    # coalesce_limit_bytes() as the structural cap).  A partially filled
    # frame is flushed by the next non-coalesced send, an explicit
    # flush()/handle.wait(), or the first send after coalesce_window_us.
    coalesce_bytes: int = 0
    coalesce_max: int = 8
    coalesce_window_us: float = 200.0
    # wire-meta integrity: when True every published slot carries a CRC32
    # of its meta bytes in slot-header word 5 (FLAG_CRC) and the receiver
    # verifies before decode — a corrupt slot is quarantined as a counted
    # ``corrupt_drops`` skip instead of crashing the drain loop on an
    # unpicklable/undecodable header
    meta_checksum: bool = False
    # consolidated timeout/retry/liveness deadlines (heartbeats, reconnect
    # backoff, reply/shutdown timeouts) — see RetryPolicy
    retry: RetryPolicy = RetryPolicy()
    # per-message strategy selection: "static" keeps the threshold
    # constants above; "adaptive" installs a core.governor.ChannelGovernor
    # per channel that picks inline/offload/coalesce/heap from measured
    # per-size-class cost EWMAs and queue occupancy (the paper's hybrid
    # coordination as a feedback loop — Table III learned, not hardcoded)
    governor: str = "static"

    def coalesce_limit_bytes(self) -> int:
        """Structural coalescing cap: the static knob when set, else the
        128 KB default the adaptive governor explores under.  Coalescing
        amortizes *fixed* control-plane cost; past ~128 KB the payload
        copy dominates and batching K copies behind one publish only
        coarsens pipelining granularity (the consumer idles while a
        multi-MB frame fills), so the governor does not explore there."""
        return self.coalesce_bytes if self.coalesce_bytes > 0 else 128 << 10

    def should_offload(self, nbytes: int) -> bool:
        if self.device == Device.INLINE:
            return False
        return nbytes >= self.offload_threshold_bytes

    def injection_enabled(self, concurrency: int = 1) -> bool:
        """Paper's default injection policy (Table III / §V):
        sync -> on; async -> on iff single-threaded; pipelined -> off."""
        if self.cache_injection is not None:
            return self.cache_injection
        if self.mode == ExecutionMode.SYNC:
            return True
        if self.mode == ExecutionMode.ASYNC:
            return concurrency <= 1
        return False

    def with_mode(self, mode: ExecutionMode | str) -> "OffloadPolicy":
        return replace(self, mode=ExecutionMode(mode))

    def with_device(self, device: Device | str) -> "OffloadPolicy":
        return replace(self, device=Device(device))


SYNC_INLINE = OffloadPolicy(mode=ExecutionMode.SYNC, device=Device.INLINE)
SYNC_OFFLOAD = OffloadPolicy(mode=ExecutionMode.SYNC, device=Device.OFFLOAD)
ASYNC_OFFLOAD = OffloadPolicy(mode=ExecutionMode.ASYNC, device=Device.OFFLOAD)
PIPELINED_OFFLOAD = OffloadPolicy(mode=ExecutionMode.PIPELINED, device=Device.OFFLOAD)
