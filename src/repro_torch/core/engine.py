"""Asynchronous transfer engine — tier-1 ROCKET (host→device movement).

Port of ``src/repro/core/engine.py`` to PyTorch.  The paper's DSA engine
abstraction (§IV-C) maps onto the host side of a torch program the same
way it did for JAX:

- *submission*   = handing a host batch to the engine (returns a job
  immediately in async/pipelined modes);
- *the engine*   = the process-wide :class:`~repro_torch.core.copyengine.
  CopyEngine`: one scatter-gather descriptor per batch gathers every leaf
  into pooled staging buffers (pinned host memory when the target is a
  CUDA device), and its completion callback moves them to the device;
- *completion*   = the copy engine's hybrid polling (deferral followed by
  short passive waits), implemented once in
  :class:`~repro_torch.core.copyengine.CopyJob`.

The device copy runs on a side CUDA stream with ``non_blocking=True`` and
is waited for through a recorded ``torch.cuda.Event`` before the staging
buffers go back to the pool: a pinned buffer recycled before its copy has
landed would corrupt the next batch.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.copyengine import (
    CopyEngine,
    CopyJob,
    Descriptor,
    HybridPollStats,
    SGList,
    get_engine,
)
from repro_torch.core.latency import LatencyModel
from repro_torch.core.policy import ExecutionMode, OffloadPolicy
from repro_torch.core.queuepair import BufferPool, drain_to_depth
from repro_torch.device import resolve_device


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _nbytes(tree) -> int:
    return sum(np.asarray(x).nbytes if not hasattr(x, "nbytes") else x.nbytes
               for x in tree_leaves(tree))


def _pinned_empty(shape, dtype) -> np.ndarray:
    """A numpy view of page-locked host memory (the array keeps the
    tensor that owns the memory alive)."""
    tdt = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(tuple(shape), dtype=tdt, pin_memory=True).numpy()


@dataclass
class EngineStats(HybridPollStats):
    """Tier-1 counters: the shared hybrid-polling fields plus submission
    and byte totals."""
    submitted: int = 0
    bytes_moved: int = 0


class TransferJob:
    """Completion handle (the paper's completion flag + job id), backed by
    a copy-engine :class:`~repro_torch.core.copyengine.CopyJob` when
    offloaded; an inline transfer has ``job_id`` -1."""

    def __init__(self, nbytes: int, job: Optional[CopyJob] = None,
                 value: Any = None):
        self.nbytes = nbytes
        self._job = job
        self._value = value
        self.job_id = job.job_id if job is not None else -1

    def done(self) -> bool:
        """True once the transfer's completion record is posted."""
        return self._job is None or self._job.done()

    def get(self, timeout_s: float = 600.0) -> Any:
        """Hybrid-polling completion (deferral + short passive waits)."""
        if self._job is not None:
            self._value = self._job.wait(timeout_s)
            self._job = None
        return self._value


class AsyncTransferEngine:
    """ROCKET tier-1 engine: modes sync / async / pipelined for host→device.

    The reference's arguments, in its order: ``latency`` is the model the
    completion waits defer by (a calibrated one from
    :func:`~repro_torch.core.latency.calibrate`, else the paper's
    constants); ``put_fn(staged, sharding)`` replaces the device transfer
    (the benchmarks' simulated copy engine); ``workers`` is accepted and
    unused (the copy engine's pool is process-wide); ``stage=False`` hands
    the caller's arrays to the transfer without the pooled staging copy;
    ``copy_engine`` overrides the shared
    :class:`~repro_torch.core.copyengine.CopyEngine` (staging and transfer
    run on it under the ``"stage"`` tag).  ``device`` is the port's own:
    the target of the default transfer.
    """

    def __init__(self, policy: OffloadPolicy = OffloadPolicy(),
                 latency: Optional[LatencyModel] = None,
                 put_fn: Optional[Callable] = None,
                 workers: int = 2, stage: bool = True,
                 copy_engine: Optional[CopyEngine] = None, *,
                 device="cuda"):
        del workers                      # engine pool is process-wide
        self.device = resolve_device(device)
        self.policy = policy
        self.latency = latency or LatencyModel()
        cuda = self.device.type == "cuda"
        self.pool = BufferPool(alloc=_pinned_empty if cuda else np.empty)
        self.stats = EngineStats()
        self._put = put_fn
        self._stage = stage
        self._copyeng = copy_engine or get_engine()
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._inflight: deque[TransferJob] = deque()
        self._lock = threading.Lock()

    def _device_copy(self, staged):
        if self._put is not None:
            out = self._put(staged, None)
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    torch.cuda.current_stream(t.device).synchronize()
            return out
        if self._stream is None:
            # on the CPU from_numpy aliases host memory; force a real copy
            # so staging buffers can be recycled safely (as the JAX engine
            # does on its CPU backend)
            return tree_map(lambda a: torch.from_numpy(np.asarray(a)).clone(),
                            staged)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(
                self.device, non_blocking=True), staged)
            landed = torch.cuda.Event()
            landed.record(self._stream)
        landed.synchronize()
        # the tensors were allocated on the side stream but are read on the
        # model's stream (the device's default stream, on whichever thread
        # runs the model): tell the caching allocator, or it could hand
        # their memory to the next side-stream copy while kernels still
        # read it
        consumer = torch.cuda.default_stream(self.device)
        for t in tree_leaves(out):
            t.record_stream(consumer)
        return out

    def _make_descriptor(self, batch, nbytes: int) -> Descriptor:
        """One SG descriptor per batch: gather every leaf into pooled
        staging buffers, then the device transfer as the completion
        callback (which runs on the copy-engine worker when offloaded)."""

        def build() -> SGList:
            sg = SGList()
            if not self._stage:
                sg.ctx = batch
                return sg

            def one(x):
                arr = np.asarray(x)
                buf = self.pool.acquire(arr.shape, arr.dtype)
                sg.add_array(arr, buf)
                return buf

            sg.ctx = tree_map(one, batch)
            return sg

        def complete(sg: SGList):
            out = self._device_copy(sg.ctx)
            if self._stage:
                # only now: the copy has landed (event waited above)
                tree_map(self.pool.release, sg.ctx)
            return out

        return Descriptor(build=build, complete=complete, nbytes=nbytes,
                          injection=self.policy.injection_enabled(),
                          tag="stage")

    # -- submission ----------------------------------------------------------
    def submit(self, batch, sharding=None) -> TransferJob:
        if sharding is not None:
            raise ValueError("sharding: the port moves a batch to one card; "
                             "pass sharding=None")
        nbytes = _nbytes(batch)
        self.stats.submitted += 1
        self.stats.bytes_moved += nbytes
        descr = self._make_descriptor(batch, nbytes)

        if (self.policy.mode == ExecutionMode.SYNC
                or not self.policy.should_offload(nbytes)):
            # inline path: the caller's thread performs the (counted) SG
            # copies and the device transfer synchronously
            self.stats.inline += 1
            sg = descr.build()
            if len(sg):
                self._copyeng.run_sg(sg, injection=descr.injection,
                                     tag=descr.tag)
            return TransferJob(nbytes, value=descr.complete(sg))

        self.stats.offloaded += 1
        cj = self._copyeng.submit(descr, wq=None, policy=self.policy,
                                  latency=self.latency, stats=self.stats)
        job = TransferJob(nbytes, job=cj)
        if self.policy.mode == ExecutionMode.PIPELINED:
            with self._lock:
                self._inflight.append(job)
            # backpressure at pipeline depth (bounded queue-pair ring)
            drain_to_depth(self._inflight, self._lock,
                           self.policy.pipeline_depth, lambda j: j.get())
        return job

    # -- batch-level completion (pipelined mode defers checks to here) --------
    def drain(self) -> list:
        with self._lock:
            jobs, self._inflight = list(self._inflight), deque()
        return [j.get() for j in jobs]

    def close(self) -> None:
        """Complete outstanding transfers (the shared copy engine itself
        stays up — it serves every other datapath in the process)."""
        self.drain()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
