"""The port's host→device transfer engine against the JAX package's, on
the same batches in every mode: the same counters, the same per-tag copy
accounting on a private copy engine, and byte-equal results."""
import time

import numpy as np
import pytest
import torch

from repro.core.copyengine import CopyEngine as JaxCopyEngine
from repro.core.engine import AsyncTransferEngine as JaxEngine
from repro.core.latency import LatencyModel as JaxLatency
from repro.core.policy import ExecutionMode as JaxMode
from repro.core.policy import OffloadPolicy as JaxPolicy
from repro_torch.core.copyengine import CopyEngine
from repro_torch.core.engine import AsyncTransferEngine
from repro_torch.core.latency import LatencyModel
from repro_torch.core.policy import ExecutionMode, OffloadPolicy

# one torch thread: the suite runs in parallel workers beside timing-
# sensitive multi-process tests
torch.set_num_threads(1)


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for rows in (2, 64, 3, 256):            # some below the 4 KB threshold
        out.append({"tokens": rng.integers(0, 1000, (rows, 16)).astype(np.int32),
                    "mask": rng.standard_normal((rows, 16)).astype(np.float32)})
    return out


def _run(engine_cls, policy, copy_engine, batches, **kw):
    eng = engine_cls(policy, copy_engine=copy_engine, **kw)
    jobs = [eng.submit(b) for b in batches]
    outs = [j.get() for j in jobs]
    eng.close()
    return eng, outs


@pytest.mark.parametrize("mode", ["sync", "async", "pipelined"])
def test_engine_matches_jax_engine(mode):
    batches = _batches()
    with JaxCopyEngine() as jce, CopyEngine() as ce:
        jeng, jouts = _run(JaxEngine, JaxPolicy(
            mode=JaxMode(mode), offload_threshold_bytes=1 << 12), jce, batches)
        eng, outs = _run(AsyncTransferEngine, OffloadPolicy(
            mode=ExecutionMode(mode), offload_threshold_bytes=1 << 12), ce,
            batches, device="cpu")
        for f in ("submitted", "bytes_moved", "inline", "offloaded"):
            assert getattr(eng.stats, f) == getattr(jeng.stats, f), f
        assert ce.tagged_snapshot() == jce.tagged_snapshot()
    assert ce.tagged_snapshot()["copies"]["stage"] == 2 * len(batches)
    for src, got, want in zip(batches, outs, jouts):
        for key in src:
            assert isinstance(got[key], torch.Tensor)
            assert got[key].numpy().tobytes() == np.asarray(want[key]).tobytes()
            # a real copy: the result does not alias the caller's array or
            # a recycled staging buffer
            assert not np.shares_memory(got[key].numpy(), src[key])


def test_staging_buffers_are_pooled_after_the_copy():
    batches = _batches() * 3
    with CopyEngine() as ce:
        eng = AsyncTransferEngine(OffloadPolicy(
            mode=ExecutionMode.PIPELINED, offload_threshold_bytes=1),
            copy_engine=ce, device="cpu")
        outs = [eng.submit(b).get() for b in batches]
        eng.close()
    assert eng.pool.stats.hits > 0 and eng.pool.stats.released == 2 * len(batches)
    for src, got in zip(batches, outs):
        np.testing.assert_array_equal(got["tokens"].numpy(), src["tokens"])


def _sleep_put(batch, sharding=None):
    """A stand-in transfer (the benchmarks' simulated copy engine): it
    takes a while and hands the batch back."""
    time.sleep(2e-4)
    return batch


@pytest.mark.parametrize("stage", [True, False])
@pytest.mark.parametrize("mode", ["sync", "async", "pipelined"])
def test_engine_takes_the_reference_arguments(mode, stage):
    """Both engines built from the same positional arguments (policy,
    latency, put_fn, workers, stage, copy_engine) and fed the same batches
    through ``submit(batch, sharding=None)``: the same counters, copy
    accounting and job attributes."""
    batches = _batches()
    with JaxCopyEngine() as jce, CopyEngine() as ce:
        jeng = JaxEngine(JaxPolicy(mode=JaxMode(mode),
                                   offload_threshold_bytes=1 << 12),
                         JaxLatency(5.0, 30.0), _sleep_put, 3, stage, jce)
        eng = AsyncTransferEngine(OffloadPolicy(
            mode=ExecutionMode(mode), offload_threshold_bytes=1 << 12),
            LatencyModel(5.0, 30.0), _sleep_put, 3, stage, ce, device="cpu")
        runs = []
        for e in (jeng, eng):
            jobs = [e.submit(b, sharding=None) for b in batches]
            outs = [j.get() for j in jobs]
            e.close()
            runs.append((jobs, outs))
        for f in ("submitted", "bytes_moved", "inline", "offloaded"):
            assert getattr(eng.stats, f) == getattr(jeng.stats, f), f
        assert ce.tagged_snapshot() == jce.tagged_snapshot()
    (jjobs, jouts), (jobs, outs) = runs
    for src, job, jjob, got, want in zip(batches, jobs, jjobs, outs, jouts):
        assert job.done() and jjob.done()
        assert job.nbytes == jjob.nbytes == sum(a.nbytes for a in src.values())
        assert (job.job_id == -1) == (jjob.job_id == -1)
        if not stage:       # no staging copy: the put sees the caller's batch
            assert got is src and want is src
    offloaded = [j.job_id for j in jobs if j.job_id != -1]
    assert len(offloaded) == eng.stats.offloaded
    assert offloaded == sorted(set(offloaded))


def test_engine_refuses_a_sharding():
    eng = AsyncTransferEngine(OffloadPolicy(mode=ExecutionMode.SYNC),
                              device="cpu")
    with pytest.raises(ValueError, match="sharding"):
        eng.submit(_batches()[0], sharding="data")
    assert eng.stats.submitted == 0
