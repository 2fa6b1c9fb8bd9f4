"""The port's host→device transfer engine against the JAX package's, on
the same batches in every mode: the same counters, the same per-tag copy
accounting on a private copy engine, and byte-equal results."""
import numpy as np
import pytest
import torch

from repro.core.copyengine import CopyEngine as JaxCopyEngine
from repro.core.engine import AsyncTransferEngine as JaxEngine
from repro.core.policy import ExecutionMode as JaxMode
from repro.core.policy import OffloadPolicy as JaxPolicy
from repro_torch.core.copyengine import CopyEngine
from repro_torch.core.engine import AsyncTransferEngine
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
