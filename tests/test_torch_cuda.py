"""Tests of the port that need the card: the CUDA kernels against their
plain versions, and the transfer engine's pinned, side-stream copies.

This file imports nothing of JAX, so it also runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.copyengine import CopyEngine
from repro_torch.core.engine import AsyncTransferEngine
from repro_torch.core.policy import ExecutionMode, OffloadPolicy
from repro_torch.kernels import ops, ref

# fp32: max |kernel - plain|, the bound of tests/test_kernels.py.  bf16:
# max over rows of max|kernel - plain| / RMS of the plain row, against the
# plain version on the fp32 upcasts of the same inputs (the kernel computes
# scores in fp32); the bound of chip_smoke.py, which also reads what a
# skipped K/V tile gives on the same metric.
FP32_TOL = 2e-5
BF16_ROW_TOL = 0.05

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, b, s, t, h, kh, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), np.float32),
            rng.standard_normal((b, t, kh, hd), np.float32),
            rng.standard_normal((b, t, kh, hd), np.float32))


@pytest.mark.parametrize("dtype,s,t,h,kh,hd,causal", [
    ("bfloat16", 256, 256, 8, 2, 128, True),
    ("bfloat16", 130, 130, 4, 1, 16, True),     # ragged, bf16
    ("float32", 128, 128, 4, 2, 16, True),
    ("float32", 100, 100, 4, 4, 64, True),      # ragged S and T
    ("float32", 64, 200, 8, 1, 32, False),      # S != T, ragged T
    ("float32", 256, 64, 4, 2, 128, False),     # S > T
])
def test_flash_kernel_matches_plain(cuda_device, dtype, s, t, h, kh, hd,
                                    causal):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda_device, dt)
               for x in _qkv(6, 2, s, t, h, kh, hd))
    before = ops.flash_attention.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.LAUNCHES == before + 1
    if dt == torch.float32:
        err = (got - ref.flash_attention(q, k, v, causal=causal)).abs().max()
        assert err.item() <= FP32_TOL, err
    else:
        want = ref.flash_attention(q.float(), k.float(), v.float(),
                                   causal=causal)
        dev = (got.float() - want).abs().amax(-1)
        err = (dev / want.pow(2).mean(-1).sqrt()).max()
        assert err.item() <= BF16_ROW_TOL, err


def test_flash_wrapper_raises_instead_of_falling_back(cuda_device):
    q, k, v = (torch.from_numpy(x).to(cuda_device)
               for x in _qkv(7, 1, 64, 64, 4, 2, 24))      # hd 24: no kernel
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("mode", ["sync", "async", "pipelined"])
def test_engine_lands_every_batch(cuda_device, mode):
    """Many batches through pinned pooled buffers and the side stream: each
    result on the card equals its source (a buffer recycled before its copy
    landed would corrupt a later batch)."""
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, 1 << 30, (8, 4096)).astype(np.int32)}
               for _ in range(24)]
    with CopyEngine() as ce:
        eng = AsyncTransferEngine(OffloadPolicy(
            mode=ExecutionMode(mode), offload_threshold_bytes=1),
            copy_engine=ce, device=cuda_device)
        jobs = [eng.submit(b) for b in batches]
        outs = [j.get() for j in jobs]
        eng.close()
    assert eng.pool.stats.hits > 0
    for src, got in zip(batches, outs):
        assert got["tokens"].is_cuda
        np.testing.assert_array_equal(got["tokens"].cpu().numpy(),
                                      src["tokens"])
