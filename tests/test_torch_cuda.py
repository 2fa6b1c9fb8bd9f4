"""Tests of the port that need the card: the CUDA kernels (flash attention,
the SSD chunk scan, the offload copy) against their plain versions, and the
transfer engine's pinned, side-stream copies.

This file imports nothing of JAX, so it also runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.copyengine import CopyEngine
from repro_torch.core.engine import AsyncTransferEngine
from repro_torch.core.policy import Device, ExecutionMode, OffloadPolicy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.offload_copy import offload_copy_cuda

# fp32: max |kernel - plain|, the bound of tests/test_kernels.py.  bf16:
# max over rows of max|kernel - plain| / RMS of the plain row, against the
# plain version on the fp32 upcasts of the same inputs (the kernel computes
# scores in fp32); the bound of chip_smoke.py, which also reads what a
# skipped K/V tile gives on the same metric.
FP32_TOL = 2e-5
BF16_ROW_TOL = 0.05
# the SSD scan: fp32 products throughout, bf16 x upcast on load, so both
# dtypes are held to the fp32 bound of tests/test_kernels.py against the
# plain version on the fp32 upcast of x
SSD_TOL = 1e-4
# the offload copy: y bit-equal to the plain version (one fp32 multiply and
# a round-to-nearest-even cast in both); the sum, added in another order,
# within 1e-5 of sum |x * scale| of the fp64 sum of the same products (the
# bound of chip_smoke.py)
OFFLOAD_SUM_TOL = 1e-5
OFFLOAD_PAIRS = [("float32", "float32"), ("float32", "bfloat16"),
                 ("bfloat16", "float32"), ("bfloat16", "bfloat16")]

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
    ("bfloat16", 256, 256, 8, 8, 80, True),     # zamba2's head_dim
    ("float32", 100, 100, 4, 4, 80, True),
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


@pytest.mark.parametrize("dtype,b,s,h,p,g,n,chunk", [
    ("float32", 2, 512, 8, 64, 1, 64, 256),
    ("bfloat16", 2, 512, 8, 64, 1, 64, 256),
    ("float32", 2, 1000, 4, 64, 1, 64, 256),     # ragged S
    ("float32", 1, 300, 8, 16, 2, 16, 64),       # G = 2, ragged
    ("float32", 2, 96, 8, 32, 4, 32, 32),        # G = 4
    ("float32", 2, 37, 4, 16, 2, 16, 8),         # the smoke widths
])
def test_ssd_kernel_matches_plain(cuda_device, dtype, b, s, h, p, g, n,
                                  chunk):
    rng = np.random.default_rng(s)
    dt = np.logaddexp(0.0, rng.standard_normal((b, s, h)) - 3.0)
    da = -np.exp(0.5 * rng.standard_normal(h)) * dt
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda_device) for a in (
        rng.standard_normal((b, s, h, p)),
        0.5 * rng.standard_normal((b, s, g, n)),
        0.5 * rng.standard_normal((b, s, g, n)),
        dt, da, np.linspace(0.5, 1.5, h))]
    args[0] = args[0].to(getattr(torch, dtype))
    before = ops.ssd_scan.LAUNCHES
    y, hf = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.ssd_scan.LAUNCHES == before + 1
    wy, wh = ref.ssd_scan(args[0].float(), *args[1:], chunk=chunk)
    torch.testing.assert_close(y, wy, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(hf, wh, rtol=SSD_TOL, atol=SSD_TOL)


def test_flash_wrapper_raises_instead_of_falling_back(cuda_device):
    q, k, v = (torch.from_numpy(x).to(cuda_device)
               for x in _qkv(7, 1, 64, 64, 4, 2, 24))      # hd 24: no kernel
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, k, v)


def _row_err(got, want) -> float:
    dev = (got.float() - want).abs().amax(-1)
    return (dev / want.pow(2).mean(-1).sqrt()).max().item()


@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("s,t,h,kh,causal", [
    (200, 200, 8, 8, True),      # ragged S = T, MHA
    (200, 200, 8, 2, True),      # ragged S = T, GQA (H = 4K)
    (512, 512, 8, 2, True),      # several K/V tiles through the ring
    (64, 200, 8, 2, False),      # S < T
    (256, 64, 8, 8, False),      # S > T
    # more q tiles than the card has SMs: each block walks several items
    (1000, 1000, 16, 4, True),
    (512, 300, 32, 8, False),
])
def test_flash_tensor_core_kernel_matches_plain(cuda_device, hd, s, t, h, kh,
                                                causal):
    """bf16 at hd 64, 80, 128 goes through the tensor-core kernel (and
    only it), within the bf16 row-error gate of the plain version on the
    fp32 upcasts of the same inputs."""
    q, k, v = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
               for x in _qkv(8, 2, s, t, h, kh, hd))
    before = dict(ops.flash_attention.VARIANTS)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.VARIANTS == {
        "wgmma": before["wgmma"] + 1, "simt": before["simt"]}
    want = ref.flash_attention(q.float(), k.float(), v.float(), causal=causal)
    assert got.isfinite().all()
    assert _row_err(got, want) <= BF16_ROW_TOL


@pytest.mark.parametrize("dtype,hd", [("bfloat16", 16), ("bfloat16", 32),
                                      ("float32", 64), ("float32", 128)])
def test_flash_other_shapes_take_the_cuda_core_kernel(cuda_device, dtype, hd):
    q, k, v = (torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
               for x in _qkv(9, 1, 128, 128, 4, 2, hd))
    before = dict(ops.flash_attention.VARIANTS)
    ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ops.flash_attention.VARIANTS == {
        "wgmma": before["wgmma"], "simt": before["simt"] + 1}


def test_flash_misaligned_input_raises(cuda_device):
    """TMA needs 16-byte aligned bases: a contiguous view that starts one
    element in raises before any launch."""
    q, k, v = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
               for x in _qkv(10, 1, 128, 128, 4, 2, 128))
    shifted = torch.empty(q.numel() + 8, device=cuda_device,
                          dtype=torch.bfloat16)[1:1 + q.numel()].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = dict(ops.flash_attention.VARIANTS)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(shifted, k, v)
    assert ops.flash_attention.VARIANTS == before


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


def _offload_slab(dev, dtype, rows, cols, seed=3):
    """N(0.5, 1): a non-zero mean, so a lost block shows in the sum."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, cols)) + 0.5).astype(np.float32)
    return torch.from_numpy(x).to(dev).to(getattr(torch, dtype))


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("rows,cols,block_rows", [
    (4096, 1024, 256),      # 16 MiB fp32: 7-8 stages a CTA
    (96, 136, 32),          # 4 CTAs, a short last stage
    (256, 128, 256),        # one stage: a ring deeper than the range
])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("in_dtype,out_dtype", OFFLOAD_PAIRS)
def test_offload_kernel_matches_plain(cuda_device, in_dtype, out_dtype, depth,
                                      rows, cols, block_rows):
    x = _offload_slab(cuda_device, in_dtype, rows, cols)
    out = getattr(torch, out_dtype)
    want, _ = ref.offload_copy(x, scale=0.1, out_dtype=out)
    v = (x.float() * 0.1).double()
    s64, mag = v.sum().item(), v.abs().sum().item()
    for inject in (False, True):
        y, s = offload_copy_cuda(x, scale=0.1, out_dtype=out, depth=depth,
                                 block_rows=block_rows, inject=inject)
        y2, s2 = offload_copy_cuda(x, scale=0.1, out_dtype=out, depth=depth,
                                   block_rows=block_rows, inject=inject)
        torch.cuda.synchronize()
        assert y.dtype == out and torch.equal(_bits(y), _bits(want))
        assert torch.equal(_bits(y2), _bits(y))             # deterministic
        if inject:
            assert abs(s.item() - s64) / mag <= OFFLOAD_SUM_TOL
            assert torch.equal(_bits(s2), _bits(s))
        else:
            assert s is None and s2 is None


def test_offload_wrapper_launches_or_stays_inline(cuda_device):
    x = _offload_slab(cuda_device, "float32", 512, 256)
    launches, inline = ops.offload_copy.LAUNCHES, ops.offload_copy.INLINE
    y, s = ops.offload_copy(x, scale=1.5, policy=OffloadPolicy(
        mode=ExecutionMode.SYNC, offload_threshold_bytes=1))
    torch.cuda.synchronize()
    assert ops.offload_copy.LAUNCHES == launches + 1 and s is not None
    assert torch.equal(y, ref.offload_copy(x, scale=1.5)[0])
    for pol in (OffloadPolicy(offload_threshold_bytes=1 << 30),
                OffloadPolicy(device=Device.INLINE, offload_threshold_bytes=1)):
        ops.offload_copy(x, scale=1.5, policy=pol)
    assert ops.offload_copy.LAUNCHES == launches + 1
    assert ops.offload_copy.INLINE == inline + 2


@pytest.mark.parametrize("make", [
    lambda dev: torch.zeros(300, 128, device=dev),          # ragged R
    lambda dev: torch.zeros(4 * 128 + 1, device=dev)[1:].view(4, 128),
    lambda dev: torch.zeros(4, 128, device=dev, dtype=torch.float16),
])
def test_offload_wrapper_raises_instead_of_falling_back(cuda_device, make):
    x = make(cuda_device)
    launches = ops.offload_copy.LAUNCHES
    with pytest.raises((ValueError, TypeError)):
        ops.offload_copy(x, policy=OffloadPolicy(offload_threshold_bytes=1))
    assert ops.offload_copy.LAUNCHES == launches


def test_offload_wrapper_clamps_a_deep_pipelined_ring(cuda_device):
    """``pipelined`` at depth 16 on a slab of 4,096 rows (16 blocks of 256):
    the wrapper clamps the ring at the kernel's deepest, and y is bit-equal
    to the plain version."""
    x = _offload_slab(cuda_device, "float32", 4096, 256)
    launches = ops.offload_copy.LAUNCHES
    y, _ = ops.offload_copy(x, scale=0.1, depth=16, policy=OffloadPolicy(
        mode=ExecutionMode.PIPELINED, offload_threshold_bytes=1))
    torch.cuda.synchronize()
    assert ops.offload_copy.LAUNCHES == launches + 1
    assert torch.equal(_bits(y), _bits(ref.offload_copy(x, scale=0.1)[0]))
