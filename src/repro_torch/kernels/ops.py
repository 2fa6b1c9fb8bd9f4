"""Kernel wrappers: the entry the model code calls for each kernel.

A tensor on the CPU goes to the plain PyTorch version (the CPU tests'
path); a CUDA tensor launches the hand-written kernel or raises.  There is
no fallback from one to the other.  Each wrapper counts its launches in a
plain integer attribute, ``LAUNCHES``, so a run can show which kernels the
main path went through.
"""
from __future__ import annotations

from repro_torch.core.policy import ExecutionMode, OffloadPolicy
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import VARIANTS as FLASH_VARIANTS
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention import variant as flash_variant
from repro_torch.kernels.offload_copy import (MAX_DEPTH, offload_copy_cuda,
                                              ring_depth)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda


def mode_depth(mode, depth: int = 2) -> int:
    """The copy ring's depth for an execution mode, as the reference's
    ``ops.offload_copy`` picks it: sync 1, async 2, pipelined
    ``max(depth, 2)`` (``depth`` is the call's argument, not the policy's
    ``pipeline_depth``)."""
    return {"sync": 1, "async": 2, "pipelined": max(depth, 2)}[
        ExecutionMode(mode).value]


def kernel_depth(shape, mode, depth: int = 2, block_rows: int = 256) -> int:
    """The ring the kernel runs for a slab of ``shape`` in ``mode``: the
    mode's depth (:func:`mode_depth`), clamped to the slab's blocks as the
    TPU kernel clamps it, and to the deepest ring the kernel is built for
    (``MAX_DEPTH``).  y and the sum do not depend on it.  Raises on a shape
    outside the slab contract."""
    return min(ring_depth(shape, mode_depth(mode, depth), block_rows),
               MAX_DEPTH)


def offload_copy(x, scale: float = 1.0, out_dtype=None, depth: int = 2,
                 block_rows: int = 256, inject: bool = False,
                 policy: OffloadPolicy | None = None):
    """Streaming copy/transform ``y = cast(x * scale, out_dtype)`` of a 2-D
    slab under the offload policy; returns ``(y, sum of x * scale or
    None)``.

    Below ``policy.should_offload`` (or with ``Device.INLINE``) the copy
    stays inline: the plain version on x's device, counted in ``INLINE``
    (the paper's CPU-memcpy choice, made by the policy).  Otherwise the
    mode picks the ring's depth (:func:`kernel_depth`) and the slab must
    meet the kernel's contract; a CUDA tensor launches the kernel (counted
    in ``LAUNCHES``) or raises, a CPU tensor takes the plain version.  The
    sum is taken when ``inject or policy.injection_enabled()``."""
    pol = policy or OffloadPolicy()
    inject = inject or pol.injection_enabled()
    if not pol.should_offload(x.numel() * x.element_size()):
        offload_copy.INLINE += 1
        return ref.offload_copy(x, scale=scale, out_dtype=out_dtype,
                                inject=inject)
    ring = kernel_depth(x.shape, pol.mode, depth, block_rows)
    if x.device.type == "cpu":
        return ref.offload_copy(x, scale=scale, out_dtype=out_dtype,
                                inject=inject)
    out = offload_copy_cuda(x, scale=scale, out_dtype=out_dtype, depth=ring,
                            block_rows=block_rows, inject=inject)
    offload_copy.LAUNCHES += 1
    return out


def flash_attention(q, k, v, causal: bool = True):
    """GQA attention: q (B,S,H,hd), k/v (B,T,K,hd) -> (B,S,H,hd).

    Causal masking is top-left aligned (key j visible to query i iff
    j <= i), as in the TPU kernel it replaces.  On the card the kernel is
    fixed by ``(dtype, hd)`` (:func:`~repro_torch.kernels.flash_attention.
    variant`); each launch is counted in ``LAUNCHES`` and under its kernel
    in ``VARIANTS``."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal)
    kind = flash_variant(q.dtype, q.shape[-1])
    out = flash_attention_cuda(q, k, v, causal=causal, kind=kind)
    flash_attention.LAUNCHES += 1
    flash_attention.VARIANTS[kind] += 1
    return out


def ssd_scan(xh, bm, cm, dt, da, d_skip, chunk: int = 256):
    """Mamba2 SSD chunk scan: xh (B,S,H,P); bm/cm (B,S,G,N), dt/da (B,S,H),
    d_skip (H,) fp32 -> (y (B,S,H,P) fp32, h_final (B,H,N,P) fp32), in
    chunks of ``chunk`` tokens, as the TPU kernel it replaces (a ragged S
    as ``ssd_chunked``'s identity-step padding)."""
    if xh.device.type == "cpu":
        return ref.ssd_scan(xh, bm, cm, dt, da, d_skip, chunk=chunk)
    out = ssd_scan_cuda(xh, bm, cm, dt, da, d_skip, chunk=chunk)
    ssd_scan.LAUNCHES += 1
    return out


offload_copy.LAUNCHES = 0
offload_copy.INLINE = 0
flash_attention.LAUNCHES = 0
flash_attention.VARIANTS = dict.fromkeys(FLASH_VARIANTS, 0)
ssd_scan.LAUNCHES = 0
