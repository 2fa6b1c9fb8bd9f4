"""Kernel wrappers: the entry the model code calls for each kernel.

A tensor on the CPU goes to the plain PyTorch version (the CPU tests'
path); a CUDA tensor launches the hand-written kernel or raises.  There is
no fallback from one to the other.  Each wrapper counts its launches in a
plain integer attribute, ``LAUNCHES``, so a run can show which kernels the
main path went through.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda


def flash_attention(q, k, v, causal: bool = True):
    """GQA attention: q (B,S,H,hd), k/v (B,T,K,hd) -> (B,S,H,hd).

    Causal masking is top-left aligned (key j visible to query i iff
    j <= i), as in the TPU kernel it replaces."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal)
    out = flash_attention_cuda(q, k, v, causal=causal)
    flash_attention.LAUNCHES += 1
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


flash_attention.LAUNCHES = 0
ssd_scan.LAUNCHES = 0
