"""Plain PyTorch versions of the port's kernels (the CPU path and the
on-card yardstick each CUDA kernel is held against).

Counterpart of ``src/repro/kernels/ref.py`` (flash part only).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention(q, k, v, causal: bool = True):
    """GQA attention, fp32 scores and softmax.

    q: (B,S,H,hd); k/v: (B,T,K,hd) with H % K == 0 -> (B,S,H,hd) in q's
    dtype.  The causal mask is aligned top-left (key j is visible to query
    i when j <= i), as in the Pallas kernel and ``attention.causal_mask`` —
    not bottom-right as the JAX ``ref.flash_attention``; the two agree only
    when S == T.
    """
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, hd)
    scores = torch.einsum("bskge,btke->bkgst", qg, k).float() * (
        1.0 / float(hd) ** 0.5)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btke->bskge", w, v)
    return o.reshape(b, s, h, hd).to(q.dtype)
