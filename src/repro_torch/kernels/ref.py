"""Plain PyTorch versions of the port's kernels (the CPU path and the
on-card yardstick each CUDA kernel is held against).

Counterpart of ``src/repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def offload_copy(x, scale: float = 1.0, out_dtype=None, inject: bool = False):
    """``y = x * scale`` in fp32, cast to ``out_dtype`` (default x's); with
    ``inject`` also the fp32 sum of ``x * scale``.  Returns ``(y, sum as a
    0-d fp32 tensor or None)``."""
    v = x.float() * scale
    return v.to(out_dtype or x.dtype), (v.sum() if inject else None)


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


def ssd_scan(xh, bm, cm, dt, da, d_skip, chunk: int = 256):
    """Mamba2 SSD chunk scan, chunked form: a port of
    ``src/repro/models/ssm.py::ssd_chunked``, the function the JAX model
    computes and the plain version of the CUDA kernel.

    xh (B,S,H,P) in any float type; bm/cm (B,S,G,N), dt/da (B,S,H) and
    d_skip (H,) in float32; head h reads B/C group h // (H/G).  A ragged S
    is padded with identity steps (da = 0, so decay 1; dt, B, C, x = 0), so
    ``h_final`` is the state after the last real token.  The chunks are
    walked in order with the (N,P) state carried; within a chunk the decay
    exp(s_j - s_i) is taken only where i <= j.  Returns
    (y (B,S,H,P) fp32, h_final (B,H,N,P) fp32).
    """
    b, s, nh, p = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    hg = nh // g
    q = min(chunk, s)
    pad = -s % q
    x32 = xh.float()
    if pad:
        def zpad(t):
            return torch.nn.functional.pad(
                t, [0, 0] * (t.dim() - 2) + [0, pad])
        x32, bm, cm, dt, da = map(zpad, (x32, bm, cm, dt, da))
    nc = (s + pad) // q
    # (B, nc, q, ...) per chunk; heads as (G, H/G) so B/C need no repeat
    xc = x32.reshape(b, nc, q, g, hg, p)
    bc = bm.float().reshape(b, nc, q, g, n)
    cc = cm.float().reshape(b, nc, q, g, n)
    dtc = dt.float().reshape(b, nc, q, g, hg)
    dac = da.float().reshape(b, nc, q, g, hg)
    mask = torch.ones(q, q, dtype=torch.bool, device=xh.device).tril()
    state = torch.zeros(b, g, hg, n, p, dtype=torch.float32,
                        device=xh.device)
    ys = []
    for c in range(nc):
        sgm = dac[:, c].cumsum(1)                            # (b,q,g,hg)
        s_last = sgm[:, -1]                                  # (b,g,hg)
        dtx = dtc[:, c, ..., None] * xc[:, c]                # (b,q,g,hg,p)
        cb = torch.einsum("bjgn,bign->bgji", cc[:, c], bc[:, c])
        ldiff = (sgm[:, :, None] - sgm[:, None, :]).permute(0, 3, 4, 1, 2)
        # M[j,i] = (C_j . B_i) exp(s_j - s_i) for i <= j; the exponent is
        # set to -inf above the diagonal, where it could overflow
        m = cb[:, :, None] * torch.where(mask, ldiff, float("-inf")).exp()
        y = torch.einsum("bgkji,bigkp->bjgkp", m, dtx)
        y = y + torch.einsum("bjgn,bgknp->bjgkp", cc[:, c], state) \
            * sgm.exp()[..., None]
        to_end = (s_last[:, None] - sgm).exp()               # (b,q,g,hg)
        state = state * s_last.exp()[..., None, None] + torch.einsum(
            "bign,bigkp,bigk->bgknp", bc[:, c], dtx, to_end)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(b, nc * q, nh, p)[:, :s]
    y = y + d_skip.float()[:, None] * xh.float()
    return y, state.reshape(b, nh, n, p)


def ssd_scan_recurrent(xh, bm, cm, dt, da, d_skip):
    """The literal recurrence, one token at a time: a port of
    ``src/repro/kernels/ref.py::ssd_scan``, the second yardstick of the
    tests.  Same arguments and results as :func:`ssd_scan`."""
    b, s, nh, p = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    hg = nh // g
    bm_h = bm.float().repeat_interleave(hg, dim=2)           # (B,S,H,N)
    cm_h = cm.float().repeat_interleave(hg, dim=2)
    dtx = dt.float()[..., None] * xh.float()
    h = torch.zeros(b, nh, n, p, dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(s):
        h = h * da[:, t].float().exp()[..., None, None] \
            + bm_h[:, t, :, :, None] * dtx[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", cm_h[:, t], h))
    y = torch.stack(ys, 1) + d_skip.float()[:, None] * xh.float()
    return y, h
