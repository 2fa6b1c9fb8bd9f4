"""Mamba2 (SSD, state-space duality) block: the serving half.

Port of ``src/repro/models/ssm.py``: init, the chunked prefill that keeps
the conv and SSM state for the cache, and the one-token decode step.  The
JAX layouts are kept (``in_proj (D, 2*d_inner + 2*G*N + H)`` emitting
``[z, x, B, C, dt]``, ``conv_w (W, conv_dim)``; ``A_log``, ``D`` and
``dt_bias`` in float32).

Recurrence (per head h, state N x P):
    h_t = exp(A dt_t) h_{t-1} + dt_t B_t (x) x_t
    y_t = C_t . h_t + D x_t
with A = -exp(A_log) < 0, dt = softplus(dt_raw + dt_bias).

Prefill's scan always goes through :func:`repro_torch.kernels.ops.ssd_scan`:
on a CUDA tensor the hand-written kernel, on a CPU tensor its plain version,
which computes the JAX prefill's ``ssd_chunked``.  The loss path
(``ssm_block_apply``) comes with training.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    DENSE,
    ONES,
    ZEROS,
    Param,
    adtype,
    init_params,
)


def ssm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def param_shapes(cfg: ModelConfig) -> dict:
    """The tree ``repro.models.ssm.ssm_init`` builds."""
    d = cfg.d_model
    d_inner, n_heads, conv_dim = ssm_dims(cfg)
    g, n, w = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv_width
    proj_out = 2 * d_inner + 2 * g * n + n_heads
    f32 = torch.float32
    return {
        "in_proj": Param((d, proj_out), DENSE),
        "conv_w": Param((w, conv_dim), DENSE, scale=0.5),
        "conv_b": Param((conv_dim,), ZEROS),
        "A_log": Param((n_heads,), ZEROS, f32),
        "D": Param((n_heads,), ONES, f32),
        "dt_bias": Param((n_heads,), ZEROS, f32),
        "norm_scale": Param((d_inner,), ONES),
        "out_proj": Param((d_inner, d), DENSE),
    }


def ssm_init(cfg: ModelConfig, device, generator: torch.Generator):
    """Random block parameters made on ``device`` (the JAX init's shapes
    and dtypes)."""
    return init_params(param_shapes(cfg), cfg, device, generator)


# ---------------------------------------------------------------------------
# projections / conv
# ---------------------------------------------------------------------------

def _split_proj(proj, cfg: ModelConfig):
    d_inner, _, _ = ssm_dims(cfg)
    gn = cfg.ssm_ngroups * cfg.ssm_state
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner: 2 * d_inner + 2 * gn]
    dt_raw = proj[..., 2 * d_inner + 2 * gn:]
    return z, xbc, dt_raw


def causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv: xbc (B,S,C), conv_w (W,C) -> (B,S,C), summed
    tap by tap in xbc's dtype, as the JAX code."""
    w = conv_w.shape[0]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(w):
        out = out + pad[:, i: i + s, :] * conv_w[i].to(xbc.dtype)
    return out + conv_b.to(xbc.dtype)


def conv_step(x_t, conv_state, conv_w, conv_b):
    """One-token conv: x_t (B,C); conv_state (B,W-1,C) -> (y_t,
    new_state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # (B,W,C)
    y = torch.einsum("bwc,wc->bc", window, conv_w.to(x_t.dtype))
    return y + conv_b.to(x_t.dtype), window[:, 1:, :]


def _gates(xbc_conv, dt_raw, params, cfg: ModelConfig):
    d_inner, n_heads, _ = ssm_dims(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    x = xbc_conv[..., :d_inner]
    bmat = xbc_conv[..., d_inner: d_inner + g * n]
    cmat = xbc_conv[..., d_inner + g * n:]
    lead = x.shape[:-1]
    xh = x.reshape(*lead, n_heads, cfg.ssm_head_dim)
    bm = bmat.reshape(*lead, g, n).float()
    cm = cmat.reshape(*lead, g, n).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])                    # (H,) negative
    return xh, bm, cm, dt, dt * a                      # da: log-decay


def ssd_recurrent_step(state, xh, bm, cm, dt, da, d_skip):
    """One decode step.  state (B,H,N,P); xh (B,H,P); bm/cm (B,G,N); dt/da
    (B,H) -> (y (B,H,P) fp32, new state)."""
    hg = state.shape[1] // bm.shape[1]
    bm_h = bm.repeat_interleave(hg, dim=1)             # (B,H,N)
    cm_h = cm.repeat_interleave(hg, dim=1)
    dtx = dt[..., None] * xh.float()                   # (B,H,P)
    new_state = state * torch.exp(da)[..., None, None] \
        + bm_h[..., :, None] * dtx[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", cm_h, new_state)
    return y + d_skip[:, None] * xh.float(), new_state


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _gated_norm(y, z, scale, eps: float = 1e-6):
    """Mamba2 gated RMSNorm: rmsnorm(y * silu(z)) * scale, in float32."""
    yf = y.float() * F.silu(z.float())
    ms = yf.square().mean(-1, keepdim=True)
    return yf * torch.rsqrt(ms + eps) * scale.float()


def ssm_block_prefill(params, x, cfg: ModelConfig):
    """x: (B, S, D) -> (out (B,S,D), (conv_state (B,W-1,C), h_final
    (B,H,N,P) fp32)).  ``conv_state`` is the pre-conv ``xbc`` of the last
    W-1 tokens, left-padded with zeros when S < W-1."""
    b, s, _ = x.shape
    d_inner, _, _ = ssm_dims(cfg)
    w = cfg.ssm_conv_width
    proj = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    conv_state = xbc[:, -(w - 1):, :] if s >= w - 1 else F.pad(
        xbc, (0, 0, w - 1 - s, 0))
    xbc = F.silu(causal_conv(xbc, params["conv_w"], params["conv_b"]))
    xh, bm, cm, dt, da = _gates(xbc, dt_raw, params, cfg)
    y, h_final = ops.ssd_scan(xh.contiguous(), bm.contiguous(),
                              cm.contiguous(), dt.contiguous(),
                              da.contiguous(), params["D"],
                              chunk=cfg.ssm_chunk)
    y = _gated_norm(y.reshape(b, s, d_inner), z,
                    params["norm_scale"]).to(x.dtype)
    return y @ params["out_proj"].to(x.dtype), (conv_state, h_final)


def ssm_block_decode(params, x, cfg: ModelConfig, conv_state, ssm_state):
    """x: (B, 1, D) one-token decode -> out (B,1,D).  ``conv_state``
    (B,W-1,C) and ``ssm_state`` (B,H,N,P) are the cache's rows, updated in
    place (the JAX function returns them anew)."""
    b = x.shape[0]
    d_inner, _, _ = ssm_dims(cfg)
    proj = x[:, 0] @ params["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    y_conv, new_conv = conv_step(xbc, conv_state, params["conv_w"],
                                 params["conv_b"])
    xh, bm, cm, dt, da = _gates(F.silu(y_conv), dt_raw, params, cfg)
    y, new_state = ssd_recurrent_step(ssm_state, xh, bm, cm, dt, da,
                                      params["D"])
    conv_state.copy_(new_conv)
    ssm_state.copy_(new_state)
    y = _gated_norm(y.reshape(b, d_inner), z,
                    params["norm_scale"]).to(x.dtype)
    return (y @ params["out_proj"].to(x.dtype))[:, None, :]


def init_ssm_state(cfg: ModelConfig, batch: int, device):
    """Zero (conv_state (B,W-1,C) in the activation dtype, ssm_state
    (B,H,N,P) fp32)."""
    _, n_heads, conv_dim = ssm_dims(cfg)
    return (
        torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                    dtype=adtype(cfg), device=device),
        torch.zeros((batch, n_heads, cfg.ssm_state, cfg.ssm_head_dim),
                    dtype=torch.float32, device=device),
    )
