"""Shared building blocks: norms, RoPE, MLP variants, embeddings.

Port of ``src/repro/models/layers.py``.  Plain functions over nested dicts
of tensors, in the JAX package's layouts; numerically sensitive reductions
(norms, RoPE) run in float32 and cast back to the activation dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def adtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def apply_norm(params, x, cfg: ModelConfig, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


def rms_normalize(x, scale=None, eps: float = 1e-6):
    """Headwise RMS norm used for qk_norm; operates on the last dim."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (half split: concatenated halves)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def apply_mlp(params, x, cfg: ModelConfig):
    if cfg.mlp_type == "swiglu":
        g = x @ params["wg"].to(x.dtype)
        u = x @ params["wu"].to(x.dtype)
        h = F.silu(g) * u
    else:  # squared_relu, the other MLP of the dense configs
        h = F.relu(x @ params["wi"].to(x.dtype)).square()
    return h @ params["wd"].to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig):
    return params["embedding"][tokens.long()].to(adtype(cfg))


def unembed(params, x):
    """Returns logits (..., V) in the activation dtype (untied ``lm_head``,
    as every dense config has)."""
    return x @ params["lm_head"].to(x.dtype)              # (D, V)
