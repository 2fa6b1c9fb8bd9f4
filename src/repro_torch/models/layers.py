"""Shared building blocks: norms, RoPE, MLP variants, embeddings.

Port of ``src/repro/models/layers.py``.  Plain functions over nested dicts
of tensors, in the JAX package's layouts; numerically sensitive reductions
(norms, RoPE) run in float32 and cast back to the activation dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

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
# parameter trees: shapes first, then seeded tensors on the device
# ---------------------------------------------------------------------------

DENSE, ONES, ZEROS = "dense", "ones", "zeros"
# a draw larger than this many elements is split along its leading axis
_MAX_DRAW = 1 << 26


class Param(NamedTuple):
    """A leaf of a parameter-shape tree: its shape, its init (``DENSE``:
    normal x ``scale``, as ``dense_init``; ``ONES``; ``ZEROS``) and its
    dtype (None: the config's ``param_dtype``)."""
    shape: tuple
    kind: str
    dtype: Optional[torch.dtype] = None
    scale: float = 0.02


def norm_shapes(cfg: ModelConfig) -> dict:
    p = {"scale": Param((cfg.d_model,), ONES)}
    if cfg.norm_type == "layernorm":
        p["bias"] = Param((cfg.d_model,), ZEROS)
    return p


def mlp_shapes(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"wg": Param((d, f), DENSE), "wu": Param((d, f), DENSE),
                "wd": Param((f, d), DENSE)}
    return {"wi": Param((d, f), DENSE), "wd": Param((f, d), DENSE)}


def embed_shapes(cfg: ModelConfig) -> dict:
    p = {"embedding": Param((cfg.vocab_size, cfg.d_model), DENSE)}
    if not cfg.tie_embeddings:
        p["lm_head"] = Param((cfg.d_model, cfg.vocab_size), DENSE)
    return p


def stack_shapes(tree, *lead: int):
    """``tree`` with leading axes ``lead`` on every leaf (``stack_init``)."""
    if isinstance(tree, dict):
        return {key: stack_shapes(v, *lead) for key, v in tree.items()}
    return tree._replace(shape=(*lead, *tree.shape))


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return math.prod(tree.shape)


def _draw(out, scale: float, generator, split: bool) -> None:
    if out.dim() > 2 and (split or out.numel() > _MAX_DRAW):
        for part in out:
            _draw(part, scale, generator, False)
    else:
        out.copy_(scale * torch.randn(out.shape, generator=generator,
                                      device=out.device))


def init_params(tree, cfg: ModelConfig, device, generator: torch.Generator):
    """Random parameters for a shape tree, made on ``device``.  Dense
    weights are drawn in float32 one leading slice at a time (one layer of
    a stacked weight), so the float32 scratch stays small."""
    if isinstance(tree, dict):
        return {key: init_params(v, cfg, device, generator)
                for key, v in tree.items()}
    dt = tree.dtype or pdtype(cfg)
    if tree.kind == ONES:
        return torch.ones(tree.shape, dtype=dt, device=device)
    if tree.kind == ZEROS:
        return torch.zeros(tree.shape, dtype=dt, device=device)
    out = torch.empty(tree.shape, dtype=dt, device=device)
    _draw(out, tree.scale, generator, True)
    return out


def take(tree, *index):
    """The slice ``index`` of every leaf of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {key: take(v, *index) for key, v in tree.items()}
    return tree[index]


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
    elif cfg.mlp_type == "squared_relu":
        h = F.relu(x @ params["wi"].to(x.dtype)).square()
    elif cfg.mlp_type == "gelu":
        # the tanh approximation, as jax.nn.gelu computes by default
        h = F.gelu(x @ params["wi"].to(x.dtype), approximate="tanh")
    else:
        raise ValueError(f"mlp_type {cfg.mlp_type!r}: one of swiglu, "
                         "squared_relu, gelu")
    return h @ params["wd"].to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig):
    return params["embedding"][tokens.long()].to(adtype(cfg))


def unembed(params, x, cfg: ModelConfig):
    """Returns logits (..., V) in the activation dtype; a tied config reads
    the embedding table (V, D), an untied one ``lm_head`` (D, V)."""
    if cfg.tie_embeddings:
        return x @ params["embedding"].to(x.dtype).T
    return x @ params["lm_head"].to(x.dtype)
