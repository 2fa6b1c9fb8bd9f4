"""Grouped-query attention with RoPE, optional qk-norm and a KV cache.

Port of ``src/repro/models/attention.py`` (the parts the dense serving
path runs).  Projections keep the JAX layouts: ``wq (D,H,hd)``,
``wk``/``wv (D,K,hd)``, ``wo (H,hd,D)``.

Prefill attention always goes through
:func:`repro_torch.kernels.ops.flash_attention`: on a CUDA tensor that is
the hand-written kernel at every prompt length, on a CPU tensor its plain
version, which computes the same function as the JAX package's ``attend``
and ``attend_blockwise`` at S == T without a logit softcap.  Decode
attends over the in-place cache with :func:`attend`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rms_normalize

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def project_qkv(params, x, cfg: ModelConfig, positions=None, rope: bool = True):
    """x: (B, S, D) -> q (B,S,H,hd), k (B,S,K,hd), v (B,S,K,hd)."""
    b, s, d = x.shape

    def proj(w):                                  # (D, N, hd) -> (B, S, N, hd)
        return (x @ w.to(x.dtype).reshape(d, -1)).view(b, s, *w.shape[1:])

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    if cfg.qk_norm:
        q = rms_normalize(q, params["q_norm"])
        k = rms_normalize(k, params["k_norm"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def project_out(params, o, x_dtype):
    """o: (B, S, H, hd) -> (B, S, D)."""
    b, s = o.shape[:2]
    wo = params["wo"].to(x_dtype)
    return o.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attend(q, k, v, mask):
    """q: (B,S,H,hd); k/v: (B,T,K,hd); mask broadcastable to (B,K,G,S,T).
    No logit softcap: :func:`prefill_attention` refuses configs with one."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, hd)
    scale = float(1.0 / np.sqrt(np.float32(hd)))     # f32, as the JAX code
    scores = torch.einsum("bskge,btke->bkgst", qg, k).float() * scale
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkgst,btke->bskge", w, v)
    return o.reshape(b, s, h, hd)


def prefill_attention(q, k, v, cfg: ModelConfig):
    """Causal self-attention over the prompt, through the flash wrapper."""
    if cfg.attn_logit_softcap:
        raise NotImplementedError(
            "the flash attention kernel has no logit softcap")
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def decode_mask(index, t: int):
    """index: (B,) current position; keys j <= index valid. -> (B,1,1,1,T)."""
    kj = torch.arange(t, device=index.device)[None, :]
    return (kj <= index[:, None])[:, None, None, None]


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  device, dtype: torch.dtype):
    """Preallocated (L,B,T,K,hd) k/v buffers plus the per-row position.

    The JAX package donates its cache through ``jit`` so XLA reuses the
    allocation; PyTorch runs eagerly, so the port allocates the cache once
    and writes every prefill and decode step into it in place."""
    shape = (n_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim())
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": torch.zeros((batch,), dtype=torch.int64, device=device),
    }


def cache_insert_token(layer_k, layer_v, k, v, index):
    """Write one token's k/v (B,1,K,hd) at per-row position ``index`` (B,),
    in place."""
    rows = torch.arange(k.shape[0], device=k.device)
    layer_k[rows, index] = k[:, 0].to(layer_k.dtype)
    layer_v[rows, index] = v[:, 0].to(layer_v.dtype)


def self_attention_decode(params, x, cfg: ModelConfig, *, layer_k, layer_v,
                          index, rope=True):
    """One-token decode: x (B,1,D); cache layer (B,T,K,hd); index (B,)."""
    q, k, v = project_qkv(params, x, cfg, index[:, None], rope=rope)
    cache_insert_token(layer_k, layer_v, k, v, index)
    mask = decode_mask(index, layer_k.shape[1])
    o = attend(q, layer_k.to(q.dtype), layer_v.to(q.dtype), mask)
    return project_out(params, o, x.dtype)
