"""Decoder-only transformer LM, dense family: init, prefill, decode.

Port of ``src/repro/models/transformer.py`` (dense serving path).  The
parameters keep the JAX tree: per-layer weights are stacked on a leading
layer axis (``stack_init``), so ``params["blocks"]["attn"]["wq"]`` is
``(L, D, H, hd)``; a Python loop over layers replaces ``lax.scan``.  The
KV cache is ``(L, B, T, K, hd)``, sized to ``max_len`` and written in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    DENSE,
    ONES,
    Param,
    adtype,
    apply_mlp,
    apply_norm,
    count_params,
    embed_shapes,
    embed_tokens,
    init_params,
    mlp_shapes,
    norm_shapes,
    stack_shapes,
    take,
    unembed,
)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def block_shapes(cfg: ModelConfig) -> dict:
    """One block's tree (``repro.models.transformer.block_init``, dense)."""
    d = cfg.d_model
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    att = {"wq": Param((d, h, hd), DENSE), "wk": Param((d, k, hd), DENSE),
           "wv": Param((d, k, hd), DENSE), "wo": Param((h, hd, d), DENSE)}
    if cfg.qk_norm:
        att["q_norm"] = Param((hd,), ONES)
        att["k_norm"] = Param((hd,), ONES)
    return {"ln1": norm_shapes(cfg), "attn": att, "ln2": norm_shapes(cfg),
            "mlp": mlp_shapes(cfg)}


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree as :class:`~repro_torch.models.layers.Param`
    leaves, the same tree ``repro.models.transformer.lm_init`` builds for a
    dense config."""
    if cfg.num_experts:
        raise NotImplementedError("only the dense family is ported")
    return {"embed": embed_shapes(cfg),
            "blocks": stack_shapes(block_shapes(cfg), cfg.num_layers),
            "final_norm": norm_shapes(cfg)}


def param_count(cfg: ModelConfig) -> int:
    return count_params(param_shapes(cfg))


def lm_init(cfg: ModelConfig, device, generator: torch.Generator):
    """Random parameters made on ``device`` in ``param_dtype``: normal x 0.02
    for weights (as ``dense_init``), ones for norm scales, zeros for norm
    biases."""
    return init_params(param_shapes(cfg), cfg, device, generator)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def block_prefill(lp, h, cfg: ModelConfig, positions):
    """One block over the prompt (``block_apply``, keeping the block's k/v
    for the cache): h (B,S,D) -> (h, k (B,S,K,hd), v)."""
    hn = apply_norm(lp["ln1"], h, cfg)
    q, k, v = attn.project_qkv(lp["attn"], hn, cfg, positions)
    o = attn.prefill_attention(q, k, v, cfg)
    h = h + attn.project_out(lp["attn"], o, h.dtype)
    h = h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg), cfg)
    return h, k, v


def block_decode(lp, h, cfg: ModelConfig, layer_k, layer_v, index):
    """One block for one token (``block_decode``): h (B,1,D); the token's
    k/v are written into ``layer_k``/``layer_v`` (B,T,K,hd) at ``index``."""
    x = apply_norm(lp["ln1"], h, cfg)
    h = h + attn.self_attention_decode(lp["attn"], x, cfg, layer_k=layer_k,
                                       layer_v=layer_v, index=index)
    return h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg), cfg)


# ---------------------------------------------------------------------------
# serving forward
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return attn.init_kv_cache(cfg, batch, max_len, cfg.num_layers, device,
                              adtype(cfg))


def hidden_to_logits(params, h, cfg: ModelConfig):
    return unembed(params["embed"], apply_norm(params["final_norm"], h, cfg),
                   cfg)


def lm_prefill(params, batch, cfg: ModelConfig, max_len: int | None = None,
               cache=None):
    """Prefill over the prompt; returns (last-token logits (B,1,V), cache).

    The prompt's k/v are written into ``cache`` in place (a fresh cache
    sized to ``max_len``, default the prompt length, when none is given).
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, max_len or s, tokens.device)
    if cache["k"].shape[1] < b or cache["k"].shape[2] < s:
        raise ValueError(f"cache {tuple(cache['k'].shape)} too small for a "
                         f"({b}, {s}) prompt batch")
    h = embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(s, device=tokens.device)[None, :]
    for i in range(cfg.num_layers):
        h, k, v = block_prefill(take(params["blocks"], i), h, cfg,
                                positions)
        cache["k"][i, :b, :s] = k
        cache["v"][i, :b, :s] = v
    cache["index"][:b] = s
    return hidden_to_logits(params, h[:, -1:, :], cfg), cache


def lm_decode_step(params, cache, tokens, cfg: ModelConfig):
    """tokens: (B, 1) -> (logits (B,1,V), cache), the cache updated in
    place (the token's k/v written at ``index``, then ``index`` + 1)."""
    b = tokens.shape[0]
    index = cache["index"][:b]
    h = embed_tokens(params["embed"], tokens, cfg)
    for i in range(cfg.num_layers):
        h = block_decode(take(params["blocks"], i), h, cfg,
                         cache["k"][i, :b], cache["v"][i, :b], index)
    index += 1
    return hidden_to_logits(params, h, cfg), cache
