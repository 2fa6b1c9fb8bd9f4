"""Decoder-only transformer LM, dense family: init, prefill, decode.

Port of ``src/repro/models/transformer.py`` (dense serving path).  The
parameters keep the JAX tree: per-layer weights are stacked on a leading
layer axis (``stack_init``), so ``params["blocks"]["attn"]["wq"]`` is
``(L, D, H, hd)``; a Python loop over layers replaces ``lax.scan``.  The
KV cache is ``(L, B, T, K, hd)``, sized to ``max_len`` and written in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    adtype,
    apply_mlp,
    apply_norm,
    embed_tokens,
    pdtype,
    unembed,
)

DENSE, ONES, ZEROS = "dense", "ones", "zeros"


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _norm_shapes(cfg: ModelConfig) -> dict:
    p = {"scale": ((cfg.d_model,), ONES)}
    if cfg.norm_type == "layernorm":
        p["bias"] = ((cfg.d_model,), ZEROS)
    return p


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree as ``(shape, init kind)`` leaves, the same tree
    ``repro.models.transformer.lm_init`` builds for a dense config."""
    if cfg.num_experts or cfg.tie_embeddings:
        raise NotImplementedError("only the dense family is ported")
    d, f, n = cfg.d_model, cfg.d_ff, cfg.num_layers
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    att = {"wq": ((d, h, hd), DENSE), "wk": ((d, k, hd), DENSE),
           "wv": ((d, k, hd), DENSE), "wo": ((h, hd, d), DENSE)}
    if cfg.qk_norm:
        att["q_norm"] = ((hd,), ONES)
        att["k_norm"] = ((hd,), ONES)
    if cfg.mlp_type == "swiglu":
        mlp = {"wg": ((d, f), DENSE), "wu": ((d, f), DENSE),
               "wd": ((f, d), DENSE)}
    else:
        mlp = {"wi": ((d, f), DENSE), "wd": ((f, d), DENSE)}
    block = {"ln1": _norm_shapes(cfg), "attn": att, "ln2": _norm_shapes(cfg),
             "mlp": mlp}

    def stacked(tree):
        if isinstance(tree, dict):
            return {key: stacked(v) for key, v in tree.items()}
        shape, kind = tree
        return ((n, *shape), kind)

    embed = {"embedding": ((cfg.vocab_size, d), DENSE),
             "lm_head": ((d, cfg.vocab_size), DENSE)}
    return {"embed": embed, "blocks": stacked(block),
            "final_norm": _norm_shapes(cfg)}


def param_count(cfg: ModelConfig) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return math.prod(tree[0])
    return count(param_shapes(cfg))


def lm_init(cfg: ModelConfig, device, generator: torch.Generator):
    """Random parameters made on ``device`` in ``param_dtype``: normal x 0.02
    for weights (as ``dense_init``), ones for norm scales, zeros for norm
    biases.  Stacked weights are drawn one layer at a time in float32, so
    the float32 scratch is one layer's worth, never the whole model."""
    dt = pdtype(cfg)

    def make(tree):
        if isinstance(tree, dict):
            return {key: make(v) for key, v in tree.items()}
        shape, kind = tree
        if kind == ONES:
            return torch.ones(shape, dtype=dt, device=device)
        if kind == ZEROS:
            return torch.zeros(shape, dtype=dt, device=device)
        out = torch.empty(shape, dtype=dt, device=device)
        for part in (out if len(shape) > 2 else (out,)):
            part.copy_(0.02 * torch.randn(part.shape, generator=generator,
                                          device=device))
        return out

    return make(param_shapes(cfg))


def layer_params(params, i: int) -> dict:
    """Layer ``i``'s slice of the stacked block parameters (views)."""
    def take(tree):
        if isinstance(tree, dict):
            return {key: take(v) for key, v in tree.items()}
        return tree[i]
    return take(params["blocks"])


# ---------------------------------------------------------------------------
# serving forward
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return attn.init_kv_cache(cfg, batch, max_len, cfg.num_layers, device,
                              adtype(cfg))


def hidden_to_logits(params, h, cfg: ModelConfig):
    return unembed(params["embed"], apply_norm(params["final_norm"], h, cfg))


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
        lp = layer_params(params, i)
        hn = apply_norm(lp["ln1"], h, cfg)
        q, k, v = attn.project_qkv(lp["attn"], hn, cfg, positions)
        o = attn.prefill_attention(q, k, v, cfg)
        h = h + attn.project_out(lp["attn"], o, h.dtype)
        h = h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg), cfg)
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
        lp = layer_params(params, i)
        x = apply_norm(lp["ln1"], h, cfg)
        h = h + attn.self_attention_decode(
            lp["attn"], x, cfg, layer_k=cache["k"][i, :b],
            layer_v=cache["v"][i, :b], index=index)
        h = h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg), cfg)
    index += 1
    return hidden_to_logits(params, h, cfg), cache
