"""Zamba2-style hybrid LM: a Mamba2 backbone with one weight-shared
attention+MLP block applied after every ``shared_attn_every`` SSM layers
[arXiv:2411.15242].  The serving half.

Port of ``src/repro/models/hybrid.py``.  The parameters keep the JAX tree:
``ssm_blocks`` stacked ``(groups, per, ...)``, one ``shared_block``, the
embedding (tied for zamba2) and the final norm; Python loops replace the
two nested ``lax.scan``s.  The cache is one persistent buffer written in
place, as the dense model's: ``conv (groups, per, B, W-1, C)``, ``ssm
(groups, per, B, H, N, P)`` fp32, ``k``/``v (groups, B, T, K, hd)`` (one
K/V layer per application of the shared block) and ``index (B,)``.

A prefill sets ``conv``, ``ssm``, ``k`` and ``v`` outright for its rows:
unlike stale K/V past ``index``, which the mask hides, SSM state left over
from an earlier batch would be read.  The loss path comes with training.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models import transformer as tr
from repro_torch.models.layers import (
    adtype,
    apply_norm,
    count_params,
    embed_shapes,
    embed_tokens,
    init_params,
    norm_shapes,
    stack_shapes,
    take,
)


def _group_counts(cfg: ModelConfig):
    per = cfg.shared_attn_every
    if cfg.num_layers % per:
        raise ValueError("num_layers must divide by shared_attn_every")
    return cfg.num_layers // per, per


def param_shapes(cfg: ModelConfig) -> dict:
    """The tree ``repro.models.hybrid.hybrid_lm_init`` builds."""
    groups, per = _group_counts(cfg)
    layer = {"ln": norm_shapes(cfg), "ssm": ssm.param_shapes(cfg)}
    return {"embed": embed_shapes(cfg),
            "ssm_blocks": stack_shapes(layer, groups, per),
            "shared_block": tr.block_shapes(cfg),
            "final_norm": norm_shapes(cfg)}


def param_count(cfg: ModelConfig) -> int:
    return count_params(param_shapes(cfg))


def hybrid_lm_init(cfg: ModelConfig, device, generator: torch.Generator):
    """Random parameters made on ``device``, seeded by ``generator``."""
    return init_params(param_shapes(cfg), cfg, device, generator)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    groups, per = _group_counts(cfg)
    conv, state = ssm.init_ssm_state(cfg, batch, device)
    cache = attn.init_kv_cache(cfg, batch, max_len, groups, device,
                               adtype(cfg))
    cache["conv"] = conv.expand(groups, per, *conv.shape).contiguous()
    cache["ssm"] = state.expand(groups, per, *state.shape).contiguous()
    return cache


def hybrid_lm_prefill(params, batch, cfg: ModelConfig,
                      max_len: int | None = None, cache=None):
    """Prefill over the prompt; returns (last-token logits (B,1,V), cache),
    the cache's rows ``:B`` written in place (a fresh cache sized to
    ``max_len``, default the prompt length, when none is given)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    groups, per = _group_counts(cfg)
    if cache is None:
        cache = hybrid_init_cache(cfg, b, max_len or s, tokens.device)
    if cache["k"].shape[1] < b or cache["k"].shape[2] < s:
        raise ValueError(f"cache {tuple(cache['k'].shape)} too small for a "
                         f"({b}, {s}) prompt batch")
    h = embed_tokens(params["embed"], tokens, cfg)
    positions = torch.arange(s, device=tokens.device)[None, :]
    for gi in range(groups):
        for li in range(per):
            lp = take(params["ssm_blocks"], gi, li)
            out, (conv, state) = ssm.ssm_block_prefill(
                lp["ssm"], apply_norm(lp["ln"], h, cfg), cfg)
            h = h + out
            cache["conv"][gi, li, :b] = conv
            cache["ssm"][gi, li, :b] = state
        h, k, v = tr.block_prefill(params["shared_block"], h, cfg, positions)
        cache["k"][gi, :b, :s] = k
        cache["v"][gi, :b, :s] = v
    cache["index"][:b] = s
    return tr.hidden_to_logits(params, h[:, -1:, :], cfg), cache


def hybrid_lm_decode_step(params, cache, tokens, cfg: ModelConfig):
    """tokens: (B, 1) -> (logits (B,1,V), cache), the cache's rows ``:B``
    updated in place, then ``index`` + 1."""
    b = tokens.shape[0]
    groups, per = _group_counts(cfg)
    index = cache["index"][:b]
    h = embed_tokens(params["embed"], tokens, cfg)
    for gi in range(groups):
        for li in range(per):
            lp = take(params["ssm_blocks"], gi, li)
            h = h + ssm.ssm_block_decode(
                lp["ssm"], apply_norm(lp["ln"], h, cfg), cfg,
                cache["conv"][gi, li, :b], cache["ssm"][gi, li, :b])
        h = tr.block_decode(params["shared_block"], h, cfg,
                            cache["k"][gi, :b], cache["v"][gi, :b], index)
    index += 1
    return tr.hidden_to_logits(params, h, cfg), cache
