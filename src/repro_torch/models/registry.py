"""Model registry: a uniform API over the architecture families.

Port of ``src/repro/models/registry.py``.  The dense family (without
experts) and the hybrid family are ported; the others raise until their
slice lands.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]                    # (seed=0) -> params on device
    prefill: Callable[..., Any]                 # (params, batch, max_len, cache) -> (logits, cache)
    decode_step: Callable[[Any, Any, Any], Any] # (params, cache, tokens) -> (logits, cache)
    init_cache: Callable[..., Any]              # (batch, max_len) -> cache


def _family(cfg: ModelConfig):
    """(init, prefill, decode_step, init_cache, param_count) of the config's
    family."""
    if cfg.family == "dense" and not cfg.num_experts:
        from repro_torch.models import transformer as t
        return (t.lm_init, t.lm_prefill, t.lm_decode_step, t.init_cache,
                t.param_count)
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid as hb
        return (hb.hybrid_lm_init, hb.hybrid_lm_prefill,
                hb.hybrid_lm_decode_step, hb.hybrid_init_cache,
                hb.param_count)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (dense and hybrid only)")


def build_model(cfg: ModelConfig, device="cuda") -> ModelAPI:
    dev = resolve_device(device)
    init_fn, prefill, decode_step, init_cache, _ = _family(cfg)

    def init(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_fn(cfg, dev, gen)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        prefill=functools.partial(prefill, cfg=cfg),
        decode_step=functools.partial(decode_step, cfg=cfg),
        init_cache=lambda batch, max_len: init_cache(cfg, batch, max_len,
                                                     dev),
    )


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the parameter shapes (the ported families have
    no experts, so every parameter is active)."""
    del active_only
    return _family(cfg)[4](cfg)
