"""Model registry: a uniform API over the architecture families.

Port of ``src/repro/models/registry.py``.  Only the dense family is ported;
the others raise until their slice lands.
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


def build_model(cfg: ModelConfig, device="cuda") -> ModelAPI:
    dev = resolve_device(device)
    if cfg.family != "dense" or cfg.num_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    from repro_torch.models import transformer as t

    def init(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return t.lm_init(cfg, dev, gen)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        prefill=functools.partial(t.lm_prefill, cfg=cfg),
        decode_step=functools.partial(t.lm_decode_step, cfg=cfg),
        init_cache=lambda batch, max_len: t.init_cache(cfg, batch, max_len,
                                                       dev),
    )


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the parameter shapes (dense family only, where
    every parameter is active)."""
    from repro_torch.models import transformer as t
    del active_only
    return t.param_count(cfg)
