"""Architecture registry: the 10 assigned architectures × 4 assigned shapes.

Copied from ``src/repro/configs/__init__.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    Cell,
    ModelConfig,
    ShapeConfig,
    SHAPES,
    SMOKE_DECODE_SHAPE,
    SMOKE_PREFILL_SHAPE,
    SMOKE_SHAPE,
    cell_skip_reason,
    cells,
    reduce_for_smoke,
)

from repro_torch.configs import (
    xlstm_350m,
    seamless_m4t_medium,
    zamba2_2_7b,
    qwen3_32b,
    nemotron_4_15b,
    granite_8b,
    minitron_8b,
    qwen3_moe_235b_a22b,
    granite_moe_1b_a400m,
    phi_3_vision_4_2b,
)

_MODULES = (
    xlstm_350m,
    seamless_m4t_medium,
    zamba2_2_7b,
    qwen3_32b,
    nemotron_4_15b,
    granite_8b,
    minitron_8b,
    qwen3_moe_235b_a22b,
    granite_moe_1b_a400m,
    phi_3_vision_4_2b,
)

ARCHS: dict[str, object] = {m.ARCH_ID: m for m in _MODULES}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id].config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return reduce_for_smoke(get_config(arch_id))


def list_archs() -> list[str]:
    return list(ARCHS)


__all__ = [
    "ARCHS", "Cell", "ModelConfig", "ShapeConfig", "SHAPES",
    "SMOKE_SHAPE", "SMOKE_DECODE_SHAPE", "SMOKE_PREFILL_SHAPE",
    "cells", "cell_skip_reason", "get_config", "get_smoke_config",
    "list_archs", "reduce_for_smoke",
]
