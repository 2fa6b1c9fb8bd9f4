"""Configuration system for ROCKET-JAX.

Every assigned architecture is expressed as a :class:`ModelConfig`; the four
assigned input shapes are :class:`ShapeConfig` instances.  ``(arch, shape)``
cells are enumerated by :func:`cells` with explicit skip reasons (e.g.
``long_500k`` for pure full-attention architectures).

Copied from ``src/repro/configs/base.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- block variants -----------------------------------------------------
    mlp_type: str = "swiglu"        # swiglu | squared_relu | gelu
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    qk_norm: bool = False
    rope_theta: float = 1.0e6
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # --- hybrid (zamba2-style shared attention block) -------------------------
    shared_attn_every: int = 0      # apply the weight-shared attn+MLP block every k layers

    # --- xLSTM ----------------------------------------------------------------
    slstm_every: int = 0            # every k-th block is an sLSTM block (rest mLSTM)
    mlstm_proj_factor: float = 2.0

    # --- encoder-decoder -------------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0

    # --- modality frontends (STUBS: precomputed embeddings) --------------------
    frontend: str = "none"          # none | patch_stub | frame_stub
    num_patches: int = 0            # vlm: patch embeddings prepended to the sequence

    # --- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"         # activation dtype
    param_dtype: str = "bfloat16"   # parameter storage dtype

    # --- scale / sharding hints ---------------------------------------------------
    fsdp: bool = False              # shard parameters over the data axis too
    remat: bool = True              # rematerialize block internals

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM / hybrid / linear-attention families."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        """All assigned archs have a decoder (none are encoder-only)."""
        return True

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        from repro_torch.models.registry import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import count_params_analytic
        return count_params_analytic(self, active_only=True)


# ---------------------------------------------------------------------------
# Shape configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch        # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    "train",   4_096,   256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768,  32),
    "decode_32k":  ShapeConfig("decode_32k",  "decode",  32_768,  128),
    "long_500k":   ShapeConfig("long_500k",   "decode",  524_288, 1),
}


# ---------------------------------------------------------------------------
# Smoke-test reduction
# ---------------------------------------------------------------------------

def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant: few layers, narrow width, tiny tables."""
    kv = max(2, min(cfg.num_kv_heads, 2))
    changes = dict(
        num_layers=max(2, min(cfg.num_layers, 2)),
        d_model=64,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=128,
        dtype="float32",
        param_dtype="float32",
        fsdp=False,
        remat=False,
    )
    if cfg.num_experts:
        # cf=4.0 makes the tiny config dropless (cap >= group size), so the
        # prefill-vs-decode consistency tests are exact.
        changes.update(num_experts=4, num_experts_per_token=2,
                       moe_capacity_factor=4.0)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.shared_attn_every:
        # keep the hybrid pattern visible: 4 ssm layers, shared block every 2
        changes.update(num_layers=4, shared_attn_every=2)
    if cfg.slstm_every:
        changes.update(num_layers=2, slstm_every=2)
    if cfg.enc_layers:
        changes.update(enc_layers=2, dec_layers=2)
    if cfg.num_patches:
        changes.update(num_patches=8)
    return replace(cfg, **changes)


SMOKE_SHAPE = ShapeConfig("smoke", "train", 32, 2)
SMOKE_DECODE_SHAPE = ShapeConfig("smoke_decode", "decode", 32, 2)
SMOKE_PREFILL_SHAPE = ShapeConfig("smoke_prefill", "prefill", 32, 2)


# ---------------------------------------------------------------------------
# Cell enumeration (arch x shape) with skip reasons
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    skip_reason: Optional[str] = None

    @property
    def runnable(self) -> bool:
        return self.skip_reason is None


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention arch: 512k-token quadratic KV decode is "
                "sub-quadratic-only per assignment (see DESIGN.md §5)")
    return None


def cells(arch_ids=None, shape_names=None) -> list[Cell]:
    from repro_torch.configs import ARCHS, get_config
    out = []
    for a in (arch_ids or list(ARCHS)):
        cfg = get_config(a)
        for s in (shape_names or list(SHAPES)):
            out.append(Cell(a, s, cell_skip_reason(cfg, SHAPES[s])))
    return out
