"""granite-moe-1b-a400m — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L, d_model=1024, 16H (kv=8, head_dim=64), expert d_ff=512, vocab 49155.

Copied from ``src/repro/configs/granite_moe_1b_a400m.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "granite-moe-1b-a400m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,                  # per-expert FFN width
        vocab_size=49155,
        num_experts=32,
        num_experts_per_token=8,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
