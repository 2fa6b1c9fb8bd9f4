"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B family; hf].

94L, d_model=4096, 64H (kv=4, head_dim=128), expert d_ff=1536, vocab 151936.

Copied from ``src/repro/configs/qwen3_moe_235b_a22b.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,                 # per-expert FFN width
        vocab_size=151936,
        num_experts=128,
        num_experts_per_token=8,
        qk_norm=True,
        rope_theta=1.0e6,
        fsdp=True,
    )
