"""qwen3-32b — dense, GQA + qk_norm [hf:Qwen/Qwen3-8B family; hf].

64L, d_model=5120, 64H (kv=8, head_dim=128), d_ff=25600, vocab 151936.

Copied from ``src/repro/configs/qwen3_32b.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1.0e6,
        fsdp=True,
    )
