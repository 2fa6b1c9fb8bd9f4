"""granite-8b — llama-arch code model [arXiv:2405.04324; hf].

36L, d_model=4096, 32H (kv=8, head_dim=128), d_ff=14336, vocab 49152.

Copied from ``src/repro/configs/granite_8b.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "granite-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=49152,
        rope_theta=10_000.0,
        fsdp=True,
    )
