"""nemotron-4-15b — dense, GQA, squared-ReLU MLP [arXiv:2402.16819; unverified].

32L, d_model=6144, 48H (kv=8, head_dim=128), d_ff=24576, vocab 256000.

Copied from ``src/repro/configs/nemotron_4_15b.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "nemotron-4-15b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        mlp_type="squared_relu",
        norm_type="layernorm",
        rope_theta=10_000.0,
        fsdp=True,
    )
