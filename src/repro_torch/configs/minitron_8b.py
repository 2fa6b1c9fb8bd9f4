"""minitron-8b — pruned nemotron [arXiv:2407.14679; hf].

32L, d_model=4096, 32H (kv=8, head_dim=128), d_ff=16384, vocab 256000.
Keeps nemotron's squared-ReLU MLP.

Copied from ``src/repro/configs/minitron_8b.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "minitron-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=256000,
        mlp_type="squared_relu",
        norm_type="layernorm",
        rope_theta=10_000.0,
        fsdp=True,
    )
