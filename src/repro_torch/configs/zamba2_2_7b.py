"""zamba2-2.7b — Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242; hf].

54 Mamba2 layers, d_model=2560, ssm_state=64; one weight-shared attention+MLP
block (32H, kv=32, d_ff=10240) applied every 6 layers, vocab 32000.

Copied from ``src/repro/configs/zamba2_2_7b.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "zamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,             # shared attention block
        num_kv_heads=32,
        d_ff=10240,               # shared block MLP
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk=256,
        shared_attn_every=6,
        tie_embeddings=True,
    )
