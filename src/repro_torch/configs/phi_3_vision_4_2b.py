"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend STUB
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L, d_model=3072, 32H (kv=32 — MHA, head_dim=96), d_ff=8192, vocab 32064.
The CLIP vision tower is a STUB: ``input_specs`` provides precomputed patch
embeddings (batch, num_patches, d_model) fused at the head of the sequence.

Copied from ``src/repro/configs/phi_3_vision_4_2b.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "phi-3-vision-4.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        rope_theta=10_000.0,
        frontend="patch_stub",
        num_patches=576,           # 336px CLIP-style patch grid
    )
