"""seamless-m4t-medium — encoder-decoder, multimodal [arXiv:2308.11596; hf].

12L encoder + 12L decoder, d_model=1024, 16H (kv=16), d_ff=4096,
vocab 256206.  The speech/text modality frontend is a STUB: ``input_specs``
provides precomputed frame embeddings (batch, src_len, d_model).

Copied from ``src/repro/configs/seamless_m4t_medium.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "seamless-m4t-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        num_layers=24,            # 12 enc + 12 dec
        enc_layers=12,
        dec_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        mlp_type="gelu",
        norm_type="layernorm",
        frontend="frame_stub",
        rope_theta=10_000.0,
    )
