"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24 blocks, d_model=1024, 4 heads, d_ff=0 (blocks carry their own up/down
projections), vocab 50304.  7:1 mLSTM:sLSTM ratio -> every 8th block sLSTM.

Copied from ``src/repro/configs/xlstm_350m.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "xlstm-350m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab_size=50304,
        slstm_every=8,
        mlstm_proj_factor=2.0,
        norm_type="layernorm",
        tie_embeddings=True,
    )
