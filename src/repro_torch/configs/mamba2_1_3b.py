"""Mamba2-1.3B — pure SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified-tier]
48L, d_model 2048, ssm_state 128, head_dim 64 (=> 64 heads at expand 2),
vocab 50280, chunk 64. Constant-size recurrent state => runs long_500k.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,          # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssd",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    conv_width=4,
    act="swiglu",
    tie_embeddings=True,
)
