"""Qwen3-8B — dense GQA with per-head qk-norm.

[hf:Qwen/Qwen3-8B; hf-verified]
36L, d_model 4096, 32 heads (GQA kv=8, head_dim 128), d_ff 12288 (SwiGLU),
vocab 151936, qk_norm on.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151_936,
    qk_norm=True,
    act="swiglu",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
)
