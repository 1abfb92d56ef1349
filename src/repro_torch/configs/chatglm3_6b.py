"""ChatGLM3-6B — 2D (partial) RoPE, aggressive GQA (kv=2).

[arXiv:2406.12793; hf-verified]
28L, d_model 4096, 32 heads (GQA kv=2, head_dim 128), d_ff 13696 (SwiGLU),
vocab 65024. rope_mode="half": rotary on the first half of each head dim.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_mode="half",
    act="swiglu",
    tie_embeddings=False,
)
