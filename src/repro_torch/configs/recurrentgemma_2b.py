"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, 1 attn : 2 rec.

[arXiv:2402.19427; hf-verified]
26L, d_model 2560, 10 heads (MQA kv=1, head_dim 256), d_ff 7680 (GeGLU),
vocab 256000, lru_width 2560, window 2048. Pattern (rec, rec, attn) x 8
+ tail (rec, rec) = 26 layers. Sub-quadratic => runs long_500k.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rec", "rec", "local_attn"),
    window=2048,
    lru_width=2560,
    conv_width=4,
    act="geglu",
    tie_embeddings=True,
)
