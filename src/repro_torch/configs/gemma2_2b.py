"""Gemma-2 2B — alternating local/global attention with logit softcaps.

[arXiv:2408.00118; hf-verified]
26L, d_model 2304, 8 heads (GQA kv=4, head_dim 256), d_ff 9216 (GeGLU),
vocab 256000, window 4096, attn softcap 50, final softcap 30.
Pattern (local_attn, attn) x 13.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    block_pattern=("local_attn", "attn"),
    window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="geglu",
    tie_embeddings=True,
)
