"""Databricks DBRX 132B — 16-expert top-4 fine-grained MoE.

[hf:databricks/dbrx-base; unverified-tier]
40L, d_model 6144, 48 heads (GQA kv=8), expert d_ff 10752, vocab 100352.
Fine-grained routing: top-4 of 16 gives 1820 expert combinations/token.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    top_k=4,
    act="swiglu",
    tie_embeddings=False,
    rope_theta=500_000.0,
)
