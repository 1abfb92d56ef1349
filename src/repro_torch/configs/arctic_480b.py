"""Snowflake Arctic 480B — 128-expert top-2 MoE with parallel dense residual.

[hf:Snowflake/snowflake-arctic-base; hf-verified]
35L, d_model 7168, 56 heads (GQA kv=8), expert d_ff 4864, vocab 32000.
Arctic's signature is the dense-MoE hybrid: a small dense FFN runs in
parallel with the routed experts every layer (`moe_dense_residual`).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    top_k=2,
    moe_dense_residual=True,
    moe_dense_d_ff=4864,
    act="swiglu",
    tie_embeddings=False,
    rope_theta=10_000.0,
)
