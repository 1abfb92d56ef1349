"""Qwen2-VL 7B backbone — M-RoPE (t/h/w sections), vision frontend stub.

[arXiv:2409.12191; hf-verified]
28L, d_model 3584, 28 heads (GQA kv=4, head_dim 128), d_ff 18944 (SwiGLU),
vocab 152064. M-RoPE splits the 64 rotary frequency slots into
(16, 24, 24) sections driven by temporal/height/width position streams;
`input_specs()` supplies the (3, B, S) positions (the dynamic-resolution
ViT frontend that produces patch tokens + their 3D positions is a STUB).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152_064,
    rope_mode="mrope",
    mrope_sections=(16, 24, 24),
    act="swiglu",
    tie_embeddings=False,
    frontend="vision_embeds",
)
