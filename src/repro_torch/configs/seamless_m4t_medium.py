"""SeamlessM4T-medium backbone — encoder-decoder, multimodal frontend stub.

[arXiv:2308.11596; hf-verified]
12 encoder + 12 decoder layers, d_model 1024, 16 heads (MHA kv=16),
d_ff 4096 (GELU), vocab 256206. The speech/text frontend is a STUB:
`input_specs()` supplies precomputed frame embeddings (B, S_enc, D);
the decoder cross-attends to the encoded memory.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    act="gelu",
    tie_embeddings=True,
    frontend="audio_embeds",
)
