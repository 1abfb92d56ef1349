from .kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda,
)
from .ops import FlashAttention, flash_attention
from .ref import (
    attention_bhsd_ref, attention_bwd_ref, attention_bwd_rounded_ref,
    attention_ref,
)

__all__ = [
    "FlashAttention",
    "attention_bhsd_ref",
    "attention_bwd_ref",
    "attention_bwd_rounded_ref",
    "attention_ref",
    "flash_attention",
    "flash_attention_bwd_cuda",
    "flash_attention_cuda",
]
