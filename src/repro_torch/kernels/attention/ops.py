"""Public flash-attention forward, mirroring ``repro/kernels/attention/
ops.py``.

:func:`flash_attention` takes the model's ``(B, S, H, D)`` layout and
returns the same. On the card it copies nothing: K4 reads the tensors
through their strides (heads ahead of the sequence only by index) and
writes its output in the same layout, and unlike the Pallas kernel it
masks its own ragged tile, so the reference wrapper's padding to block
multiples and ``sq_valid``/``skv_valid`` have no work here. Dispatch is by the tensors' device: a CUDA tensor launches K4
(:mod:`.kernel`) or raises, a CPU tensor takes the plain version
(:mod:`.ref`). Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import attention_bhsd_ref


def flash_attention(
    q: torch.Tensor,              # (B, Sq, Hq, D)
    k: torch.Tensor,              # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cuda":
        out = flash_attention_cuda(*(t.transpose(1, 2) for t in (q, k, v)),
                                   **kw)
    elif q.device.type == "cpu":
        out = attention_bhsd_ref(
            *(t.transpose(1, 2).contiguous() for t in (q, k, v)), **kw)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return out.transpose(1, 2)
