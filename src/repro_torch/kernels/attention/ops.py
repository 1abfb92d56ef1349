"""Public flash attention, mirroring ``repro/kernels/attention/ops.py``,
with a gradient.

:func:`flash_attention` takes the model's ``(B, S, H, D)`` layout and
returns the same. On the card it copies nothing: K4 reads the tensors
through their strides (heads ahead of the sequence only by index) and
writes its output in the same layout, and unlike the Pallas kernel it
masks its own ragged tile, so the reference wrapper's padding to block
multiples and ``sq_valid``/``skv_valid`` have no work here. Dispatch is by
the tensors' device: a CUDA tensor launches K4 (:mod:`.kernel`) or raises,
a CPU tensor takes the plain version (:mod:`.ref`). Nothing falls back
from one to the other.

Where a gradient is wanted (grad mode on and q, k or v requiring one), the
call goes through :class:`FlashAttention`, a ``torch.autograd.Function``:
its forward also keeps each row's log-sum-exp, and its backward is K4b
(``flash_attention_bwd_cuda``) on the card and ``attention_bwd_ref`` on the
CPU, as the reference differentiates its attention through the
hand-written VJP ``_flash_core_bwd``. Serving's calls, under ``no_grad``,
take the forward alone and ask for no log-sum-exp. The backward reads the
saved tensors where they lie, in the layout the forward read them in.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import attention_bhsd_ref, attention_bwd_ref


def _forward(q, k, v, kw, return_lse=False):
    """The forward in ``(B, H, S, D)``, by device; ``(out, lse)`` with
    ``return_lse``."""
    if return_lse:
        kw = dict(kw, return_lse=True)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return attention_bhsd_ref(*(t.contiguous() for t in (q, k, v)), **kw)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def attention_bwd(q, k, v, out, dout, lse, **kw):
    """The backward in ``(B, H, S, D)``, by device: K4b on the card, the
    plain version on the CPU."""
    if q.device.type == "cuda":
        return flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, dout, lse, **kw)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class FlashAttention(torch.autograd.Function):
    """K4 forward, K4b backward, on ``(B, H, S, D)`` views."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse = _forward(q, k, v, kw, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, dout, lse, **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,              # (B, Sq, Hq, D)
    k: torch.Tensor,              # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FlashAttention.apply(q, k, v, causal, window, softcap)
    else:
        out = _forward(q, k, v, dict(causal=causal, window=window,
                                     softcap=softcap))
    return out.transpose(1, 2)
