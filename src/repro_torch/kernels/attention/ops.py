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

K4 and K4b are ``torch.library`` ops: ``repro_torch::flash_attention``
(the output), ``repro_torch::flash_attention_lse`` (with the log-sum-exp)
and ``repro_torch::flash_attention_bwd``. Each dispatches by device as
above, has a fake implementation (shapes and dtypes only), a FLOP formula
(``4 d`` and ``10 d`` a live pair, :func:`live_pairs` counting only the
pairs the causal and window masks let through), a byte count and a
DTensor sharding rule: batch or heads may shard, the sequence and head
dims replicate (:mod:`repro_torch.kernels.costs`). So a DTensor call runs
the kernel on each rank's shard, and a fake-tensor call runs nothing.

``q_offset`` is the global index of query row 0, as the reference's
``flash_attention(..., q_offset=)`` has it for a chunked prefill: every
mask reads query row ``i`` as ``q_offset + i``, forward and backward. A
call that would leave a query row no live key (``window > 0`` and
``q_offset + Sq - Skv >= window``, or a negative offset) raises
``ValueError`` before any launch, on the CPU as on the card: the CUDA
wrappers, public entry points of their own, refuse it themselves, and the
CPU branch calls the same :func:`~.kernel.check_live_rows`, which states
the contract and why.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import costs
from .kernel import (
    check_live_rows, flash_attention_bwd_cuda, flash_attention_cuda,
)
from .ref import attention_bhsd_ref, attention_bwd_ref

Tensor = torch.Tensor


def live_pairs(sq: int, skv: int, causal: bool, window: int,
               q_offset: int = 0) -> int:
    """The (query, key) pairs that K4's masks let through, every key valid
    (query row ``r`` the global row ``q_offset + r``)."""
    i = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full_like(i, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _k4(q, k, v, causal, window, softcap, q_offset, return_lse):
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    if return_lse:
        kw["return_lse"] = True
    if q.device.type == "cuda":
        out = flash_attention_cuda(q, k, v, **kw)
    elif q.device.type == "cpu":
        check_live_rows(q.shape[2], k.shape[2], window, q_offset)
        out = attention_bhsd_ref(*(t.contiguous() for t in (q, k, v)), **kw)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    # in q's layout, as the kernel writes it (and the fake says)
    if return_lse:
        return _like(q, out[0]), out[1].contiguous()
    return _like(q, out)


def _like(t: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` in ``t``'s layout (``empty_like``): itself when its
    strides are already ``t``'s (the kernels' outputs), else a copy."""
    if value.stride() == t.stride():
        return value
    return torch.empty_like(t).copy_(value)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                       window: int, softcap: float, q_offset: int) -> Tensor:
    """K4 in ``(B, H, S, D)``: the output alone (serving's instance)."""
    return _k4(q, k, v, causal, window, softcap, q_offset, False)


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def flash_attention_lse_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                           window: int, softcap: float, q_offset: int
                           ) -> tuple[Tensor, Tensor]:
    """K4 in ``(B, H, S, D)`` with each query row's float32 log-sum-exp
    (training's instance)."""
    return _k4(q, k, v, causal, window, softcap, q_offset, True)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                           dout: Tensor, lse: Tensor, causal: bool,
                           window: int, softcap: float, q_offset: int
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """K4b in ``(B, H, S, D)``: ``(dq, dk, dv)``."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    if q.device.type == "cuda":
        grads = flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    elif q.device.type == "cpu":
        check_live_rows(q.shape[2], k.shape[2], window, q_offset)
        grads = attention_bwd_ref(q, k, v, out, dout, lse, **kw)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return tuple(_like(t, g) for t, g in zip((q, k, v), grads))


@flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap, q_offset):
    return torch.empty_like(q)


@flash_attention_lse_op.register_fake
def _(q, k, v, causal, window, softcap, q_offset):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:3], dtype=torch.float32))


@flash_attention_bwd_op.register_fake
def _(q, k, v, out, dout, lse, causal, window, softcap, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _pairs(q_shape, k_shape, causal, window, q_offset) -> int:
    b, hq, sq, _ = q_shape
    return b * hq * live_pairs(sq, k_shape[2], causal, window, q_offset)


def _fwd_flops(q_shape, k_shape, v_shape, causal, window, softcap, q_offset,
               *a, **kw) -> int:
    """``4 d`` a live pair: ``2 d`` for ``Q Kᵀ`` and ``2 d`` for ``P V``."""
    return 4 * q_shape[-1] * _pairs(q_shape, k_shape, causal, window,
                                    q_offset)


def _bwd_flops(q_shape, k_shape, v_shape, o_shape, do_shape, lse_shape,
               causal, window, softcap, q_offset, *a, **kw) -> int:
    """``10 d`` a live pair: ``Q Kᵀ`` recomputed, ``dO Vᵀ``, and the three
    gradient products ``Pᵀ dO``, ``dS K`` and ``dSᵀ Q``, ``2 d`` each."""
    return 10 * q_shape[-1] * _pairs(q_shape, k_shape, causal, window,
                                     q_offset)


def _rule(n_in: int, n_out: int):
    """Replicated, or every tensor sharded alike on batch (dim 0) or heads
    (dim 1); the sequence and head dims stay whole, as a kernel needs
    them (the four scalar arguments get no placement)."""
    def rule(*args):
        return [(costs.placements(*[d] * n_out),
                 costs.placements(*[d] * n_in, None, None, None, None))
                for d in ("R", 0, 1)]
    return rule


costs.register(torch.ops.repro_torch.flash_attention, flops=_fwd_flops,
               rule=_rule(3, 1))
costs.register(torch.ops.repro_torch.flash_attention_lse, flops=_fwd_flops,
               rule=_rule(3, 2))
costs.register(torch.ops.repro_torch.flash_attention_bwd, flops=_bwd_flops,
               rule=_rule(6, 3))


def _forward(q, k, v, kw, return_lse=False):
    """The forward in ``(B, H, S, D)`` through K4's op; ``(out, lse)``
    with ``return_lse``."""
    op = (torch.ops.repro_torch.flash_attention_lse if return_lse
          else torch.ops.repro_torch.flash_attention)
    return op(q, k, v, kw.get("causal", True), kw.get("window", 0),
              float(kw.get("softcap", 0.0)), int(kw.get("q_offset", 0)))


def attention_bwd(q, k, v, out, dout, lse, *, causal=True, window=0,
                  softcap=0.0, q_offset=0):
    """The backward in ``(B, H, S, D)`` through K4b's op."""
    return torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, dout, lse, causal, window, float(softcap),
        int(q_offset))


class FlashAttention(torch.autograd.Function):
    """K4 forward, K4b backward, on ``(B, H, S, D)`` views."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset)
        out, lse = _forward(q, k, v, kw, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, dout, lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,              # (B, Sq, Hq, D)
    k: torch.Tensor,              # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FlashAttention.apply(q, k, v, causal, window, softcap, q_offset)
    else:
        out = _forward(q, k, v, dict(causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset))
    return out.transpose(1, 2)
