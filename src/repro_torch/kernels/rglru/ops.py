"""Public RG-LRU scan, mirroring ``repro/kernels/rglru/ops.py``, with a
gradient.

:func:`rglru_scan` has the reference wrapper's signature and ``(B, S, W)``
layout: the recurrence is computed in float32 and the trajectory returned
in ``a``'s dtype. It pads nothing: the reference's time-block and lane
padding exist for the Pallas grid, and K6 masks its own ragged edge.
Dispatch is by the tensors' device: a CUDA tensor launches K6
(:mod:`.kernel`) or raises, a CPU tensor takes the plain version
(:mod:`.ref`). Nothing falls back from one to the other.

Where a gradient is wanted the call goes through :class:`RGLRUScan`. The
backward of ``h_t = a_t h_{t-1} + b_t`` is the same recurrence run
backwards, ``dh_t = g_t + a_{t+1} dh_{t+1}``, so it launches K6 itself (the
plain version on the CPU) on the inputs flipped in time: ``a`` shifted by
one step (``a_{t+1}``, 0 past the end) and the trajectory's gradient ``g``,
both reversed with ``torch.flip``, the result reversed back. Then ``db_t
= dh_t``, ``da_t = dh_t h_{t-1}`` (``h_{-1} = h0``) and ``dh0 = a_0 dh_0``.
The reference differentiates an associative scan instead, which rounds in
another order.

K6 is the ``torch.library`` op ``repro_torch::rglru_scan`` (forward and
reversed alike): dispatch by device as above, a fake implementation, a
FLOP formula (one multiply-add a step and channel), a byte count and a
DTensor sharding rule (batch or channels shard;
:mod:`repro_torch.kernels.costs`).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import costs
from .kernel import rglru_scan_cuda
from .ref import rglru_scan_ref

Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def rglru_scan_op(a: Tensor, b: Tensor, h0: Optional[Tensor]) -> Tensor:
    """K6: the float32 trajectory of ``h_t = a_t h_{t-1} + b_t``."""
    if a.device.type == "cuda":
        f32 = [t.to(torch.float32).contiguous() for t in (a, b)]
        h = None if h0 is None else h0.to(torch.float32).contiguous()
        return rglru_scan_cuda(*f32, h)
    if a.device.type == "cpu":
        return rglru_scan_ref(a.to(torch.float32), b.to(torch.float32), h0)
    raise ValueError(f"rglru_scan: unsupported device {a.device}")


@rglru_scan_op.register_fake
def _(a, b, h0):
    return torch.empty(a.shape, dtype=torch.float32, device=a.device)


def rglru_flops(a_shape, b_shape, h0_shape, *args, **kwargs) -> int:
    """One multiply-add a (batch, step, channel): ``2 B S W``."""
    bsz, s, w = a_shape
    return 2 * bsz * s * w


def _rglru_rule(a, b, h0):
    """Replicated, or sharded on batch (dim 0) or channels (dim 2, the
    state's dim 1); the time axis stays whole."""
    none = h0 is None
    return [
        (costs.placements("R"),
         costs.placements("R", "R", None if none else "R")),
        (costs.placements(0), costs.placements(0, 0, None if none else 0)),
        (costs.placements(2), costs.placements(2, 2, None if none else 1)),
    ]


costs.register(torch.ops.repro_torch.rglru_scan, flops=rglru_flops,
               rule=_rglru_rule)


def _scan(a: torch.Tensor, b: torch.Tensor,
          h0: torch.Tensor | None) -> torch.Tensor:
    """The float32 trajectory through K6's op."""
    return torch.ops.repro_torch.rglru_scan(a, b, h0)


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor,
                   h0: torch.Tensor | None, g: torch.Tensor):
    """``(da, db, dh0)`` in float32 from the float32 decays ``a``, the
    trajectory ``h`` and its gradient ``g``; ``dh0`` is None without
    ``h0``. One scan (K6 on the card) over the reversed inputs."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    dh = torch.flip(_scan(torch.flip(a_next, (1,)),
                          torch.flip(g.to(torch.float32), (1,)), None), (1,))
    first = torch.zeros_like(h[:, :1]) if h0 is None else \
        h0.to(torch.float32)[:, None]
    h_prev = torch.cat([first, h[:, :-1]], dim=1)
    dh0 = None if h0 is None else a[:, 0] * dh[:, 0]
    return dh * h_prev, dh, dh0


class RGLRUScan(torch.autograd.Function):
    """K6 forward, K6 on the reversed inputs backward."""

    @staticmethod
    def forward(ctx, a, b, h0):
        af = a.to(torch.float32)
        h = _scan(af, b, h0)
        ctx.save_for_backward(af, h, h0)
        ctx.dtypes = (a.dtype, b.dtype)
        return h.to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        af, h, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_scan_bwd(af, h, h0, g)
        return (da.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]),
                None if dh0 is None else dh0.to(h0.dtype))


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """``h_t = a_t · h_{t-1} + b_t`` with ``h_{-1} = h0`` (None: zeros);
    ``a``, ``b`` ``(B, S, W)``, ``h0`` ``(B, W)``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return RGLRUScan.apply(a, b, h0)
    return _scan(a, b, h0).to(a.dtype)
