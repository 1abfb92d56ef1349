"""Public chunked SSD, mirroring ``repro/kernels/ssd/ops.py``.

- :func:`ssd_mixer` has the reference wrapper's signature and ``(B, H, S,
  P)`` layout and returns ``y`` in ``x``'s dtype. Like the reference it
  takes the chunk as ``min(chunk, S)``; it pads nothing, since K5 masks
  its own ragged last chunk.
- :func:`ssd_chunked` is the entry that the model calls (the counterpart
  of ``repro/models/ssd.py`` ``ssd_chunked``): the ``(B, S, H, P)``
  layout, an optional initial state, and ``(y, h_last)`` in float32. It
  hands K5 views (heads ahead of the sequence by strides, no copy).

Dispatch is by the tensors' device: a CUDA tensor launches K5
(:mod:`.kernel`) or raises, a CPU tensor takes the plain version
(:mod:`.ref`). Nothing falls back from one to the other.

Where a gradient is wanted :func:`ssd_chunked` goes through
:class:`SSDChunked`: its forward launches K5 (the plain version on the
CPU), and its backward recomputes the chunked form through the plain
version under ``torch.enable_grad()`` and differentiates it with
``torch.autograd.grad``, as the reference differentiates its jnp
``ssd_chunked``. A backward kernel for K5 is later work.
"""

from __future__ import annotations

import torch

from .kernel import ssd_chunked_cuda
from .ref import ssd_chunked_ref


def _ssd_chunked(x, dt, a_neg, bmat, cmat, chunk, h0):
    """The forward, by device."""
    if x.device.type == "cuda":
        f32 = torch.float32
        y, h_last = ssd_chunked_cuda(
            x.transpose(1, 2), dt.to(f32).transpose(1, 2),
            a_neg.to(f32).contiguous(), bmat, cmat, chunk=chunk,
            h0=None if h0 is None else h0.to(f32).contiguous())
        return y.transpose(1, 2), h_last
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, a_neg, bmat, cmat, chunk, h0)
    raise ValueError(f"ssd_chunked: unsupported device {x.device}")


def ssd_chunked_bwd(inputs, chunk, dy, dh_last):
    """The gradients of ``inputs`` (x, dt, a_neg, bmat, cmat, h0; h0 may
    be None, and gets None) through the plain chunked version, recomputed
    with autograd on."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in inputs]
        y, h_last = ssd_chunked_ref(*leaves[:5], chunk, leaves[5])
        wrt = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad((y, h_last), wrt, (dy, dh_last)))
    return tuple(None if t is None else next(grads) for t in leaves)


class SSDChunked(torch.autograd.Function):
    """K5 forward; the plain chunked version, differentiated, backward."""

    @staticmethod
    def forward(ctx, x, dt, a_neg, bmat, cmat, h0, chunk):
        ctx.save_for_backward(x, dt, a_neg, bmat, cmat, h0)
        ctx.chunk = chunk
        return _ssd_chunked(x, dt, a_neg, bmat, cmat, chunk, h0)

    @staticmethod
    def backward(ctx, dy, dh_last):
        grads = ssd_chunked_bwd(ctx.saved_tensors, ctx.chunk, dy, dh_last)
        return (*grads, None)


def ssd_chunked(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H)
    a_neg: torch.Tensor,    # (H,)
    bmat: torch.Tensor,     # (B, S, N)
    cmat: torch.Tensor,     # (B, S, N)
    chunk: int,
    h0: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y (B, S, H, P), h_last (B, H, P, N))``, float32."""
    inputs = (x, dt, a_neg, bmat, cmat, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return SSDChunked.apply(*inputs, chunk)
    return _ssd_chunked(x, dt, a_neg, bmat, cmat, chunk, h0)


def ssd_mixer(
    x: torch.Tensor,        # (B, H, S, P)
    dt: torch.Tensor,       # (B, H, S)
    a_neg: torch.Tensor,    # (H,)
    bmat: torch.Tensor,     # (B, S, N)
    cmat: torch.Tensor,     # (B, S, N)
    *,
    chunk: int = 64,
) -> torch.Tensor:
    """y ``(B, H, S, P)`` in ``x``'s dtype."""
    y, _ = ssd_chunked(x.transpose(1, 2), dt.transpose(1, 2), a_neg, bmat,
                       cmat, min(chunk, x.shape[2]))
    return y.transpose(1, 2).to(x.dtype)
