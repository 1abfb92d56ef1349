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

K5 is the ``torch.library`` op ``repro_torch::ssd_chunked``: dispatch by
device as above, a fake implementation, a FLOP formula
(:func:`ssd_flops`), a byte count and a DTensor sharding rule (batch or
heads shard; :mod:`repro_torch.kernels.costs`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import costs
from .kernel import ssd_chunked_cuda
from .ref import ssd_chunked_ref

Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::ssd_chunked", mutates_args=())
def ssd_chunked_op(x: Tensor, dt: Tensor, a_neg: Tensor, bmat: Tensor,
                   cmat: Tensor, chunk: int, h0: Optional[Tensor]
                   ) -> tuple[Tensor, Tensor]:
    """K5 in the model's layout: ``(y (B, S, H, P), h_last (B, H, P,
    N))``, float32."""
    if x.device.type == "cuda":
        f32 = torch.float32
        y, h_last = ssd_chunked_cuda(
            x.transpose(1, 2), dt.to(f32).transpose(1, 2),
            a_neg.to(f32).contiguous(), bmat, cmat, chunk=chunk,
            h0=None if h0 is None else h0.to(f32).contiguous())
        y = y.transpose(1, 2)
    elif x.device.type == "cpu":
        y, h_last = ssd_chunked_ref(x, dt, a_neg, bmat, cmat, chunk, h0)
    else:
        raise ValueError(f"ssd_chunked: unsupported device {x.device}")
    # contiguous, as the kernel writes them (and the fake says)
    return y.contiguous(), h_last.contiguous()


@ssd_chunked_op.register_fake
def _(x, dt, a_neg, bmat, cmat, chunk, h0):
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p), dtype=torch.float32),
            x.new_empty((b, h, p, bmat.shape[-1]), dtype=torch.float32))


def ssd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk, h0_shape,
              *args, **kwargs) -> int:
    """K5's products on the live rows of each chunk of ``q`` rows, for
    each (batch, head): ``C Bᵀ`` on the causal triangle, ``q (q + 1) N``
    (``q (q + 1) / 2`` pairs, 2 operations a multiply-add); the masked
    scores times ``x dt``, ``q (q + 1) P``; ``C h_prevᵀ`` and the state
    update ``(x dt w)ᵀ B``, ``2 q P N`` each. The elementwise decays are
    not counted (as ``chip_smoke.py`` bounds the kernel)."""
    b, s, h, p = x_shape
    n = b_shape[-1]
    total = 0
    for t in range(0, s, chunk):
        q = min(chunk, s - t)
        total += q * (q + 1) * (n + p) + 4 * q * p * n
    return b * h * total


def _ssd_rule(x, dt, a_neg, bmat, cmat, chunk, h0):
    """Replicated, or sharded on batch, or on heads (x and dt dim 2, the
    decay rates dim 0, the state dim 1; B and C, shared by the heads,
    replicate); the sequence, head dim and state stay whole."""
    none = h0 is None
    return [
        (costs.placements("R", "R"),
         costs.placements("R", "R", "R", "R", "R", None,
                          None if none else "R")),
        (costs.placements(0, 0),
         costs.placements(0, 0, "R", 0, 0, None, None if none else 0)),
        (costs.placements(2, 1),
         costs.placements(2, 2, 0, "R", "R", None, None if none else 1)),
    ]


costs.register(torch.ops.repro_torch.ssd_chunked, flops=ssd_flops,
               rule=_ssd_rule)


def _ssd_chunked(x, dt, a_neg, bmat, cmat, chunk, h0):
    """The forward through K5's op."""
    return torch.ops.repro_torch.ssd_chunked(x, dt, a_neg, bmat, cmat,
                                             chunk, h0)


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
        inputs = ctx.saved_tensors
        if isinstance(inputs[0], DTensor):
            return (*_sharded_bwd(inputs, ctx.chunk, dy, dh_last), None)
        grads = ssd_chunked_bwd(inputs, ctx.chunk, dy, dh_last)
        return (*grads, None)


def _sharded_bwd(inputs, chunk, dy, dh_last):
    """:func:`ssd_chunked_bwd` on each rank's shard of DTensor inputs,
    laid out by K5's sharding rule as x decides it (each mesh dim that
    splits x's batch or heads splits the others alike; any other split
    of x is gathered): the recomputation is local, a split input's
    gradient is its shard's, and an input that is whole where the op is
    split (the decay rates under a batch split, B and C under a heads
    split) gets a ``Partial`` gradient, each rank's share."""
    x = inputs[0]
    mesh = x.device_mesh
    # per input (x, dt, a_neg, bmat, cmat, h0) and the outputs (y,
    # h_last): the dim each splits on, by the split of x
    by_split = {0: (0, 0, None, 0, 0, 0, 0, 0),
                2: (2, 2, 0, None, None, 1, 2, 1)}
    layouts = [by_split.get(p.dim) if isinstance(p, Shard) else None
               for p in x.placements]

    def placements(i):
        return [Replicate() if dims is None or dims[i] is None
                else Shard(dims[i]) for dims in layouts]

    def local(t, i):
        if not isinstance(t, DTensor):      # a plain (replicated) cotangent
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, placements(i)).to_local()

    grads = ssd_chunked_bwd(
        [None if t is None else local(t, i) for i, t in enumerate(inputs)],
        chunk, local(dy, 6), local(dh_last, 7))
    out = []
    for i, (t, g) in enumerate(zip(inputs, grads)):
        if t is None:
            out.append(None)
            continue
        pl = [Partial() if dims is not None and dims[i] is None else p
              for p, dims in zip(placements(i), layouts)]
        out.append(DTensor.from_local(g, mesh, pl, run_check=False,
                                      shape=t.shape, stride=t.stride())
                   .redistribute(mesh, t.placements))
    return out


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
