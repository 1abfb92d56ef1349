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
"""

from __future__ import annotations

import torch

from .kernel import ssd_chunked_cuda
from .ref import ssd_chunked_ref


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
