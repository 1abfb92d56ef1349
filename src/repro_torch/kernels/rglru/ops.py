"""Public RG-LRU scan, mirroring ``repro/kernels/rglru/ops.py``.

:func:`rglru_scan` has the reference wrapper's signature and ``(B, S, W)``
layout: the recurrence is computed in float32 and the trajectory returned
in ``a``'s dtype. It pads nothing: the reference's time-block and lane
padding exist for the Pallas grid, and K6 masks its own ragged edge.
Dispatch is by the tensors' device: a CUDA tensor launches K6
(:mod:`.kernel`) or raises, a CPU tensor takes the plain version
(:mod:`.ref`). Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from .kernel import rglru_scan_cuda
from .ref import rglru_scan_ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """``h_t = a_t · h_{t-1} + b_t`` with ``h_{-1} = h0`` (None: zeros);
    ``a``, ``b`` ``(B, S, W)``, ``h0`` ``(B, W)``."""
    if a.device.type == "cuda":
        f32 = [t.to(torch.float32).contiguous() for t in (a, b)]
        h = None if h0 is None else h0.to(torch.float32).contiguous()
        return rglru_scan_cuda(*f32, h).to(a.dtype)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    raise ValueError(f"rglru_scan: unsupported device {a.device}")
