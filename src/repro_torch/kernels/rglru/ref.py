"""Plain PyTorch version of the RG-LRU scan (K6).

It runs on any device. The CPU tests hold it against the JAX package's
``repro/kernels/rglru/ref.py`` (an associative scan) and Pallas kernel,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.

It is the Pallas kernel's ``fori_loop`` written out: a sequential float32
loop ``h_t = a_t · h_{t-1} + b_t`` from ``h0``, each step a product and
then a sum, two separately rounded tensor operations. The CUDA kernel
pins the same rounding, so on the card the two agree bit for bit. One
step is a few tensor operations, so it is unambiguous rather than fast.
"""

from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor | None = None) -> torch.Tensor:
    """``(B, S, W)`` decays and increments, ``(B, W)`` initial state (None:
    zeros) -> the ``(B, S, W)`` trajectory in ``a``'s dtype, computed in
    float32."""
    af, bf = a.to(torch.float32), b.to(torch.float32)
    bsz, s, w = af.shape
    h = (torch.zeros((bsz, w), dtype=torch.float32, device=a.device)
         if h0 is None else h0.to(torch.float32))
    out = torch.empty_like(af)
    for t in range(s):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)
