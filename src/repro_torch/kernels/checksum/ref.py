"""Plain PyTorch version of the device checksum.

It runs on any device. The CPU tests hold it against the JAX package, and
``chip_smoke.py`` holds the CUDA kernel against it on the card, at sizes up
to the 8 GiB checkpoint bundle.

:func:`to_words` is the reference's word cast (``repro/kernels/checksum/
ops.py`` ``device_checksum``): each element becomes one uint32 word, held
here as an int64 below ``2**32`` (torch's uint32 arithmetic is thin).
:func:`checksum_ref` is the reference's fold (``repro/kernels/checksum/
kernel.py`` ``_checksum_kernel``, ``ref.py`` ``checksum_ref``): per block of
``b`` words, ``s1`` and ``s2`` summed as uint32 (wrapping) and reduced mod
65521, folded as ``S2 += S1 * (b % M) + s2``. The fold is taken in closed
form over chunks of whole blocks, so the memory it needs is bounded by the
chunk, not the input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MOD = 65521
MASK32 = 0xFFFFFFFF

#: The dtypes the checksum reads (the CUDA kernel reads each natively).
DTYPES = (
    torch.bool, torch.uint8, torch.int8, torch.uint16, torch.int16,
    torch.int32, torch.uint32, torch.int64, torch.uint64,
    torch.float16, torch.bfloat16, torch.float32, torch.float64,
)


def to_words(x: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 word of each element, as int64: bool and
    unsigned integers zero-extend, signed integers sign-extend, 64-bit
    integers keep their low word, floats give the bits of their float32
    value (float64 is rounded to float32 first)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"no checksum for dtype {x.dtype}")
    if x.is_floating_point():
        x = x.to(torch.float32).view(torch.int32)
    elif x.dtype == torch.uint64:
        x = x.view(torch.int64)
    return x.to(torch.int64) & MASK32


def checksum_ref(
    x: torch.Tensor, block: int = 2048, chunk_blocks: int | None = None
) -> torch.Tensor:
    """``(2,)`` int64 ``(S1, S2)`` of the flat tensor ``x`` in blocks of
    exactly ``block`` words (the tail zero-padded), ``chunk_blocks`` blocks
    at a time (default: about 2**24 words)."""
    n = x.numel()
    if n == 0:
        raise ValueError("checksum of an empty input")
    b = int(block)
    nb = -(-n // b)
    step = chunk_blocks or max(1, (1 << 24) // b)
    # the in-block weights, (iota + 1) % M as the reference's uint32 iota
    w = torch.arange(1, b + 1, dtype=torch.int64, device=x.device) % MOD
    s1 = torch.zeros((), dtype=torch.int64, device=x.device)
    s2 = torch.zeros((), dtype=torch.int64, device=x.device)
    for j0 in range(0, nb, step):
        j1 = min(nb, j0 + step)
        r = to_words(x[j0 * b: j1 * b]) % MOD
        r = F.pad(r, (0, (j1 - j0) * b - r.numel())).view(j1 - j0, b)
        # uint32 sums wrap; every term is below M, so int64 holds them
        b1 = (r.sum(1) & MASK32) % MOD
        b2 = ((r * w % MOD).sum(1) & MASK32) % MOD
        tail = (nb - 1 - torch.arange(j0, j1, device=x.device)) % MOD
        s1 = (s1 + b1.sum()) % MOD
        s2 = (s2 + (b2 + (b % MOD) * tail % MOD * b1 % MOD).sum()) % MOD
    return torch.stack([s1, s2])
