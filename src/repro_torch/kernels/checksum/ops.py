"""Dispatch for the device checksum, mirroring ``repro/kernels/checksum/
ops.py``.

:func:`device_checksum` takes a tensor where it lies: a CUDA tensor
launches the CUDA kernel (:mod:`.kernel`) or raises, a CPU tensor takes the
plain PyTorch version (:mod:`.ref`). Nothing falls back from one to the
other. A numpy array or ``bytes`` is first copied to ``device`` (``None``
= the CUDA card, raising without it; ``"cpu"`` for the plain version).

The value is the JAX package's ``device_checksum`` exactly: each element is
one uint32 word (a ``uint8`` bundle of ``L`` bytes is ``L`` words), in
blocks of ``min(block, max(n, 8))`` words. It is returned as a ``(2,)``
int64 tensor on the input's device (the reference returns uint32; both
values are below 65521).
"""

from __future__ import annotations

import numpy as np
import torch

from ...compat import host_tensor, resolve_device
from .kernel import checksum_cuda
from .ref import checksum_ref


def device_checksum(x, *, block: int = 2048, device=None) -> torch.Tensor:
    """Order-sensitive Fletcher-style checksum of any array's elements,
    each widened to one uint32 word. Returns ``(2,)`` int64."""
    if isinstance(x, torch.Tensor):
        if device is not None and torch.device(device).type != x.device.type:
            raise ValueError(
                f"x lies on {x.device}; it is checksummed where it lies "
                f"(got device={device!r})"
            )
    else:
        dev = resolve_device(device)
        if not isinstance(x, (bytes, bytearray, memoryview)):
            x = np.asarray(x)
        x = host_tensor(x).to(dev)
    flat = x.reshape(-1)
    n = flat.numel()
    if n == 0:
        raise ValueError("checksum of an empty input")
    if block < 1:
        raise ValueError(f"block must be positive (got {block})")
    b = min(block, max(n, 8))
    if flat.device.type == "cuda":
        return checksum_cuda(flat, b)
    if flat.device.type != "cpu":
        raise ValueError(f"device_checksum: unsupported device {flat.device}")
    return checksum_ref(flat, b)


def verify_replicas(checksums) -> bool:
    """All hosts' checksums equal => the replication fabric delivered
    identical bytes everywhere (cheap cross-host agreement check)."""
    arr = np.stack([
        c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
        for c in checksums
    ])
    return bool((arr == arr[0]).all())
