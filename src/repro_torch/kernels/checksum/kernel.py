"""CUDA device checksum for Hopper: build, binding and launch wrapper.

The kernel lives in ``csrc/checksum_kernels.cu`` behind a plain C
interface, built and loaded at first use by :mod:`repro_torch.kernels.nvcc`
(``sm_90a``, ``ctypes``). Nothing is compiled or loaded when this module
is imported.

:func:`checksum_cuda` replaces ``repro/kernels/checksum/kernel.py``
``_checksum_kernel`` / ``checksum_u32`` together with the word cast of
``ops.py`` ``device_checksum``: it reads the tensor in its own dtype and
widens each element on the card, so no uint32 copy of the input is made.
It takes a contiguous CUDA tensor, allocates the ``(2,)`` int64 output with
torch, launches on torch's current stream, and raises when the C call
returns a CUDA error. Its plain-integer ``launches`` counter goes up by
one where it launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ...compat import require_hopper
from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "checksum_kernels.cu"
NVCC_FLAGS = nvcc.BASE_FLAGS

#: How the kernel reads each dtype (``enum Kind`` in the source).
KINDS = {
    torch.bool: 0, torch.uint8: 0, torch.int8: 1,
    torch.uint16: 2, torch.int16: 3,
    torch.int32: 4, torch.uint32: 4, torch.float32: 4,
    torch.int64: 5, torch.uint64: 5,
    torch.float16: 6, torch.bfloat16: 7, torch.float64: 8,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE, NVCC_FLAGS)
    lib.checksum_launch.argtypes = [_P, _I, _I64, _I64, _I64, _P, _P]
    lib.checksum_launch.restype = _I
    lib.checksum_error_string.argtypes = [_I]
    lib.checksum_error_string.restype = ctypes.c_char_p
    return lib


def checksum_cuda(x: torch.Tensor, block: int) -> torch.Tensor:
    """``(2,)`` int64 ``(S1, S2)`` of the flat contiguous CUDA tensor ``x``
    in blocks of exactly ``block`` words; the same contract as
    :func:`~repro_torch.kernels.checksum.ref.checksum_ref`."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"checksum_cuda takes a CUDA tensor (got {dev})")
    if x.dtype not in KINDS:
        raise TypeError(f"no checksum for dtype {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("checksum_cuda takes a flat contiguous tensor")
    n = x.numel()
    if n == 0:
        raise ValueError("checksum of an empty input")
    if block < 1:
        raise ValueError(f"block must be positive (got {block})")
    require_hopper(dev)
    out = torch.empty(2, dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):  # the C call sizes its grid for this card
        err = lib.checksum_launch(
            x.data_ptr(), KINDS[x.dtype], n, block, -(-n // block),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    checksum_cuda.launches += 1
    if err != 0:
        msg = lib.checksum_error_string(err).decode()
        raise RuntimeError(f"checksum kernel failed: CUDA error {err} ({msg})")
    return out


checksum_cuda.launches = 0
