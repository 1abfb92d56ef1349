"""CUDA RG-LRU scan (K6) for Hopper: build, binding and launch wrapper.

The kernel lives in ``csrc/rglru_kernels.cu`` behind a plain C interface,
built and loaded at first use by :mod:`repro_torch.kernels.nvcc`
(``sm_90a``, ``ctypes``). Nothing is compiled or loaded when this module is
imported.

:func:`rglru_scan_cuda` replaces ``repro/kernels/rglru/kernel.py``
``_rglru_kernel`` / ``rglru_scan_bsw`` and has its contract: ``h_t = a_t ·
h_{t-1} + b_t`` from ``h0`` over float32 ``(B, S, W)``, the whole
trajectory out. The bound is bytes (12 an element), and the design keeps
enough of them in flight to reach it: one warp a CTA owns one batch row
and 32 channels and streams tiles of 32 steps of ``a`` and ``b`` through
an 8-stage ``cp.async`` ring in shared memory (64 KB), so that 7 tiles,
56 KB, are in flight while one is walked; :func:`ring_config` reads those
constants from the built library, where the C entry sets the grid from
them. Each step is the same rounded product and then rounded
sum in time order, so the kernel equals the sequential plain version bit
for bit. Unlike the Pallas kernel it needs no time-block or lane
multiples: the kernel masks the ragged time and channel edges.

It takes contiguous float32 CUDA tensors, allocates the output with
torch, launches on torch's current stream, and raises when the C call
returns a CUDA error (the C entry refuses a batch outside 1-65,535 or an
empty ``s`` or ``w``). Its plain-integer ``launches`` counter goes up by
one where the kernel was launched, and nowhere else; the gradient's
launches (``ops.RGLRUScan``) count there too.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ...compat import require_hopper
from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_kernels.cu"
NVCC_FLAGS = nvcc.BASE_FLAGS

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE, NVCC_FLAGS)
    lib.rglru_scan_launch.argtypes = [_P, _P, _P, _P, _I64, _I64, _I64, _P]
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_config.argtypes = [_P]
    lib.rglru_scan_config.restype = None
    lib.rglru_error_string.argtypes = [ctypes.c_int]
    lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def ring_config() -> dict[str, int]:
    """The ring kernel's constants as the built library reports them:
    ``lanes`` (channels a CTA, one warp), ``steps`` (time steps a tile),
    ``stages`` (tiles in the ring) and ``ring_bytes`` (its dynamic shared
    memory). Builds the library on first use."""
    got = (ctypes.c_int64 * 4)()
    _lib().rglru_scan_config(ctypes.addressof(got))
    return dict(zip(("lanes", "steps", "stages", "ring_bytes"), got))


def _require(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"rglru_scan_cuda takes CUDA tensors ({name} is on "
                         f"{t.device})")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, a on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor of shape "
                         f"{shape} (got {tuple(t.shape)})")


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor | None = None) -> torch.Tensor:
    """``(B, S, W)`` float32 decays ``a`` and increments ``b``, ``(B, W)``
    float32 ``h0`` (None: zeros) -> the ``(B, S, W)`` float32 trajectory,
    equal bit for bit to
    :func:`~repro_torch.kernels.rglru.ref.rglru_scan_ref` on the card."""
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, W) (got {tuple(a.shape)})")
    bsz, s, w = a.shape
    _require(a, "a", (bsz, s, w), a.device)
    _require(b, "b", (bsz, s, w), a.device)
    if h0 is not None:
        _require(h0, "h0", (bsz, w), a.device)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    require_hopper(a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            out.data_ptr(), bsz, s, w,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        msg = lib.rglru_error_string(err).decode()
        raise RuntimeError(f"rglru scan kernel failed: CUDA error {err} "
                           f"({msg})")
    rglru_scan_cuda.launches += 1
    return out


rglru_scan_cuda.launches = 0
