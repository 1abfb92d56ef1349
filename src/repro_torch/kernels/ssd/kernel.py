"""CUDA chunked SSD (K5) for Hopper: build, binding and launch wrapper.

The kernels live in ``csrc/ssd_kernels.cu`` behind a plain C interface,
built and loaded at first use by :mod:`repro_torch.kernels.nvcc`
(``sm_90a``, ``ctypes``). Nothing is compiled or loaded when this module is
imported. bfloat16 runs on the tensor cores (``mma.sync``, each float32
operand split into three bf16 terms so that the products keep float32
precision); float32 on the SIMT kernel. Either way one CTA a
(batch, head) walks the chunks.

:func:`ssd_chunked_cuda` replaces ``repro/kernels/ssd/kernel.py``
``_ssd_kernel`` / ``ssd_chunked_bhsp`` in its ``(B, H, S, P)`` layout and
adds what the model's ``ssd_chunked`` (``repro/models/ssd.py:50``) needs
from it: an optional initial state ``h0`` and the final state ``h_last``.
Unlike the Pallas kernel it needs no chunk multiple: it masks the ragged
last chunk itself. It reads its inputs through their strides (the model
hands it views of one projection), allocates the outputs with torch,
launches on torch's current stream, and raises when the C call returns a
CUDA error (a refused launch never runs, and a later synchronisation
would not say so). Its plain-integer ``launches`` counter goes up by one
a call that launches, and nowhere else; ``route_launches`` counts the
same launches by ``(dtype, route)``, the route being the one that the C
entry reports it launched (``"tensor_core"`` or ``"simt"``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import torch

from ...compat import require_hopper
from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_kernels.cu"
NVCC_FLAGS = nvcc.BASE_FLAGS

#: dtype codes of the C interface (``enum Dtype`` in the source)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: route codes of the C interface (``enum Route`` in the source)
ROUTES = {0: "simt", 1: "tensor_core"}
#: the kernel's compile-time extents: chunk, head dim, state dim
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE, NVCC_FLAGS)
    lib.ssd_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P,
        ctypes.POINTER(_I),
    ]
    lib.ssd_launch.restype = _I
    lib.ssd_error_string.argtypes = [_I]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def check_tensor_core_layout(x: torch.Tensor, bmat: torch.Tensor,
                             cmat: torch.Tensor) -> None:
    """Raise unless x ``(B, H, S, P)``, bmat and cmat ``(B, S, N)`` allow
    the tensor-core route's 16-byte copies: P and N multiples of 8, every
    stride a multiple of 8 elements, each tensor 16-byte aligned."""
    for name, t in (("x", x), ("bmat", bmat), ("cmat", cmat)):
        if t.shape[-1] % 8 or any(st % 8 for st in t.stride()[:-1]) or \
                t.data_ptr() % 16:
            raise ValueError(
                f"the bfloat16 route copies 16-byte rows: {name}'s last "
                f"dimension ({t.shape[-1]}) and strides {t.stride()[:-1]} "
                f"must be multiples of 8 and its data 16-byte aligned")


def _check(x, dt, a_neg, bmat, cmat, h0, chunk) -> None:
    named = (("x", x), ("dt", dt), ("a_neg", a_neg), ("bmat", bmat),
             ("cmat", cmat)) + ((("h0", h0),) if h0 is not None else ())
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"ssd_chunked_cuda takes CUDA tensors ({name} "
                             f"is on {t.device})")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, S, P) (got {tuple(x.shape)})")
    b, h, s, p = x.shape
    n = bmat.shape[-1]
    if x.dtype not in DTYPES or bmat.dtype != x.dtype or \
            cmat.dtype != x.dtype:
        raise TypeError(f"x, bmat, cmat must all be float32 or bfloat16 "
                        f"(got {x.dtype}, {bmat.dtype}, {cmat.dtype})")
    for name, t in (("dt", dt), ("a_neg", a_neg)) + (
            (("h0", h0),) if h0 is not None else ()):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (got {t.dtype})")
    if tuple(dt.shape) != (b, h, s) or tuple(a_neg.shape) != (h,) or \
            tuple(bmat.shape) != (b, s, n) or tuple(cmat.shape) != (b, s, n):
        raise ValueError(
            f"shapes do not match x {tuple(x.shape)}: dt {tuple(dt.shape)}, "
            f"a_neg {tuple(a_neg.shape)}, bmat {tuple(bmat.shape)}, cmat "
            f"{tuple(cmat.shape)}")
    if h0 is not None and (tuple(h0.shape) != (b, h, p, n)
                           or not h0.is_contiguous()):
        raise ValueError(f"h0 must be a contiguous {(b, h, p, n)} tensor "
                         f"(got {tuple(h0.shape)})")
    if x.stride(3) != 1 or bmat.stride(2) != 1 or cmat.stride(2) != 1 or \
            not a_neg.is_contiguous():
        raise ValueError("x's head dim and the state dim of bmat and cmat "
                         "must be contiguous, and a_neg contiguous")
    if min(b, h, s, p, n) < 1:
        raise ValueError(f"empty input: x {tuple(x.shape)}, state {n}")
    if not (1 <= chunk <= MAX_CHUNK and p <= MAX_HEAD_DIM and n <= MAX_STATE):
        raise ValueError(
            f"chunk {chunk}, head dim {p}, state {n}: the kernel takes chunk "
            f"in [1, {MAX_CHUNK}], head dim <= {MAX_HEAD_DIM}, state <= "
            f"{MAX_STATE}")
    if x.dtype == torch.bfloat16:
        check_tensor_core_layout(x, bmat, cmat)


def ssd_chunked_cuda(
    x: torch.Tensor,              # (B, H, S, P), the head dim contiguous
    dt: torch.Tensor,             # (B, H, S) float32
    a_neg: torch.Tensor,          # (H,) float32
    bmat: torch.Tensor,           # (B, S, N), the state dim contiguous
    cmat: torch.Tensor,           # (B, S, N)
    *,
    chunk: int,
    h0: torch.Tensor | None = None,   # (B, H, P, N) float32, contiguous
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD on the card: ``(y, h_last)``, y ``(B, H, S, P)``
    float32 (a view of a ``(B, S, H, P)`` tensor, the model's layout) and
    h_last ``(B, H, P, N)`` float32; the contract of
    :func:`~repro_torch.kernels.ssd.ref.ssd_chunked_ref` in this layout."""
    _check(x, dt, a_neg, bmat, cmat, h0, chunk)
    b, h, s, p = x.shape
    n = bmat.shape[-1]
    dev = x.device
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    h_last = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    require_hopper(dev)
    route = _I(-1)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.ssd_launch(
            x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), DTYPES[x.dtype], b, h, s, p, n,
            chunk, x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
            dt.stride(1), dt.stride(2), bmat.stride(0), bmat.stride(1),
            cmat.stride(0), cmat.stride(1),
            torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(route),
        )
    if err != 0:
        msg = lib.ssd_error_string(err).decode()
        raise RuntimeError(f"ssd kernel failed: CUDA error {err} ({msg})")
    ssd_chunked_cuda.launches += 1
    ssd_chunked_cuda.route_launches[
        (str(x.dtype).removeprefix("torch."), ROUTES[route.value])] += 1
    return y.transpose(1, 2), h_last


ssd_chunked_cuda.launches = 0
ssd_chunked_cuda.route_launches = collections.Counter()
