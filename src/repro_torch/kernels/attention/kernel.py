"""CUDA flash-attention forward (K4) for Hopper: build, binding and launch
wrapper.

The kernels live in ``csrc/attention_kernels.cu`` behind a plain C
interface, built and loaded at first use by :mod:`repro_torch.kernels.nvcc`
(``sm_90a``, ``ctypes``). Nothing is compiled or loaded when this module is
imported. bfloat16 runs on the tensor cores (``mma.sync``, probabilities
split into two bf16 halves so that P·V keeps float32 precision), float32
on the SIMT kernel, which holds the reference's 2e-5.

:func:`flash_attention_cuda` replaces ``repro/kernels/attention/kernel.py``
``_attn_kernel`` / ``flash_attention_bhsd`` and has its contract, indexed
``(B, H, S, D)``: q ``(B, Hq, Sq, D)``, k and v ``(B, Hkv, Skv, D)``,
float32 or bfloat16, ``D`` in 16/32/64/128/256, ``Hq`` a multiple of
``Hkv``; keys at or past ``skv_valid`` are masked. Unlike the Pallas kernel
it needs no block multiples: the kernel masks its own ragged tile. It
takes CUDA tensors of any strides whose last dimension is contiguous and
whose rows start on 16-byte boundaries, so a transposed view of the
model's ``(B, S, H, D)`` tensors is read where it lies; the output is
allocated with ``torch.empty_like(q)``, in q's layout. It launches on
torch's current stream and raises when the C call returns a CUDA error (a
refused launch never runs, and a later synchronisation would not say so).
Its plain-integer ``launches`` counter goes up by one where it launches a
kernel, and nowhere else; ``route_launches`` counts the same launches by
``(dtype, route)``, the route being the kernel that the C entry reports it
launched (``"tensor_core"`` or ``"simt"``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from pathlib import Path

import torch

from ...compat import require_hopper
from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "attention_kernels.cu"
NVCC_FLAGS = nvcc.BASE_FLAGS

#: dtype codes of the C interface (``enum Dtype`` in the source)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: route codes of the C interface (``enum Route`` in the source)
ROUTES = {0: "simt", 1: "tensor_core"}
HEAD_DIMS = (16, 32, 64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.c_longlong * 12


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE, NVCC_FLAGS)
    lib.attn_fwd_launch.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _STRIDES, _I, _I, _I,
        _F, _F, _P, ctypes.POINTER(_I),
    ]
    lib.attn_fwd_launch.restype = _I
    lib.attn_error_string.argtypes = [_I]
    lib.attn_error_string.restype = ctypes.c_char_p
    return lib


def strides(t: torch.Tensor) -> tuple[int, int, int]:
    """The element strides of a 4-d tensor's first three dimensions, as the
    kernels take them; raises unless its last dimension is contiguous and
    every row starts on a 16-byte boundary."""
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"a (B, H, S, D) tensor whose last dimension is "
                         f"contiguous is needed (got shape {tuple(t.shape)}, "
                         f"strides {t.stride()})")
    if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                for st in t.stride()[:3]):
        raise ValueError(f"every row must start on a 16-byte boundary "
                         f"(strides {t.stride()}, {t.element_size()} bytes "
                         f"an element)")
    return t.stride(0), t.stride(1), t.stride(2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda takes CUDA tensors "
                             f"({name} is on {t.device})")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, S, D) (got shape "
                             f"{tuple(t.shape)})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16 (got "
                        f"{q.dtype}, {k.dtype}, {v.dtype})")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if hq % k.shape[1]:
        raise ValueError(f"{hq} query heads over {k.shape[1]} kv heads")


def flash_attention_cuda(
    q: torch.Tensor,              # (B, Hq, Sq, D)
    k: torch.Tensor,              # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    skv_valid: int | None = None,
) -> torch.Tensor:
    """``softmax(q kᵀ / sqrt(d)) v`` on the card, ``(B, Hq, Sq, D)`` in
    q's dtype and layout; the same contract as
    :func:`~repro_torch.kernels.attention.ref.attention_bhsd_ref`."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    skv_valid = skv if skv_valid is None else int(skv_valid)
    if not 0 <= skv_valid <= skv:
        raise ValueError(f"skv_valid {skv_valid} outside [0, {skv}]")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    require_hopper(q.device)
    out = torch.empty_like(q)  # q's layout where q is dense
    if out.numel() == 0 or skv == 0:
        return out.zero_()
    layout = _STRIDES(*strides(q), *strides(k), *strides(v), *strides(out))
    route = _I(-1)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.attn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], b, hq, hkv, sq, skv, d, layout, skv_valid,
            int(causal), int(window), float(softcap), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
            ctypes.byref(route),
        )
    if err != 0:
        msg = lib.attn_error_string(err).decode()
        raise RuntimeError(f"attention kernel failed: CUDA error {err} ({msg})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.route_launches[
        (str(q.dtype).removeprefix("torch."), ROUTES[route.value])] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.route_launches = collections.Counter()
