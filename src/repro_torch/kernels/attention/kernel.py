"""CUDA flash attention for Hopper, the forward (K4) and its backward
(K4b): build, binding and launch wrappers.

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
launched (``"tensor_core"`` or ``"simt"``). With ``return_lse`` it also
returns each query row's log-sum-exp, which the backward reads, from a
kernel instance of its own; serving asks for none and runs the instance
that writes none, unchanged by the backward's arrival.

:func:`flash_attention_bwd_cuda` (K4b) is the backward, the counterpart of
the reference's hand-written VJP ``_flash_core_bwd``
(``repro/models/attention.py:181-215``; the JAX package has no backward
kernel): ``dq, dk, dv`` from q, k, v, the forward's output and ``lse``,
and the output's gradient, with every key valid. Three launches a call
(``delta = rowsum(dO * O)``, then dK/dV, then dQ), no atomics: two calls
give the same bits. bfloat16 runs on the tensor cores (``mma.sync``; P
and dS split into two bf16 terms for the three gradient products, as
``ref.attention_bwd_rounded_ref`` states), float32 on the SIMT kernels
(float32 tiles and arithmetic), which hold the reference's 1e-5. It reads
every operand through its strides, as the forward does; its ``launches``
counts calls, one a call, and ``route_launches`` counts them by ``(dtype,
route)`` as the C entry reports the route it launched.
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
from .ref import NEG_INF

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
_BWD_STRIDES = ctypes.c_longlong * 24


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE, NVCC_FLAGS)
    lib.attn_fwd_launch.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _STRIDES, _I, _I,
        _I, _F, _F, _P, ctypes.POINTER(_I),
    ]
    lib.attn_fwd_launch.restype = _I
    lib.attn_bwd_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _I, _BWD_STRIDES, _I, _I, _F, _F, _P, ctypes.POINTER(_I),
    ]
    lib.attn_bwd_launch.restype = _I
    lib.attn_bwd_shared_memory.argtypes = [_I, ctypes.POINTER(_I),
                                           ctypes.POINTER(_I)]
    lib.attn_bwd_shared_memory.restype = _I
    lib.attn_error_string.argtypes = [_I]
    lib.attn_error_string.restype = ctypes.c_char_p
    return lib


def bwd_shared_memory(d: int) -> dict[str, int]:
    """The dynamic shared memory in bytes a CTA of K4b's tensor-core dK/dV
    and dQ kernels takes at head dim ``d``, as the built library reports
    it. Builds the library on first use."""
    dkdv, dq = _I(), _I()
    if _lib().attn_bwd_shared_memory(d, ctypes.byref(dkdv), ctypes.byref(dq)):
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    return {"dkdv": dkdv.value, "dq": dq.value}


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
    return_lse: bool = False,
):
    """``softmax(q kᵀ / sqrt(d)) v`` on the card, ``(B, Hq, Sq, D)`` in
    q's dtype and layout, and with ``return_lse`` its ``(B, Hq, Sq)``
    float32 log-sum-exp beside it; the same contract as
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
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0 or skv == 0:
        # no key: the reference's m and l stay at their starts
        out.zero_()
        return (out, lse.fill_(NEG_INF)) if return_lse else out
    layout = _STRIDES(*strides(q), *strides(k), *strides(v), *strides(out))
    route = _I(-1)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.attn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
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
    return (out, lse) if return_lse else out


def _usable(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels can read it through its strides, else a
    contiguous copy (a gradient handed in by autograd may come in any
    layout)."""
    try:
        strides(t)
    except ValueError:
        return t.contiguous()
    return t


def _backward(entry, q, k, v, out, dout, lse, causal, window, softcap):
    """``(dq, dk, dv)`` and the route that the C entry ``entry`` reports
    it launched."""
    _check(q, k, v)
    dout = _usable(dout)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(b, hq, sq)} "
                         f"tensor on {q.device} (got {tuple(lse.shape)} "
                         f"{lse.dtype})")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    if q.numel() == 0 or skv == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    require_hopper(q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    layout = _BWD_STRIDES(*(x for t in (q, k, v, out, dout, dq, dk, dv)
                            for x in strides(t)))
    route = _I(-1)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype], b, hq, hkv, sq,
            skv, d, layout, int(causal), int(window), float(softcap),
            1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
            ctypes.byref(route),
        )
    if err != 0:
        msg = lib.attn_error_string(err).decode()
        raise RuntimeError(f"attention backward kernel failed: CUDA error "
                           f"{err} ({msg})")
    return (dq, dk, dv), ROUTES[route.value]


def flash_attention_bwd_cuda(
    q: torch.Tensor,              # (B, Hq, Sq, D)
    k: torch.Tensor,              # (B, Hkv, Skv, D)
    v: torch.Tensor,
    out: torch.Tensor,            # (B, Hq, Sq, D), the forward's output
    dout: torch.Tensor,           # (B, Hq, Sq, D), its gradient
    lse: torch.Tensor,            # (B, Hq, Sq) float32, the forward's
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` on the card, each in the layout and dtype of q, k
    and v; the contract of
    :func:`~repro_torch.kernels.attention.ref.attention_bwd_ref`. q, k, v
    and out are read where they lie (they come from the forward); dout is
    copied once if its layout is not one the kernels read."""
    grads, route = _backward("attn_bwd_launch", q, k, v, out, dout, lse,
                             causal, window, softcap)
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.route_launches[
        (str(q.dtype).removeprefix("torch."), route)] += 1
    return grads


flash_attention_cuda.launches = 0
flash_attention_cuda.route_launches = collections.Counter()
flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.route_launches = collections.Counter()
