"""CUDA swarm kernels for Hopper: build, binding and launch wrappers.

The kernels live in ``csrc/swarm_kernels.cu`` behind a plain C interface.
At first use :func:`build` compiles that source with ``nvcc`` for
``sm_90a`` into ``build/repro_torch/`` at the root of the checkout (the
file name carries a hash of the source and flags, so an edit rebuilds),
and :func:`_lib` loads it with ``ctypes``. Nothing is compiled or loaded
when this module is imported.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate outputs and scratch with torch on the tensors'
device, launch on torch's current stream, and raise when the C call
returns a CUDA error. Each has a plain-integer ``launches`` counter that
goes up by one where it launches its kernel, and nowhere else.

- :func:`rarest_argmin_cuda` replaces ``repro/kernels/swarm/kernel.py``
  ``_rarest_argmin_kernel`` / ``rarest_argmin_call``.
- :func:`waterfill_cuda` replaces ``repro/kernels/swarm/kernel.py``
  ``_waterfill_kernel`` / ``waterfill_call``; one launch is the whole
  fixed point (a host loop of per-round grid launches inside the C call).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from ...compat import require_hopper
from ...core.piece_selection import MAX_EXACT_AVAILABILITY

SOURCE = Path(__file__).resolve().parent / "csrc" / "swarm_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
#: -fmad=false keeps every multiply and add separately rounded (the
#: water-fill is bit-exact with its plain version); no --use_fast_math,
#: so division stays IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH): "
            "the swarm kernels are built from source at first use"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile the kernels if this source and these flags have no library
    yet; return the library's path."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"libswarm_kernels_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.rarest_argmin_launch.argtypes = [_P, _P, _P, _P, _I64, _I, _P]
    lib.rarest_argmin_launch.restype = _I
    lib.waterfill_launch.argtypes = [
        _P, _P, _P, _P, _I64, _I, _I, _I,
        _P, _P, _P, _P, _P, _P, _P, _P,
        ctypes.POINTER(_I), _P, _P,
    ]
    lib.waterfill_launch.restype = _I
    lib.swarm_error_string.argtypes = [_I]
    lib.swarm_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().swarm_error_string(err).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {err} ({msg})")


def _require(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def rarest_argmin_cuda(
    cand: torch.Tensor, avail: torch.Tensor, jitter: torch.Tensor
) -> torch.Tensor:
    """``(k, P)`` bool candidates, ``(P,)`` float32 availability (exact
    integers below ``2**24``), ``(k, P)`` float32 jitter -> ``(k,)`` int32
    picks (``-1`` = no candidate). One warp per row."""
    dev = cand.device
    if dev.type != "cuda":
        raise ValueError(f"rarest_argmin_cuda takes CUDA tensors (got {dev})")
    if cand.dim() != 2:
        raise ValueError("cand must be (k, P)")
    k, P = cand.shape
    _require(cand, "cand", torch.bool, dev)
    _require(avail, "avail", torch.float32, dev)
    _require(jitter, "jitter", torch.float32, dev)
    if avail.shape != (P,) or jitter.shape != (k, P):
        raise ValueError(
            f"shape mismatch: cand {tuple(cand.shape)}, avail "
            f"{tuple(avail.shape)}, jitter {tuple(jitter.shape)}"
        )
    out = torch.empty(k, dtype=torch.int32, device=dev)
    if k == 0:
        return out
    if P == 0:
        return out.fill_(-1)
    if bool(avail.max() >= MAX_EXACT_AVAILABILITY):
        raise ValueError(
            "replica counts no longer exact in float32 — fleet too large"
        )
    require_hopper(dev)
    lib = _lib()
    err = lib.rarest_argmin_launch(
        cand.data_ptr(), avail.data_ptr(), jitter.data_ptr(), out.data_ptr(),
        k, P, _stream(dev),
    )
    rarest_argmin_cuda.launches += 1
    _check(err, "rarest_argmin")
    return out


rarest_argmin_cuda.launches = 0


def waterfill_cuda(
    src: torch.Tensor,
    dst: torch.Tensor,
    lnk: torch.Tensor,
    up: torch.Tensor,
    dn: torch.Tensor,
    lcap: torch.Tensor,
    active_counts: list | None = None,
) -> tuple[torch.Tensor, int]:
    """Flow table -> ``((nf,) float32 rates, rounds)``; the same contract as
    :func:`~repro_torch.kernels.swarm.ref.waterfill_ref` (int32 indices,
    ``-1`` src/dst = padding, ``lnk`` already on the dummy slot for
    unlinked flows, float32 capacities with the dummy link slot last).
    A list passed as ``active_counts`` is extended by each round's
    active-flow count."""
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"waterfill_cuda takes CUDA tensors (got {dev})")
    nf = src.numel()
    nn = up.numel()
    nlp = lcap.numel()
    for t, name in ((src, "src"), (dst, "dst"), (lnk, "lnk")):
        _require(t, name, torch.int32, dev)
        if t.shape != (nf,):
            raise ValueError(f"{name} must be ({nf},)")
    for t, name in ((up, "up"), (dn, "dn"), (lcap, "lcap")):
        _require(t, name, torch.float32, dev)
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D")
    if dn.numel() != nn or nlp < 1:
        raise ValueError("need len(dn) == len(up) and a dummy link slot")
    if nf >= 1 << 31:
        raise ValueError("the kernel counts flows in int32: nf < 2**31")
    rate = torch.empty(nf, dtype=torch.float32, device=dev)
    if nf == 0:
        return rate, 0
    bad = (
        (src < -1) | (src >= nn) | (dst < -1) | (dst >= nn)
        | ((src < 0) != (dst < 0)) | (lnk < 0) | (lnk >= nlp)
    )
    if bool(bad.any()):
        raise ValueError("flow table holds out-of-range node or link indices")
    require_hopper(dev)
    ncon = 2 * nn + nlp
    cap = torch.cat([up, dn, lcap])
    frozen = torch.empty(nf, dtype=torch.uint8, device=dev)
    ncnt = torch.zeros(ncon, dtype=torch.int32, device=dev)
    alloc = torch.zeros(ncon, dtype=torch.float32, device=dev)
    dres = torch.empty(ncon, dtype=torch.float32, device=dev)
    partial = torch.empty(-(-ncon // 256), dtype=torch.float32, device=dev)
    scal = torch.empty(2, dtype=torch.float32, device=dev)
    flags = torch.empty(3, dtype=torch.int32, device=dev)
    rounds = _I(0)
    max_rounds = 2 * nn + (nlp - 1) + 2
    per_round = (
        None if active_counts is None else np.empty(max_rounds, np.int64)
    )
    lib = _lib()
    err = lib.waterfill_launch(
        src.data_ptr(), dst.data_ptr(), lnk.data_ptr(), cap.data_ptr(),
        nf, nn, nlp, max_rounds,
        rate.data_ptr(), frozen.data_ptr(), ncnt.data_ptr(),
        alloc.data_ptr(), dres.data_ptr(), partial.data_ptr(),
        scal.data_ptr(), flags.data_ptr(), ctypes.byref(rounds),
        None if per_round is None else per_round.ctypes.data, _stream(dev),
    )
    waterfill_cuda.launches += 1
    _check(err, "waterfill")
    if active_counts is not None:
        active_counts.extend(per_round[: rounds.value].tolist())
    return rate, rounds.value


waterfill_cuda.launches = 0
