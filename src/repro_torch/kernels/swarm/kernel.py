"""CUDA swarm kernels for Hopper: build, binding and launch wrappers.

The kernels live in ``csrc/swarm_kernels.cu`` behind a plain C interface,
built and loaded at first use by :mod:`repro_torch.kernels.nvcc`
(``sm_90a``, ``ctypes``). Nothing is compiled or loaded when this module
is imported.

The wrappers take CUDA tensors only: they check dtype, shape, layout,
index ranges and device, allocate outputs and scratch with torch on the
tensors' device, launch on torch's current stream, and raise when the C
call returns a CUDA error. Each has a plain-integer ``launches`` counter
that goes up by one where it launches its kernel, and nowhere else.

- :func:`rarest_argmin_cuda` (K1, dense form) and :func:`select_rows_cuda`
  (K1, gathered form: the candidates built inside the kernel from the
  fleet's device state) replace ``repro/kernels/swarm/kernel.py``
  ``_rarest_argmin_kernel`` / ``rarest_argmin_call``.
- :func:`waterfill_cuda` (K2) replaces ``repro/kernels/swarm/kernel.py``
  ``_waterfill_kernel`` / ``waterfill_call``: the whole fixed point is one
  cooperative launch.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ...compat import require_hopper
from ...core.piece_selection import MAX_EXACT_AVAILABILITY
from .. import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "swarm_kernels.cu"
#: -fmad=false keeps every multiply and add separately rounded (the
#: water-fill is bit-exact with its plain version); no --use_fast_math,
#: so division stays IEEE.
NVCC_FLAGS = (*nvcc.BASE_FLAGS, "-fmad=false")
#: The gathered form reads the have-matrix and jitter at a row pitch that
#: is a multiple of this many elements (16-byte vector loads).
PITCH = 16
#: The gathered form keeps one int32 key a piece of the pitch in shared
#: memory (227 KB a CTA at most).
MAX_PITCH = 227 * 1024 // 4
#: ``SelectMode`` of the C source, by (stream, mode, fallback).
SELECT_MODES = {
    ("http", "http_first", False): 0, ("http", "http_first", True): 0,
    ("http", "swarm_first", False): 1, ("http", "swarm_first", True): 2,
    ("swarm", "http_first", False): 3, ("swarm", "http_first", True): 3,
    ("swarm", "swarm_first", False): 3, ("swarm", "swarm_first", True): 3,
}
#: K2's control words (``Ctrl`` in the C source) and where the rounds go.
CTRL_WORDS = 8
CTRL_ROUNDS = 6

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE, NVCC_FLAGS)
    lib.rarest_argmin_launch.argtypes = [_P, _P, _P, _P, _I64, _I, _P]
    lib.rarest_argmin_launch.restype = _I
    lib.select_rows_launch.argtypes = [
        _P, _P, _I64, _P, _P, _P, _P, _P, _I64, _I, _I, _P,
    ]
    lib.select_rows_launch.restype = _I
    lib.waterfill_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
        _P, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_I), _P,
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
    picks (``-1`` = no candidate). A CTA stages a tile of 32 rows in shared
    memory where it fits (``P <= 287``); wider rows are read from device
    memory, a warp a row."""
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


def _padded_rows(t: torch.Tensor, name: str, dtype, n: int, P: int) -> int:
    """Checks that ``t`` is an ``(n, P)`` view of an ``(n, pitch)`` buffer
    (``pitch`` a multiple of :data:`PITCH`, the rows 16-byte aligned) and
    returns ``pitch``."""
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != (n, P):
        raise ValueError(f"{name} is {tuple(t.shape)}, expected {(n, P)}")
    pitch = t.stride(0)
    if t.stride(1) != 1 or pitch < P or pitch % PITCH:
        raise ValueError(
            f"{name} must be rows of {P} elements at a pitch that is a "
            f"multiple of {PITCH} (strides {t.stride()})"
        )
    if pitch > MAX_PITCH:
        raise ValueError(f"{name}'s pitch {pitch} is above {MAX_PITCH}")
    held = t.untyped_storage().nbytes() // t.element_size()
    if t.storage_offset() + n * pitch > held:
        raise ValueError(f"{name}'s buffer ends inside its padded last row")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}'s rows must start 16-byte aligned")
    return pitch


def select_rows_cuda(
    have: torch.Tensor,
    jitter: torch.Tensor,
    repl: torch.Tensor,
    swarm_class: torch.Tensor,
    rows: torch.Tensor,
    other: torch.Tensor,
    *,
    stream: str,
    mode: str,
    fallback: bool,
    ranges_checked: bool = False,
) -> torch.Tensor:
    """K1's gathered form: :func:`~repro_torch.kernels.swarm.ref
    .select_rows_ref` in one launch. ``have`` (bool) and ``jitter``
    (float32) are ``(n, P)`` views at a padded row pitch (see
    :class:`~repro_torch.kernels.swarm.ops.FleetDeviceState`), ``repl``
    ``(P,)`` int32 replica counts, ``swarm_class`` ``(P,)`` bool, ``rows``
    (in ``[0, n)``) and ``other`` (in ``[-1, P)``) ``(k,)`` int64 ->
    ``(k,)`` int32 picks. Every argument is checked before the kernel is
    built or launched: the index ranges on the device, with one
    synchronisation, unless the caller has checked them on the host
    (``ranges_checked``)."""
    if have.dim() != 2:
        raise ValueError("have must be (n, P)")
    n, P = have.shape
    pitch = _padded_rows(have, "have", torch.bool, n, P)
    if _padded_rows(jitter, "jitter", torch.float32, n, P) != pitch:
        raise ValueError("have and jitter must share one row pitch")
    k = rows.numel()
    for t, name, dtype, shape in (
        (repl, "repl", torch.int32, (P,)),
        (swarm_class, "swarm_class", torch.bool, (P,)),
        (rows, "rows", torch.int64, (k,)),
        (other, "other", torch.int64, (k,)),
    ):
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}")
    key = (stream, mode, bool(fallback))
    if key not in SELECT_MODES:
        raise ValueError(f"unknown stream/mode {stream!r}/{mode!r}")
    if k and not ranges_checked:
        lo_r, hi_r, lo_o, hi_o = torch.stack(
            [*torch.aminmax(rows), *torch.aminmax(other)]
        ).tolist()
        if lo_r < 0 or hi_r >= n or lo_o < -1 or hi_o >= P:
            raise ValueError(
                f"rows must lie in [0, {n}) and other in [-1, {P}) (rows "
                f"{lo_r}..{hi_r}, other {lo_o}..{hi_o})"
            )
    dev = have.device
    if dev.type != "cuda":
        raise ValueError(f"select_rows_cuda takes CUDA tensors (got {dev})")
    for t, name in ((jitter, "jitter"), (repl, "repl"),
                    (swarm_class, "swarm_class"), (rows, "rows"),
                    (other, "other")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    out = torch.empty(k, dtype=torch.int32, device=dev)
    if k == 0:
        return out
    require_hopper(dev)
    lib = _lib()
    err = lib.select_rows_launch(
        have.data_ptr(), jitter.data_ptr(), pitch, repl.data_ptr(),
        swarm_class.data_ptr(), rows.data_ptr(), other.data_ptr(),
        out.data_ptr(), k, P, SELECT_MODES[key], _stream(dev),
    )
    select_rows_cuda.launches += 1
    _check(err, "select_rows")
    return out


select_rows_cuda.launches = 0


def waterfill_cuda(
    src: torch.Tensor,
    dst: torch.Tensor,
    lnk: torch.Tensor,
    up: torch.Tensor,
    dn: torch.Tensor,
    lcap: torch.Tensor,
    active_counts: list | None = None,
    touched_counts: list | None = None,
) -> tuple[torch.Tensor, int]:
    """Flow table -> ``((nf,) float32 rates, rounds)``; the same contract as
    :func:`~repro_torch.kernels.swarm.ref.waterfill_ref` (int32 indices,
    ``-1`` src/dst = padding, ``lnk`` already on the dummy slot for
    unlinked flows, float32 capacities with the dummy link slot last).
    A list passed as ``active_counts`` is extended by each round's
    active-flow count, one passed as ``touched_counts`` by the constraint
    slots those flows touched. The fixed point is one cooperative launch
    after one zero-fill of its scratch; ``last_grid`` records the CTAs it
    ran."""
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
    if nf >= 1 << 31 or 2 * nn + nlp >= 1 << 31:
        raise ValueError("the kernel indexes flows and slots in int32")
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
    max_rounds = 2 * nn + (nlp - 1) + 2
    # every round that goes on freezes a flow: rounds <= real flows <= nf
    slots = min(max_rounds, nf)
    # one zero-fill: both count arrays, alloc (+0.0) and the control words
    zeroed = torch.zeros(3 * ncon + CTRL_WORDS, dtype=torch.int32,
                         device=dev)
    ncnt, alloc, ctrl = zeroed[: 2 * ncon], zeroed[2 * ncon: 3 * ncon], \
        zeroed[3 * ncon:]
    lists = torch.empty(2 * nf, dtype=torch.int32, device=dev)
    touched = torch.empty(2 * ncon, dtype=torch.int32, device=dev)
    dres = torch.empty(ncon, dtype=torch.float32, device=dev)
    per_round = torch.empty((slots, 2), dtype=torch.int32, device=dev)
    grid = _I(0)
    lib = _lib()
    err = lib.waterfill_launch(
        src.data_ptr(), dst.data_ptr(), lnk.data_ptr(), up.data_ptr(),
        dn.data_ptr(), lcap.data_ptr(), nf, nn, nlp, max_rounds,
        rate.data_ptr(), lists.data_ptr(), touched.data_ptr(),
        ncnt.data_ptr(), alloc.data_ptr(), dres.data_ptr(),
        per_round.data_ptr(), ctrl.data_ptr(), ctypes.byref(grid),
        _stream(dev),
    )
    waterfill_cuda.launches += 1
    _check(err, "waterfill")
    waterfill_cuda.last_grid = grid.value
    rounds = int(ctrl[CTRL_ROUNDS])
    if active_counts is not None or touched_counts is not None:
        active, touched = per_round[:rounds].T.tolist()
        for counts, got in ((active_counts, active),
                            (touched_counts, touched)):
            if counts is not None:
                counts.extend(got)
    return rate, rounds


waterfill_cuda.launches = 0
waterfill_cuda.last_grid = None
