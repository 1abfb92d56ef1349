"""Dispatch for the swarm kernels + device-resident fleet state.

Three layers, mirroring ``repro/kernels/swarm/ops.py``:

- :func:`rarest_argmin` / :func:`waterfill` — tensor-level dispatch by
  the device of the inputs: a CUDA tensor launches the CUDA kernel
  (:mod:`.kernel`) or raises, a CPU tensor takes the plain PyTorch version
  (:mod:`.ref`). Nothing falls back from one to the other.

- :func:`fleet_waterfill` — the engine's numpy-in / numpy-out water-fill
  on an explicit device: builds the link channel (unlinked flows on the
  infinite-capacity dummy slot), uploads the flow table, runs
  :func:`waterfill`, returns float64 rates.

- :class:`FleetDeviceState` — what ``FleetSpec.backend = "pallas"`` keeps
  on the device across ticks: the ``(n, P)`` have-matrix, the fixed
  float32 jitter, and the replica counts. Per-tick selection
  (:func:`select_rows`) builds each row's candidates inside K1's gathered
  form on the card, so only the ``(k,)`` pick vector crosses back;
  completions and departures are incremental scatters sized by what
  changed. Eager PyTorch needs no padding, so every call passes exact
  sizes (the JAX package padded to powers of two and leaned on dropped
  out-of-bounds indices to bound retraces; an out-of-bounds index on CUDA
  is a device fault).

Indices are int64 for torch indexing and int32 at the kernel boundary.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.piece_selection import MAX_EXACT_AVAILABILITY
from .kernel import PITCH, rarest_argmin_cuda, select_rows_cuda, waterfill_cuda
from .ref import link_channel, rarest_argmin_ref, select_rows_ref, waterfill_ref


def _route(t: torch.Tensor, name: str) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def rarest_argmin(
    cand: torch.Tensor, avail: torch.Tensor, jitter: torch.Tensor
) -> torch.Tensor:
    """Masked rarest-first argmin: ``(k,)`` int32 picks, ``-1`` where a row
    has no candidate. Index-exact with ``batched_rarest``."""
    if _route(cand, "rarest_argmin"):
        return rarest_argmin_cuda(cand, avail, jitter)
    return rarest_argmin_ref(cand, avail, jitter)


def select_rows(
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
    """The fleet state's selection for ``rows`` on one stream: ``(k,)``
    int32 picks. On CUDA K1's gathered form builds the candidates inside
    the kernel (``ranges_checked``: the caller has checked ``rows`` and
    ``other`` on the host); on the CPU the plain torch composition."""
    kw = dict(stream=stream, mode=mode, fallback=fallback)
    if _route(have, "select_rows"):
        return select_rows_cuda(have, jitter, repl, swarm_class, rows,
                                other, ranges_checked=ranges_checked, **kw)
    return select_rows_ref(have, jitter, repl, swarm_class, rows, other, **kw)


def waterfill(
    src: torch.Tensor,
    dst: torch.Tensor,
    lnk: torch.Tensor,
    up: torch.Tensor,
    dn: torch.Tensor,
    lcap: torch.Tensor,
) -> tuple[torch.Tensor, int]:
    """Max-min water-filling over a flow table: ``(rates, rounds)``."""
    if _route(src, "waterfill"):
        return waterfill_cuda(src, dst, lnk, up, dn, lcap)
    return waterfill_ref(src, dst, lnk, up, dn, lcap)


def flow_table(
    src: np.ndarray,
    dst: np.ndarray,
    up_cap: np.ndarray,
    down_cap: np.ndarray,
    link_of: Optional[np.ndarray] = None,
    link_cap: Optional[np.ndarray] = None,
    *,
    device,
) -> tuple[torch.Tensor, ...]:
    """The engine's numpy flow table as :func:`waterfill`'s six tensors on
    ``device``: int32 ``src, dst, lnk`` (unlinked flows on the dummy link
    slot) and float32 ``up, dn, lcap``."""
    src = np.asarray(src)
    _, lnk, lcap = link_channel(src.size, link_of, link_cap)
    dev = torch.device(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    return (
        put(src, np.int32), put(dst, np.int32), put(lnk, np.int32),
        put(up_cap, np.float32), put(down_cap, np.float32),
        put(lcap, np.float32),
    )


def fleet_waterfill(
    src: np.ndarray,
    dst: np.ndarray,
    up_cap: np.ndarray,
    down_cap: np.ndarray,
    link_of: Optional[np.ndarray] = None,
    link_cap: Optional[np.ndarray] = None,
    *,
    device,
) -> np.ndarray:
    """Float32 :func:`~repro_torch.core.fleet.waterfill_rates` on
    ``device`` (spine links supported); float64 numpy rates back.
    Bit-exact with ``repro/kernels/swarm/ref.py`` ``waterfill_f32_ref``."""
    if np.asarray(src).size == 0:
        return np.zeros(0, dtype=np.float64)
    rate, _ = waterfill(*flow_table(
        src, dst, up_cap, down_cap, link_of, link_cap, device=device
    ))
    return rate.cpu().numpy().astype(np.float64)


class FleetDeviceState:
    """Device-resident selection state for ``FleetSpec.backend="pallas"``.

    Holds the have-matrix, fixed jitter, replica counts, and the static
    swarm-routing class on ``device`` across ticks. The engine keeps its
    numpy mirrors for scalar control flow (leech masks, host-RNG source
    sampling); the ``O(n * P)`` candidate-mask + argmin traffic happens
    here, and only ``(k,)`` pick vectors cross back per call.

    ``have`` and ``jitter`` are ``(n, P)`` views of buffers whose rows are
    ``pitch`` elements apart, ``P`` rounded up to a multiple of 16, so that
    K1's gathered form reads a row with 16-byte loads; the padding columns
    stay ``False`` and 0 and are never candidates.
    """

    def __init__(self, jitter: np.ndarray, swarm_class: np.ndarray,
                 *, device) -> None:
        n, P = jitter.shape
        if n >= MAX_EXACT_AVAILABILITY:
            raise ValueError(
                "replica counts no longer exact in float32 — fleet too large"
            )
        self.n, self.P = n, P
        self.pitch = pitch = -(-P // PITCH) * PITCH
        self.device = dev = torch.device(device)
        self.have = torch.zeros(
            (n, pitch), dtype=torch.bool, device=dev)[:, :P]
        self.jitter = torch.zeros(
            (n, pitch), dtype=torch.float32, device=dev)[:, :P]
        self.jitter.copy_(torch.tensor(jitter, dtype=torch.float32))
        self.repl = torch.zeros(P, dtype=torch.int32, device=dev)
        self.swarm_class = torch.tensor(
            swarm_class, dtype=torch.bool, device=dev
        )

    @classmethod
    def from_arrays(cls, have: np.ndarray, jitter: np.ndarray,
                    replicas: np.ndarray, swarm_class: np.ndarray,
                    device) -> "FleetDeviceState":
        """A state that starts from host arrays (``np.asarray`` of another
        engine's device state), e.g. to resume a run mid-way."""
        st = cls(jitter, swarm_class, device=device)
        st.have.copy_(torch.tensor(have, dtype=torch.bool))
        st.repl.copy_(torch.tensor(replicas, dtype=torch.int32))
        return st

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(self.device)

    def select(self, rows: np.ndarray, other: np.ndarray, *,
               stream: str, mode: str, fallback: bool) -> np.ndarray:
        """Candidate build + rarest-argmin for ``rows`` on one stream
        (:func:`select_rows`).

        Semantics mirror ``FleetSwarmSim._select``'s numpy cand build
        exactly (index-exact parity is pinned by the tests). The index
        ranges are checked here on the host arrays, so the kernel's
        wrapper needs no synchronisation for them."""
        rows = np.asarray(rows, dtype=np.int64)
        other = np.asarray(other, dtype=np.int64)
        if rows.size and (rows.min() < 0 or rows.max() >= self.n
                          or other.min() < -1 or other.max() >= self.P):
            raise ValueError(
                f"rows must lie in [0, {self.n}) and other in [-1, "
                f"{self.P})"
            )
        pick = select_rows(
            self.have, self.jitter, self.repl, self.swarm_class,
            self._put(rows), self._put(other),
            stream=stream, mode=mode, fallback=fallback, ranges_checked=True,
        )
        return pick.cpu().numpy().astype(np.int64)

    def add_pieces(self, rows: np.ndarray, pieces: np.ndarray) -> None:
        """Piece completions: ``have[rows, pieces] = True`` and bump the
        replica counts (pairs are duplicate-free; pieces may repeat)."""
        if len(rows) == 0:
            return
        r = self._put(rows)
        p = self._put(pieces)
        self.have[r, p] = True
        self.repl.index_add_(
            0, p, torch.ones(p.numel(), dtype=torch.int32, device=self.device)
        )

    def drop_rows(self, rows: np.ndarray) -> None:
        """Departures: remove the rows' held pieces from the replica
        counts (the have rows themselves stay, as on the host)."""
        if len(rows) == 0:
            return
        r = self._put(rows)
        self.repl -= self.have[r].sum(dim=0, dtype=torch.int32)
