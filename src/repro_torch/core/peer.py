"""Peer agent: per-host swarm participant.

Each training host (and the origin/blob-store) runs one agent. The agent
owns: its bitfield, its local availability view (sum of neighbor bitfields,
the rarest-first input), its request pipeline, a tit-for-tat choker for the
peers it serves, and a byte ledger (the numbers the tracker aggregates into
Eq. 1). Control messages (Have/Interested/Unchoke) are zero-latency method
calls — a datacenter control plane, see DESIGN.md §6 — while *payload*
movement goes through the fluid netsim (time-domain) or a real byte store
(functional mode).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .bitfield import Bitfield
from .choking import Choker, ChokerConfig, RateWindow
from .metainfo import MetaInfo
from .netsim import Node


@dataclasses.dataclass
class Ledger:
    uploaded: float = 0.0          # verified payload bytes served
    downloaded: float = 0.0        # verified payload bytes received
    wasted: float = 0.0            # bytes discarded (failed verification / dup)
    pieces_served: int = 0
    pieces_received: int = 0


@dataclasses.dataclass
class NeighborState:
    bitfield: Bitfield
    unchokes_me: bool = False      # remote allows me to download
    outstanding: int = 0           # my in-flight requests to this neighbor


class PeerAgent:
    def __init__(
        self,
        peer_id: str,
        metainfo: MetaInfo,
        rng: np.random.Generator,
        *,
        is_origin: bool = False,
        policy: str = "rarest_first",
        pipeline: int = 8,
        per_peer_requests: int = 2,
        choker_cfg: ChokerConfig | None = None,
        store: Optional[dict[int, bytes]] = None,
    ):
        self.peer_id = peer_id
        self.metainfo = metainfo
        self.rng = rng
        self.is_origin = is_origin
        self.policy = policy
        self.pipeline = pipeline
        self.per_peer_requests = per_peer_requests
        self.bitfield = (
            Bitfield.full(metainfo.num_pieces)
            if is_origin
            else Bitfield(metainfo.num_pieces)
        )
        # payload store: piece index -> bytes (None => size-only simulation)
        self.store = store
        # web-seed routing: when set, the *peer* path only pursues pieces with
        # want_mask True — the rest arrive via HTTP range requests (webseed.py)
        self.want_mask: Optional[np.ndarray] = None
        self.neighbors: dict[str, NeighborState] = {}
        self.availability = np.zeros(metainfo.num_pieces, dtype=np.int64)
        self.choker = Choker(choker_cfg or ChokerConfig(), rng)
        self.recv_window = RateWindow()
        self.sent_window = RateWindow()
        self.ledger = Ledger()
        self.in_flight: dict[int, str] = {}       # piece -> source peer_id
        self.endgame_extra: set[int] = set()      # pieces we duplicated in endgame
        # why the most recent accept_piece returned False: True iff the
        # payload failed hash verification (lets callers steer re-fetches
        # to another source without re-hashing the bytes)
        self.last_reject_verify = False
        self.node: Node | None = None             # attached by the swarm driver
        self.arrived_at = 0.0
        self.completed_at: float | None = 0.0 if is_origin else None
        self.departed = False

    # ------------------------------------------------------------- predicates
    @property
    def complete(self) -> bool:
        return self.bitfield.complete

    @property
    def is_seed(self) -> bool:
        return self.is_origin or self.complete

    def interested_in(self, other_id: str) -> bool:
        nb = self.neighbors.get(other_id)
        if nb is None:
            return False
        if self.want_mask is None:
            return self.bitfield.interested_in(nb.bitfield)
        return bool(
            (nb.bitfield.as_array() & ~self.bitfield.as_array() & self.want_mask).any()
        )

    def _peer_path_bitfield(self) -> Bitfield:
        """Bitfield used for *peer* request planning: pieces outside
        ``want_mask`` are treated as held, so selection skips them."""
        if self.want_mask is None:
            return self.bitfield
        return Bitfield(
            len(self.bitfield), self.bitfield.as_array() | ~self.want_mask
        )

    # ------------------------------------------------------------- membership
    def connect(self, other_id: str, other_bitfield: Bitfield) -> None:
        if other_id in self.neighbors or other_id == self.peer_id:
            return
        self.neighbors[other_id] = NeighborState(bitfield=other_bitfield.copy())
        self.availability += other_bitfield.as_array()

    def disconnect(self, other_id: str) -> None:
        nb = self.neighbors.pop(other_id, None)
        if nb is not None:
            self.availability -= nb.bitfield.as_array()
        self.choker.unchoked.discard(other_id)

    def on_have(self, other_id: str, piece: int) -> None:
        nb = self.neighbors.get(other_id)
        if nb is not None and not nb.bitfield.has(piece):
            nb.bitfield.set(piece)
            self.availability[piece] += 1

    # ------------------------------------------------------------- piece intake
    def accept_piece(
        self,
        piece: int,
        source_id: str,
        data: Optional[bytes],
        now: float,
        corrupt: bool = False,
    ) -> bool:
        """Verify + commit a received piece. Returns False if rejected.

        ``corrupt=True`` forces rejection for size-only simulations (no
        payload to hash); with payload present, corruption is instead
        injected into the bytes and *this* verification catches it.
        """
        size = self.metainfo.piece_size(piece)
        self.in_flight.pop(piece, None)
        self.endgame_extra.discard(piece)
        self.last_reject_verify = False
        nb = self.neighbors.get(source_id)
        if nb is not None:
            nb.outstanding = max(0, nb.outstanding - 1)
        if self.bitfield.has(piece):
            self.ledger.wasted += size  # endgame duplicate arrival
            return False
        if corrupt and data is None:
            self.ledger.wasted += size
            return False
        if data is not None:
            if not self.metainfo.verify_piece(piece, data):
                self.ledger.wasted += size
                self.last_reject_verify = True
                return False
            if self.store is not None:
                self.store[piece] = data
        self.bitfield.set(piece)
        self.ledger.downloaded += size
        self.ledger.pieces_received += 1
        self.recv_window.add(source_id, size, now)
        return True

    def record_served(self, piece: int, dest_id: str, now: float) -> None:
        size = self.metainfo.piece_size(piece)
        self.ledger.uploaded += size
        self.ledger.pieces_served += 1
        self.sent_window.add(dest_id, size, now)

    def read_piece(self, piece: int) -> Optional[bytes]:
        if self.store is None:
            return None
        return self.store.get(piece)

    # ------------------------------------------------------------- choking
    def rechoke(self, interested_in_me: set[str], now: float) -> set[str]:
        return self.choker.rechoke(
            neighbors=sorted(self.neighbors),
            interested=interested_in_me,
            recv_rate=self.recv_window.snapshot(now),
            is_seed=self.is_seed,
            sent_rate=self.sent_window.snapshot(now),
        )

    # ------------------------------------------------------------- request planning
    def plan_requests(self) -> list[tuple[str, int]]:
        """Greedy fill of the request pipeline from unchoked neighbors.

        The planning logic lives in the unified scheduler core
        (:func:`repro_torch.core.scheduler.plan_peer_requests`) so both engines
        share one implementation; this remains the per-agent entry point.
        """
        from .scheduler import plan_peer_requests

        return plan_peer_requests(self)
