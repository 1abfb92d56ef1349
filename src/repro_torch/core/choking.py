"""Tit-for-tat choking.

In the paper's WAN setting choking is an *incentive* mechanism (upload to
those who upload to you, so free-riders starve). Inside a datacenter every
peer is trusted and co-scheduled, so choking degrades into a **rate
allocator**: it bounds each peer's concurrent upload fan-out so uplinks are
not sliced into uselessly thin streams, and reciprocation naturally pairs
fast hosts with fast hosts, which shortens the swarm tail. We keep the
classic algorithm (top-k reciprocation + rotating optimistic unchoke)
because its emergent schedule is exactly what produces the paper's
"benefits grow with more users" behaviour.

Choke state is an *input* to the unified transfer scheduler
(:mod:`repro_torch.core.scheduler`): the engines bake each rechoke round's
verdict into ``NeighborState.unchokes_me``, which is what
``plan_peer_requests`` filters eligible sources on — the choker decides
*who may download from me*, the scheduler decides *what they fetch next*.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass
class ChokerConfig:
    max_unchoked: int = 4          # reciprocated slots
    optimistic_slots: int = 1      # rotating exploration slots
    interval: float = 10.0         # seconds between rechoke rounds
    optimistic_every: int = 3      # rotate optimistic peer every N rounds


class Choker:
    """Per-peer unchoke scheduling. One instance per serving peer."""

    def __init__(self, cfg: ChokerConfig, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng
        self.unchoked: set[str] = set()
        self._optimistic: str | None = None
        self._round = 0

    def rechoke(
        self,
        neighbors: Sequence[str],
        interested: set[str],
        recv_rate: dict[str, float],
        is_seed: bool,
        sent_rate: dict[str, float] | None = None,
    ) -> set[str]:
        """Compute the new unchoke set.

        Leecher: reciprocate the ``max_unchoked`` fastest *uploaders to us*
        among interested neighbors. Seed: favour the fastest *downloaders*
        (drain the uplink into whoever can absorb it — in a datacenter this
        pairs the origin with unsaturated hosts). Plus optimistic slots.
        """
        self._round += 1
        interested_nb = [n for n in neighbors if n in interested]
        if not interested_nb:
            self.unchoked = set()
            self._optimistic = None
            return self.unchoked

        if is_seed:
            score = sent_rate or {}
        else:
            score = recv_rate
        ranked = sorted(
            interested_nb, key=lambda n: (-score.get(n, 0.0), n)
        )
        regular = set(ranked[: self.cfg.max_unchoked])

        # rotate the optimistic unchoke among the currently-choked interested
        if (
            self._optimistic is None
            or self._optimistic not in interested_nb
            or self._round % max(self.cfg.optimistic_every, 1) == 0
        ):
            pool = [n for n in interested_nb if n not in regular]
            self._optimistic = (
                pool[int(self.rng.integers(len(pool)))] if pool else None
            )
        optimistic = (
            {self._optimistic}
            if self._optimistic is not None and self.cfg.optimistic_slots > 0
            else set()
        )
        self.unchoked = regular | optimistic
        return self.unchoked

    def allows(self, peer_id: str) -> bool:
        """Is ``peer_id`` currently unchoked by this peer? (The per-request
        view the engines mirror into ``NeighborState.unchokes_me`` for the
        scheduler.)"""
        return peer_id in self.unchoked


class RateWindow:
    """Rolling byte counters used to score reciprocation (per neighbor)."""

    def __init__(self, halflife: float = 20.0):
        self.halflife = halflife
        self._value: dict[str, float] = {}
        self._stamp: dict[str, float] = {}

    def add(self, peer: str, nbytes: float, now: float) -> None:
        self._decay(peer, now)
        self._value[peer] = self._value.get(peer, 0.0) + nbytes

    def rate(self, peer: str, now: float) -> float:
        self._decay(peer, now)
        return self._value.get(peer, 0.0)

    def snapshot(self, now: float) -> dict[str, float]:
        for p in list(self._value):
            self._decay(p, now)
        return dict(self._value)

    def _decay(self, peer: str, now: float) -> None:
        last = self._stamp.get(peer)
        if last is not None and now > last and peer in self._value:
            self._value[peer] *= 0.5 ** ((now - last) / self.halflife)
        self._stamp[peer] = now
