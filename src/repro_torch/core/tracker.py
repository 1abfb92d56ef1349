"""Tracker: peer discovery + the swarm ledger behind Eq. 1.

The tracker is where the paper's headline number lives: it aggregates every
peer's announced upload/download counters, so ``ud_ratio()`` is computed the
same way the paper computes 15.43 TB / 366.68 GB = 42.067. In the cluster
adaptation the tracker is an in-process service (a real deployment would
back it with the job scheduler's membership service); announce is a function
call, not an HTTP long-poll (DESIGN.md §6).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Optional, Sequence

import numpy as np

from .metainfo import MetaInfo
from .scheduler import percentiles
from .topology import ClusterTopology


@dataclasses.dataclass
class PeerRecord:
    peer_id: str
    uploaded: float = 0.0        # payload bytes served via the peer protocol
    downloaded: float = 0.0      # payload bytes this peer has received
    complete: bool = False
    left: bool = False
    arrived_at: float = 0.0
    completed_at: float = -1.0
    is_origin: bool = False
    is_web_seed: bool = False    # exposes an HTTP byte-range endpoint
    peer_protocol: bool = True   # False => never handed out in peer lists
    banned: bool = False         # quarantined: no handouts, no availability
    http_uploaded: float = 0.0   # payload bytes served via HTTP range requests
    hedge_cancelled: float = 0.0  # bytes this endpoint spent on losing hedges
    tier: str = "peer"           # egress tier: "origin" | "pod_cache" | "peer"
    pod: Optional[int] = None    # locality of a web-seed endpoint (pod caches)

    @property
    def egress(self) -> float:
        return self.uploaded + self.http_uploaded


@dataclasses.dataclass
class SwarmStats:
    seeders: int
    leechers: int
    total_uploaded: float
    total_downloaded: float
    origin_uploaded: float       # mirror-tier egress: peer protocol + HTTP
    completed: int
    origin_http_uploaded: float = 0.0
    # Egress decomposed by serving tier ("origin" / "pod_cache" / "peer").
    # The tiers are exhaustive and disjoint: their sum equals total_uploaded.
    tier_uploaded: dict[str, float] = dataclasses.field(default_factory=dict)
    # Bytes spent on losing hedge duplicates — the tail-latency insurance
    # premium. Mid-range-cancelled partials appear ONLY here (never in
    # uploaded/wasted); a photo-finish loser that fully arrived is counted
    # here AND as wasted, so this overlaps wasted rather than partitioning it.
    hedge_cancelled_bytes: float = 0.0
    # Per-client completion-time percentiles (seconds from arrival); empty
    # until a client completes. See ``repro_torch.core.scheduler.percentiles``.
    completion_percentiles: dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    # Multi-torrent runs: origin-tier egress decomposed per torrent name
    # (filled by :meth:`Tracker.scrape_fleet`; empty for single-torrent
    # scrapes — the aggregate IS that torrent's ledger).
    per_torrent_uploaded: dict[str, float] = dataclasses.field(
        default_factory=dict
    )

    @property
    def origin_peer_uploaded(self) -> float:
        """Origin egress served through the swarm peer protocol only."""
        return self.origin_uploaded - self.origin_http_uploaded

    @property
    def pod_cache_uploaded(self) -> float:
        """Bytes served to leechers out of the pod-local cache tier."""
        return self.tier_uploaded.get("pod_cache", 0.0)

    @property
    def ud_ratio(self) -> float:
        """Eq. 1: community download amplification over origin upload."""
        if self.origin_uploaded <= 0:
            return float("inf") if self.total_downloaded > 0 else 0.0
        return self.total_downloaded / self.origin_uploaded


class Tracker:
    """One tracker instance may serve many torrents (infohash-keyed)."""

    def __init__(self, rng: np.random.Generator | None = None,
                 topology: Optional[ClusterTopology] = None,
                 same_pod_frac: float = 1.0):
        self.rng = rng or np.random.default_rng(0)
        self.topology = topology
        self.same_pod_frac = same_pod_frac
        # control-plane outage flag (tracker_fail/tracker_heal events):
        # engines stop announcing while dark and fall back to cached peer
        # lists; the tracker itself keeps its state frozen
        self.failed = False
        self._swarms: dict[bytes, dict[str, PeerRecord]] = {}
        # infohash -> peer_id -> live Bitfield view (availability accounting)
        self._bitfields: dict[bytes, dict[str, object]] = {}
        # Handout index, maintained incrementally so announce stays
        # O(sample) at 100k peers instead of filtering the whole swarm:
        # _order  — handable pids (peer_protocol, not left) in swarm
        #           insertion order (exactly the order the old full filter
        #           produced, so seeded handouts are bit-identical);
        # _pos    — pid -> index into _order;
        # _seqno  — pid -> creation sequence, so a stopped peer re-joining
        #           via "started" is re-inserted at its original relative
        #           position (dict insertion order never forgets a key).
        self._order: dict[bytes, list[str]] = {}
        self._pos: dict[bytes, dict[str, int]] = {}
        self._seqno: dict[bytes, dict[str, int]] = {}
        # Incremental availability accounting. The map is still a live view
        # of in-place bitfield mutation (attach_bitfield's contract), but
        # each read is O(peers) version checks + O(pieces) per *changed*
        # bitfield instead of an O(peers × pieces) resum — the repair scan
        # and the metrics sampler both poll it every tick.
        # _avail      — running all-counted replica sums (int64, per ih)
        # _avail_comm — running community sums (origins/web-seeds excluded)
        # _counted    — per counted peer: (bitfield version at last sync,
        #               bits snapshot, infrastructure flag)
        self._avail: dict[bytes, np.ndarray] = {}
        self._avail_comm: dict[bytes, np.ndarray] = {}
        self._counted: dict[bytes, dict[str, tuple[int, np.ndarray, bool]]] = {}

    # ------------------------------------------------------------- registration
    def register(self, metainfo: MetaInfo) -> None:
        ih = metainfo.info_hash
        self._swarms.setdefault(ih, {})
        self._order.setdefault(ih, [])
        self._pos.setdefault(ih, {})
        self._seqno.setdefault(ih, {})
        if ih not in self._avail:
            self._avail[ih] = np.zeros(metainfo.num_pieces, dtype=np.int64)
            self._avail_comm[ih] = np.zeros(metainfo.num_pieces, dtype=np.int64)
            self._counted[ih] = {}

    def _swarm(self, metainfo: MetaInfo) -> dict[str, PeerRecord]:
        if metainfo.info_hash not in self._swarms:
            raise KeyError(f"unknown torrent {metainfo.name}")
        return self._swarms[metainfo.info_hash]

    # ------------------------------------------------------------- announce
    def announce(
        self,
        metainfo: MetaInfo,
        peer_id: str,
        *,
        uploaded: float,
        downloaded: float,
        event: str = "update",   # started | update | completed | stopped
        now: float = 0.0,
        is_origin: bool = False,
        is_web_seed: bool = False,
        peer_protocol: bool = True,
        http_uploaded: Optional[float] = None,
        hedge_cancelled: Optional[float] = None,
        want_peers: int = 40,
        tier: Optional[str] = None,
        pod: Optional[int] = None,
    ) -> list[str]:
        swarm = self._swarm(metainfo)
        ih = metainfo.info_hash
        order = self._order[ih]
        pos = self._pos[ih]
        seqno = self._seqno[ih]
        rec = swarm.get(peer_id)
        if rec is None:
            rec = PeerRecord(
                peer_id=peer_id, arrived_at=now, is_origin=is_origin,
                is_web_seed=is_web_seed, peer_protocol=peer_protocol,
                tier=tier or ("origin" if is_origin else "peer"), pod=pod,
            )
            swarm[peer_id] = rec
            seqno[peer_id] = len(seqno)
            if peer_protocol:
                pos[peer_id] = len(order)
                order.append(peer_id)
        rec.uploaded = float(uploaded)
        rec.downloaded = float(downloaded)
        if http_uploaded is not None:
            rec.http_uploaded = float(http_uploaded)
        if hedge_cancelled is not None:
            rec.hedge_cancelled = float(hedge_cancelled)
        if event == "completed":
            rec.complete = True
            rec.completed_at = now
        elif event == "stopped":
            rec.left = True
            k = pos.pop(peer_id, None)
            if k is not None:
                order.pop(k)
                for pid in order[k:]:
                    pos[pid] -= 1
        elif event == "started":
            # a healed mirror (or a rejoining peer) re-announces: it is
            # handed out again and counts as live in scrapes — back at its
            # original insertion-order slot, so handouts after a heal are
            # identical to the old whole-swarm filter's
            rec.left = False
            if rec.peer_protocol and not rec.banned and peer_id not in pos:
                k = bisect.bisect_left(
                    order, seqno[peer_id], key=lambda q: seqno[q]
                )
                order.insert(k, peer_id)
                for pid in order[k:]:
                    pos[pid] = k
                    k += 1

        if self.topology is not None:
            candidates = [pid for pid in order if pid != peer_id]
            candidates = self.topology.rank_peers(
                peer_id, candidates, rng=self.rng,
                same_pod_frac=self.same_pod_frac,
            )
            return candidates[:want_peers]
        # O(sample) handout: draw index positions, skip over the announcer
        # in place. RNG call (args and count) matches the old full-copy
        # shuffle path exactly — seeded goldens are bit-identical.
        p = pos.get(peer_id, -1)
        n_cand = len(order) - (1 if p >= 0 else 0)
        if n_cand <= want_peers:
            return [pid for pid in order if pid != peer_id]
        idx = self.rng.choice(n_cand, size=want_peers, replace=False)
        idx.sort()
        if p >= 0:
            return [order[i if i < p else i + 1] for i in idx]
        return [order[i] for i in idx]

    # ------------------------------------------------------------- quarantine
    def ban_peer(self, metainfo: MetaInfo, peer_id: str) -> None:
        """Quarantine ``peer_id``: evict it from the handout index (same
        splice as a ``stopped`` announce) and from availability accounting.
        The record itself stays — its counters keep ledgering, and ``left``
        is untouched so the engine keeps deciding session liveness."""
        swarm = self._swarm(metainfo)
        rec = swarm.get(peer_id)
        if rec is None or rec.banned:
            return
        rec.banned = True
        ih = metainfo.info_hash
        pos = self._pos[ih]
        order = self._order[ih]
        k = pos.pop(peer_id, None)
        if k is not None:
            order.pop(k)
            for pid in order[k:]:
                pos[pid] -= 1
        self._uncount(ih, peer_id)

    def parole_peer(self, metainfo: MetaInfo, peer_id: str) -> None:
        """Lift a quarantine: re-insert the peer into the handout index at
        its original insertion-order slot (same bisect as a ``started``
        re-announce) and let the next availability sync re-count it."""
        swarm = self._swarm(metainfo)
        rec = swarm.get(peer_id)
        if rec is None or not rec.banned:
            return
        rec.banned = False
        ih = metainfo.info_hash
        pos = self._pos[ih]
        order = self._order[ih]
        seqno = self._seqno[ih]
        if rec.peer_protocol and not rec.left and peer_id not in pos:
            k = bisect.bisect_left(
                order, seqno[peer_id], key=lambda q: seqno[q]
            )
            order.insert(k, peer_id)
            for pid in order[k:]:
                pos[pid] = k
                k += 1

    # ------------------------------------------------------------- availability
    def attach_bitfield(
        self, metainfo: MetaInfo, peer_id: str, bitfield
    ) -> None:
        """Register a live bitfield view for :meth:`availability_map`.

        Engines attach each agent's :class:`~repro_torch.core.bitfield.Bitfield`
        at announce time; the tracker reads it in place (no copies), so the
        availability view tracks the swarm for free. In a real deployment
        this is the HAVE/bitfield message stream the tracker or a scraping
        monitor already observes.
        """
        self._swarm(metainfo)  # raises KeyError for unknown torrents
        ih = metainfo.info_hash
        bfs = self._bitfields.setdefault(ih, {})
        if bfs.get(peer_id) is not bitfield:
            # re-attach with a new object: the old snapshot is stale and
            # the new object's version counter is unrelated to it
            self._uncount(ih, peer_id)
        bfs[peer_id] = bitfield

    def _uncount(self, ih: bytes, peer_id: str) -> None:
        entry = self._counted.get(ih, {}).pop(peer_id, None)
        if entry is not None:
            _, snap, infra = entry
            self._avail[ih] -= snap
            if not infra:
                self._avail_comm[ih] -= snap

    def _sync_availability(self, metainfo: MetaInfo) -> None:
        """Bring the running replica sums up to date with the live swarm.

        For each attached bitfield: peers that joined/changed since the
        last sync have their old snapshot subtracted and the current bits
        added; departed peers are uncounted. Unchanged peers cost one dict
        lookup and a version compare.
        """
        swarm = self._swarm(metainfo)
        ih = metainfo.info_hash
        avail, comm = self._avail[ih], self._avail_comm[ih]
        counted = self._counted[ih]
        for peer_id, bf in self._bitfields.get(ih, {}).items():
            rec = swarm.get(peer_id)
            live = rec is not None and not rec.left and not rec.banned
            entry = counted.get(peer_id)
            if not live:
                if entry is not None:
                    self._uncount(ih, peer_id)
                continue
            infra = rec.is_origin or rec.is_web_seed
            if entry is not None and entry[0] == bf.version \
                    and entry[2] == infra:
                continue
            if entry is not None:
                self._uncount(ih, peer_id)
            snap = bf.as_array().astype(np.int64)
            avail += snap
            if not infra:
                comm += snap
            counted[peer_id] = (bf.version, snap, infra)

    def availability_map(
        self, metainfo: MetaInfo, *, include_origins: bool = True
    ) -> np.ndarray:
        """Piece -> live replica count (int64, length ``num_pieces``).

        Counts every attached bitfield whose peer record is present and has
        not left the swarm. The repair controller schedules re-seeds from
        its minima and the sampler reads min/mean replication from it.
        Peers announced without an attached bitfield contribute nothing
        (the tracker cannot see what it was never shown). Maintained
        incrementally; :meth:`availability_recompute` is the O(peers ×
        pieces) reference it must always agree with.
        """
        self._sync_availability(metainfo)
        ih = metainfo.info_hash
        src = self._avail[ih] if include_origins else self._avail_comm[ih]
        return src.copy()

    def availability_recompute(
        self, metainfo: MetaInfo, *, include_origins: bool = True
    ) -> np.ndarray:
        """Reference full recompute of :meth:`availability_map` (tests)."""
        swarm = self._swarm(metainfo)
        out = np.zeros(metainfo.num_pieces, dtype=np.int64)
        for peer_id, bf in self._bitfields.get(metainfo.info_hash, {}).items():
            rec = swarm.get(peer_id)
            if rec is None or rec.left or rec.banned:
                continue
            if not include_origins and (rec.is_origin or rec.is_web_seed):
                continue
            out += bf.as_array()
        return out

    # ------------------------------------------------------------- mirrors
    def mirror_list(self, metainfo: MetaInfo, peer_id: str) -> list[str]:
        """Ranked live web-seed endpoints for ``peer_id``.

        The tracker-side half of mirror selection: discovery plus locality
        tiering. The client's pod cache (if one is registered for its pod)
        ranks first; other pods' caches are withheld (serving through them
        would re-cross the spine); root mirrors follow, least announced
        egress first, so a cold mirror naturally absorbs new clients. The
        swarm driver applies its client-side ``OriginPolicy.selection`` on
        top of this list.
        """
        swarm = self._swarm(metainfo)
        my_pod: Optional[int] = None
        if self.topology is not None:
            addr = self.topology.addr_of(peer_id)
            my_pod = addr.pod if addr is not None else None
        ranked = []
        for rec in swarm.values():
            if not rec.is_web_seed or rec.left or rec.peer_id == peer_id:
                continue
            if rec.tier == "pod_cache" and rec.pod != my_pod:
                continue
            local = 0 if (rec.pod is not None and rec.pod == my_pod) else 1
            ranked.append((local, rec.egress, rec.peer_id))
        return [pid for _, _, pid in sorted(ranked)]

    # ------------------------------------------------------------- scrape
    def scrape(self, metainfo: MetaInfo) -> SwarmStats:
        swarm = self._swarm(metainfo)
        # pod caches are infrastructure, not community members: they never
        # count as seeders/leechers (their bytes land in tier_uploaded)
        live = [r for r in swarm.values() if not r.left and r.tier != "pod_cache"]
        tiers: dict[str, float] = {}
        for r in swarm.values():
            tiers[r.tier] = tiers.get(r.tier, 0.0) + r.egress
        completion_times = [
            r.completed_at - r.arrived_at
            for r in swarm.values()
            if r.complete and not r.is_origin and r.tier != "pod_cache"
        ]
        return SwarmStats(
            seeders=sum(1 for r in live if r.complete or r.is_origin),
            leechers=sum(1 for r in live if not (r.complete or r.is_origin)),
            total_uploaded=sum(r.egress for r in swarm.values()),
            total_downloaded=sum(r.downloaded for r in swarm.values()),
            origin_uploaded=sum(
                r.egress for r in swarm.values() if r.is_origin
            ),
            completed=sum(1 for r in swarm.values() if r.complete),
            origin_http_uploaded=sum(
                r.http_uploaded for r in swarm.values() if r.is_origin
            ),
            tier_uploaded=tiers,
            hedge_cancelled_bytes=sum(
                r.hedge_cancelled for r in swarm.values()
            ),
            completion_percentiles=percentiles(completion_times),
        )

    def scrape_fleet(self, metainfos: Sequence[MetaInfo]) -> SwarmStats:
        """Aggregate scrape across concurrent torrents, with the origin-tier
        egress decomposed per torrent (``per_torrent_uploaded``) — the
        multi-torrent ledger the fairness scenarios assert on. Completion
        percentiles are recomputed over the union of all torrents' clients,
        not averaged per torrent."""
        per = {mi.name: self.scrape(mi) for mi in metainfos}
        tiers: dict[str, float] = {}
        for st in per.values():
            for tier, nbytes in st.tier_uploaded.items():
                tiers[tier] = tiers.get(tier, 0.0) + nbytes
        completion_times = [
            r.completed_at - r.arrived_at
            for mi in metainfos
            for r in self._swarm(mi).values()
            if r.complete and not r.is_origin and r.tier != "pod_cache"
        ]
        return SwarmStats(
            seeders=sum(s.seeders for s in per.values()),
            leechers=sum(s.leechers for s in per.values()),
            total_uploaded=sum(s.total_uploaded for s in per.values()),
            total_downloaded=sum(s.total_downloaded for s in per.values()),
            origin_uploaded=sum(s.origin_uploaded for s in per.values()),
            completed=sum(s.completed for s in per.values()),
            origin_http_uploaded=sum(
                s.origin_http_uploaded for s in per.values()
            ),
            tier_uploaded=tiers,
            hedge_cancelled_bytes=sum(
                s.hedge_cancelled_bytes for s in per.values()
            ),
            completion_percentiles=percentiles(completion_times),
            per_torrent_uploaded={
                name: s.origin_uploaded for name, s in per.items()
            },
        )

    def records(self, metainfo: MetaInfo) -> dict[str, PeerRecord]:
        return dict(self._swarm(metainfo))
