"""Web-seed origin fabric: HTTP mirrors + pod caches augmented with a swarm.

This is the paper's headline mechanism made explicit — "by augmenting an
existing HTTP server with a peer-to-peer swarm, requests get re-routed to
get data from downloaders" — generalized from one hard-wired origin to a
**hierarchical multi-origin delivery network**. Real dissemination (the
ImageNet mirrors the paper opens with) is served from several mirrors with
divergent bandwidth; inside a cluster, a pod-local cache tier collapses
cross-pod traffic the same way the swarm collapses origin traffic. Origins
stay plain byte-range HTTP servers; leechers decide, *per piece request*,
whether to hit an origin or a peer, and every HTTP-delivered piece
immediately becomes swarm inventory (a Have broadcast).

Routing, piece choice, ranked-origin choice, retry/backoff, verified
failover, and hedging decisions are owned by the engine-independent
:class:`repro_torch.core.scheduler.TransferScheduler`; this module provides the
origin fabric (mirrors, caches, admission, egress ledgers) and the
time-domain engine that drives the scheduler over the fluid netsim.

Components:

* :class:`OriginPolicy` — all the routing/serving knobs (below; defined in
  :mod:`repro_torch.core.scheduler`, re-exported here).
* :class:`MirrorSpec` — one mirror's deployment description (uplink
  bandwidth, latency penalty, static weight, admission cap).
* :class:`WebSeedOrigin` — the HTTP front-end over a piece store: verified
  byte-range reads, admission control, an HTTP-egress ledger, and a
  ``corrupt_once`` fault-injection hook (serve a bad range once, then heal)
  for exercising the client-side verify + re-fetch path.
* :class:`OriginSet` — the mirror tier: N :class:`WebSeedOrigin` mirrors
  plus the client-side selection policy (static weights, least-loaded,
  EWMA throughput) and fault hooks (``fail``/``heal``). The tracker's
  :meth:`~repro_torch.core.tracker.Tracker.mirror_list` supplies discovery and
  locality tiering; ``OriginSet.ranked`` orders within the tier.
* :class:`PodCacheOrigin` — a per-pod web-seed proxy: serves its pod over
  cheap leaf links and lazily fills from the mirror tier over the spine,
  verifying every filled piece before caching it (a bad mirror is excluded
  per piece and the fill re-fetched from the next one).
* :func:`swarm_routed_mask` — deterministic per-piece route assignment.
  Each piece hashes to a uniform score in [0, 1); pieces with score <
  ``swarm_fraction`` are swarm-routed. The sets are *nested* across
  fractions, so origin egress falls monotonically as the fraction grows
  (the Fig. 1 hybrid crossover), and the endpoints are exact: fraction 0
  is pure HTTP, fraction 1 is pure swarm.
* :class:`WebSeedSwarmSim` — the time-domain engine: HTTP range flows,
  cache-fill flows, and peer flows share the fluid netsim (cross-pod flows
  additionally contend on the topology's spine link), and the tracker
  ledger splits egress per tier (``SwarmStats.tier_uploaded``) and per
  origin. A mirror that dies mid-range aborts its flows and clients/caches
  fail over to the next ranked mirror.

The byte-domain integration lives in :class:`repro_torch.core.swarm.LocalSwarm`
(``webseed=``/``mirrors=`` arguments): real verified range reads with HTTP
fallback when no peer holds a piece, which is what lets
``repro.data.swarm_loader`` cold-start ingest from the nearest pod cache —
or a bare origin — with zero seeded peers.

``OriginPolicy`` knobs:

======================  =====================================================
``mode``                ``"swarm_first"``: swarm-routed pieces go to peers;
                        origins are only hit for HTTP-routed pieces and —
                        when ``http_fallback`` — for pieces *no connected
                        peer holds* (cold start, churn holes).
                        ``"http_first"``: every missing piece is eligible
                        for an HTTP range request the moment the client has
                        a free slot; the swarm opportunistically re-routes
                        whatever peers can already serve (origin offload).
``swarm_fraction``      Fraction of the piece space routed through the
                        swarm (0 = pure HTTP baseline, 1 = pure swarm).
``origin_up_bps``       Default bandwidth cap on a mirror's egress; a
                        :class:`MirrorSpec` overrides it per mirror.
``max_concurrent``      Admission control: simultaneous range requests each
                        origin (mirror or pod cache) will serve; excess
                        requests are rejected. ``MirrorSpec.max_concurrent``
                        overrides it per mirror.
``backoff``             Seconds a rejected client waits before retrying.
``http_pipeline``       Concurrent range requests per client (1 = serial
                        range streaming, matching the HTTP baseline).
``http_fallback``       Allow swarm-routed pieces to fall back to an
                        origin when no connected peer holds them.
``serve_peer_protocol`` Mirror hosts *also* join the swarm as seeds
                        (one box, two serving paths, one uplink). With
                        ``swarm_fraction=1`` this reproduces ``SwarmSim``
                        exactly.
``selection``           Client-side mirror selection within the tier the
                        tracker hands back: ``"static"`` ranks by
                        ``MirrorSpec.weight``; ``"least_loaded"`` by live
                        admission count (then served bytes); ``"ewma"`` by
                        an EWMA of observed per-flow throughput (seeded
                        optimistically from ``MirrorSpec.up_bps``).
``hedge``               Client-side mirror hedging (default **off**): in the
                        download tail, duplicate each range request to the
                        next ranked mirror; first verified arrival wins, the
                        loser is cancelled and its bytes ledgered as
                        ``SwarmStats.hedge_cancelled_bytes``.
``hedge_tail_fraction`` Fraction of the piece space counting as the tail
                        (hedging arms once the missing set is this small).
``hedge_delay``         Seconds after the primary request before the hedge
                        duplicate is issued (0 = immediately).
``cache_spillover``     Saturated pod caches (admission rejections) spill
                        clients over to the ranked mirror tier instead of
                        backing off (default off).
``fairness``            ``"weighted"``: multi-torrent runs arbitrate every
                        mirror admission across concurrent torrents by
                        manifest weight (scheduler's ``FairShareLedger``;
                        see :mod:`repro_torch.core.scenario`). Default ``"none"``.
======================  =====================================================

Mirror/cache deployment knobs (:class:`MirrorSpec` / ``add_pod_caches``):

======================  =====================================================
``MirrorSpec.up_bps``   This mirror's uplink capacity (divergent mirrors
                        are the point of the fabric).
``MirrorSpec.latency_s``  Added delay before each range request's bytes
                        start flowing (a far mirror loses to a near one at
                        equal bandwidth).
``MirrorSpec.weight``   Static selection weight (highest first).
``MirrorSpec.max_concurrent``  Per-mirror admission cap override.
``add_pod_caches(up_bps, down_bps)``  Per-pod cache proxy uplink (serving
                        the pod) and downlink (absorbing spine fills).
======================  =====================================================
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from .metainfo import MetaInfo
from .netsim import Flow
from .peer import PeerAgent
from .scheduler import (  # noqa: F401  (re-exported: historical home)
    ClientView,
    OriginPolicy,
    TransferScheduler,
    spec_from_dict,
    spec_to_dict,
    swarm_routed_mask,
)
from .swarm import SwarmConfig, SwarmSim
from .topology import ClusterTopology

# --------------------------------------------------------------------------- specs


@dataclasses.dataclass
class MirrorSpec:
    """Deployment description of one mirror in the origin tier."""

    name: str
    up_bps: float
    down_bps: float = 1.0
    latency_s: float = 0.0
    weight: float = 1.0
    max_concurrent: Optional[int] = None   # None => policy.max_concurrent

    def __post_init__(self) -> None:
        if not self.name or not isinstance(self.name, str):
            raise ValueError("mirror name must be a non-empty string")
        if self.up_bps <= 0:
            raise ValueError(f"mirror {self.name!r}: up_bps must be positive")
        if self.down_bps <= 0:
            raise ValueError(f"mirror {self.name!r}: down_bps must be positive")
        if self.latency_s < 0:
            raise ValueError(f"mirror {self.name!r}: latency_s must be >= 0")
        if self.weight <= 0:
            raise ValueError(f"mirror {self.name!r}: weight must be positive")
        if self.max_concurrent is not None and self.max_concurrent < 1:
            raise ValueError(
                f"mirror {self.name!r}: max_concurrent must be >= 1 (or None)"
            )

    def to_dict(self) -> dict:
        return spec_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "MirrorSpec":
        """Strict construction: unknown keys raise (a typo must never
        silently deploy a default mirror)."""
        return spec_from_dict(cls, data)


# --------------------------------------------------------------------------- origin


class WebSeedOrigin:
    """HTTP byte-range front-end over an origin piece store.

    Serves raw ranges out of the content-addressed piece store (clients
    verify; the origin is trusted for bytes, not for integrity), enforces
    the admission cap, and keeps the HTTP-egress ledger the tracker splits
    out of Eq. 1. ``store=None`` supports size-only simulation (bytes are
    accounted, none materialize).
    """

    def __init__(
        self,
        metainfo: MetaInfo,
        store: Optional[dict[int, bytes]] = None,
        policy: Optional[OriginPolicy] = None,
        name: str = "origin",
    ):
        self.metainfo = metainfo
        self.store = store
        self.policy = policy or OriginPolicy()
        self.name = name
        # ledger / telemetry
        self.http_uploaded = 0.0
        self.hedge_cancelled = 0.0   # bytes spent on losing hedge duplicates
        self.requests = 0
        self.rejected = 0
        self.active = 0
        self.peak_active = 0
        # fault injection: serve a corrupted range ONCE for these pieces,
        # then heal — exercises client-side verify + re-fetch
        self.corrupt_once: set[int] = set()

    # ------------------------------------------------------------- admission
    def try_admit(self) -> bool:
        """Admit one range request, or reject (client backs off)."""
        self.requests += 1
        if self.active >= self.policy.max_concurrent:
            self.rejected += 1
            return False
        self.active += 1
        self.peak_active = max(self.peak_active, self.active)
        return True

    def release(self) -> None:
        self.active = max(0, self.active - 1)

    # ------------------------------------------------------------- range reads
    def read_range(self, start: int, end: int) -> Optional[bytes]:
        """Raw bytes [start, end) assembled from the piece store, or None
        when the store is size-only or a covering piece is absent."""
        if self.store is None:
            return None
        if not 0 <= start <= end <= self.metainfo.length:
            raise ValueError(f"range [{start}, {end}) out of bounds")
        plen = self.metainfo.piece_length
        out = []
        for piece in range(start // plen, -(-end // plen) if end else 0):
            data = self.store.get(piece)
            if data is None:
                return None
            p0, _ = self.metainfo.piece_span(piece)
            out.append(data[max(start - p0, 0):end - p0])
        return b"".join(out)

    def read_piece(self, piece: int) -> Optional[bytes]:
        """One piece via a range request, with egress accounting and the
        corrupt-once fault hook applied."""
        size = self.metainfo.piece_size(piece)
        self.http_uploaded += size  # bytes cross the wire even if rejected later
        data = self.read_range(*self.metainfo.piece_span(piece))
        if data is not None and piece in self.corrupt_once:
            self.corrupt_once.discard(piece)
            data = bytes([data[0] ^ 0xFF]) + data[1:]
        return data


class PodCacheOrigin(WebSeedOrigin):
    """Per-pod web-seed proxy: serves its pod, lazily fills from mirrors.

    The cache is itself a :class:`WebSeedOrigin` (admission, egress ledger,
    corrupt-once hook), plus a possession mask (``have``) decoupled from the
    payload store so size-only simulations work, a fill ledger, and the
    in-flight fill bookkeeping the time-domain engine coalesces concurrent
    misses through (one spine fill per piece, however many pod clients are
    waiting on it).
    """

    def __init__(
        self,
        metainfo: MetaInfo,
        pod: int,
        policy: Optional[OriginPolicy] = None,
        name: Optional[str] = None,
    ):
        super().__init__(
            metainfo, store={}, policy=policy, name=name or f"cache/pod{pod}"
        )
        self.pod = pod
        self.node = None               # netsim node, attached by the driver
        self.have = np.zeros(metainfo.num_pieces, dtype=bool)
        self.fill_downloaded = 0.0     # bytes pulled from the mirror tier
        self.fill_wasted = 0.0         # fill bytes that failed verification
        # time-domain fill state
        self.filling: dict[int, list[str]] = {}   # piece -> waiting clients
        self.fill_from: dict[int, str] = {}       # piece -> mirror mid-fill
        self.bad_mirrors: dict[int, set[str]] = {}  # piece -> excluded mirrors

    def holds(self, piece: int) -> bool:
        return bool(self.have[piece])

    def commit(self, piece: int, data: Optional[bytes]) -> None:
        """Record a verified (or size-only) fill from the mirror tier."""
        self.have[piece] = True
        self.fill_downloaded += self.metainfo.piece_size(piece)
        if data is not None and self.store is not None:
            self.store[piece] = data

    def evict(self, piece: int) -> None:
        """Drop one replica (read-repair traced a verify failure to this
        cache); the next miss re-fills it from the mirror tier."""
        self.have[piece] = False
        if self.store is not None:
            self.store.pop(piece, None)


# --------------------------------------------------------------------------- origin set


class OriginSet:
    """The mirror tier: N web-seed origins + client-side selection policy.

    Mirrors replicate the same content (each wraps a piece store holding
    the full bundle) but diverge in bandwidth, latency, weight, and
    admission caps. ``ranked`` orders live mirrors by the policy's
    ``selection`` mode; ``fail``/``heal`` are the fault hooks the failover
    paths key off. A set with one mirror and no caches degenerates exactly
    to the single hard-wired origin it replaced.
    """

    def __init__(
        self,
        metainfo: MetaInfo,
        policy: Optional[OriginPolicy] = None,
        mirrors: Iterable[MirrorSpec] = (),
        store: Optional[dict[int, bytes]] = None,
    ):
        self.metainfo = metainfo
        self.policy = policy or OriginPolicy()
        self.specs: dict[str, MirrorSpec] = {}
        self.origins: dict[str, WebSeedOrigin] = {}
        self.failed: set[str] = set()
        self._ewma_bps: dict[str, float] = {}
        for spec in mirrors:
            self.add_mirror(spec, store=store)

    def add_mirror(
        self, spec: MirrorSpec, store: Optional[dict[int, bytes]] = None
    ) -> WebSeedOrigin:
        if spec.name in self.origins:
            raise ValueError(f"duplicate mirror {spec.name!r}")
        pol = self.policy
        if spec.max_concurrent is not None:
            pol = dataclasses.replace(pol, max_concurrent=spec.max_concurrent)
        origin = WebSeedOrigin(
            self.metainfo, store=store, policy=pol, name=spec.name
        )
        self.specs[spec.name] = spec
        self.origins[spec.name] = origin
        self._ewma_bps[spec.name] = spec.up_bps  # optimistic start
        return origin

    def __len__(self) -> int:
        return len(self.origins)

    @property
    def primary(self) -> WebSeedOrigin:
        """First mirror added — the back-compat single ``web_origin``."""
        return next(iter(self.origins.values()))

    # ------------------------------------------------------------- faults
    def fail(self, name: str) -> None:
        if name not in self.origins:
            raise KeyError(name)
        self.failed.add(name)

    def heal(self, name: str) -> None:
        self.failed.discard(name)

    def live(self) -> list[str]:
        return [n for n in self.origins if n not in self.failed]

    # ------------------------------------------------------------- selection
    def observe(self, name: str, nbytes: float, elapsed: float) -> None:
        """Fold one completed range flow into the mirror's throughput EWMA."""
        if elapsed <= 0 or name not in self._ewma_bps:
            return
        alpha = 0.3
        self._ewma_bps[name] = (
            (1 - alpha) * self._ewma_bps[name] + alpha * (nbytes / elapsed)
        )

    def ranked(self, names: Optional[Iterable[str]] = None) -> list[str]:
        """Live mirrors ordered by the policy's ``selection`` mode.

        ``names`` restricts (and is typically supplied by) the tracker's
        ``mirror_list``; ordering here is purely client-side.
        """
        cands = [
            n for n in (self.origins if names is None else names)
            if n in self.origins and n not in self.failed
        ]
        sel = self.policy.selection
        if sel == "least_loaded":
            key = lambda n: (
                self.origins[n].active,
                self.origins[n].http_uploaded,
                -self.specs[n].weight,
                n,
            )
        elif sel == "ewma":
            key = lambda n: (-self._ewma_bps[n], n)
        else:  # static weights
            key = lambda n: (-self.specs[n].weight, n)
        return sorted(cands, key=key)

    # ------------------------------------------------------------- telemetry
    @property
    def http_uploaded(self) -> float:
        """Aggregate mirror-tier HTTP egress (direct serves + cache fills)."""
        return sum(o.http_uploaded for o in self.origins.values())


# --------------------------------------------------------------------------- time-domain engine


class WebSeedSwarmSim(SwarmSim):
    """Time-domain hybrid: an origin fabric + swarm over one fluid network.

    Call :meth:`add_web_origin` (single mirror, the PR-1 surface) or
    :meth:`add_mirrors` instead of ``add_origin``; optionally
    :meth:`add_pod_caches`; everything else (``add_peers``, ``run``) is
    inherited. Per piece request the routing mask + policy mode decide
    origin-vs-peer; HTTP range flows contend with peer flows for each
    mirror's uplink, and with every cross-pod flow for the spine.
    """

    def __init__(
        self,
        metainfo: MetaInfo,
        policy: Optional[OriginPolicy] = None,
        cfg: Optional[SwarmConfig] = None,
        seed: int = 0,
        topology: Optional[ClusterTopology] = None,
        origin_payload: Optional[dict[int, bytes]] = None,
        same_pod_frac: float = 1.0,
        *,
        net=None,
        tracker=None,
        shared_nodes: Optional[dict] = None,
        torrent: Optional[str] = None,
        fair_share=None,
        telemetry=None,
    ):
        """``net``/``tracker``/``shared_nodes`` wire this torrent into a
        multi-torrent fabric (one fluid network; mirror *nodes* shared so
        every torrent's range flows contend on the same physical uplinks);
        ``torrent``/``fair_share`` identify it to the cross-torrent
        admission arbiter. ``telemetry`` is a (possibly shared) flight
        recorder. All default to the single-torrent behaviour."""
        super().__init__(
            metainfo, cfg, seed, topology=topology,
            origin_payload=origin_payload, same_pod_frac=same_pod_frac,
            net=net, tracker=tracker, telemetry=telemetry,
        )
        self.policy = policy or OriginPolicy()
        self.origin_set = OriginSet(metainfo, policy=self.policy)
        self._shared_nodes = shared_nodes or {}
        # replace the peer-only scheduler the base engine built: HTTP piece
        # choice, ranked-origin choice, failover/backoff bookkeeping, and
        # hedging all live in the unified core
        self.scheduler = TransferScheduler(
            metainfo, self.policy, endgame=self.cfg.endgame,
            origin_set=self.origin_set,
            torrent=torrent, fair_share=fair_share,
        )
        self.scheduler.telemetry = self.telemetry
        self.caches: dict[int, PodCacheOrigin] = {}
        self._cache_by_name: dict[str, PodCacheOrigin] = {}
        self.origin_id: Optional[str] = None      # primary mirror (back-compat)
        self._http_outstanding: dict[str, int] = {}
        # mirrors healed while the tracker was dark: their re-register
        # announce is queued for the tracker heal
        self._dark_healed_mirrors: list[str] = []

    # ------------------------------------------------------------- tracker outages
    def tracker_heal(self, now: float) -> None:
        super().tracker_heal(now)
        for name in self._dark_healed_mirrors:
            if name not in self.origin_set.origins:
                continue
            agent = self.agents.get(name)
            if agent is None or agent.departed:
                continue  # failed again while dark; its fail was queued too
            mirror = self.origin_set.origins[name]
            self.tracker.announce(
                self.metainfo, name,
                uploaded=agent.ledger.uploaded,
                downloaded=0.0, event="started", now=now,
                is_origin=True, is_web_seed=True,
                http_uploaded=mirror.http_uploaded,
                hedge_cancelled=mirror.hedge_cancelled,
            )
        self._dark_healed_mirrors.clear()

    @property
    def web_origin(self) -> Optional[WebSeedOrigin]:
        """The primary mirror's HTTP front-end (single-origin back-compat)."""
        return self.origin_set.primary if len(self.origin_set) else None

    # ------------------------------------------------------------- membership
    def _new_agent(self, peer_id: str, is_origin: bool) -> PeerAgent:
        agent = super()._new_agent(peer_id, is_origin)
        if not is_origin:
            agent.want_mask = self.scheduler.swarm_routed
        return agent

    def add_web_origin(
        self, name: str = "origin", down_bps: float = 1.0
    ) -> PeerAgent:
        """Attach a single hybrid origin — the PR-1 surface, now one mirror."""
        return self.add_mirror(
            MirrorSpec(name, up_bps=self.policy.origin_up_bps,
                       down_bps=down_bps)
        )

    def add_mirror(self, spec: MirrorSpec) -> PeerAgent:
        """Attach one mirror: a netsim node whose uplink serves HTTP range
        flows, cache fills, and (optionally) peer-protocol flows. In a
        multi-torrent fabric the node comes from ``shared_nodes`` — one
        physical box whose uplink every torrent's flows contend on."""
        pol = self.policy
        agent = self._new_agent(spec.name, is_origin=True)
        agent.node = self._shared_nodes.get(spec.name) or self.net.add_node(
            spec.name, spec.up_bps, spec.down_bps
        )
        if self.origin_id is None:
            self.origin_id = spec.name
        self.origin_set.add_mirror(spec, store=agent.store)
        self.tracker.announce(
            self.metainfo, spec.name, uploaded=0, downloaded=0,
            event="started", now=self.net.now, is_origin=True,
            is_web_seed=True, peer_protocol=pol.serve_peer_protocol,
        )
        self.tracker.attach_bitfield(self.metainfo, spec.name, agent.bitfield)
        return agent

    def add_mirrors(self, specs: Sequence[MirrorSpec]) -> list[PeerAgent]:
        return [self.add_mirror(s) for s in specs]

    def add_pod_caches(
        self,
        up_bps: float,
        down_bps: Optional[float] = None,
        max_concurrent: Optional[int] = None,
    ) -> list[PodCacheOrigin]:
        """Attach one cache proxy per pod of the topology: a netsim node
        that serves its pod over leaf links and fills from the mirror tier
        over the spine. Must run before peers arrive — the cache tier
        shapes the tracker peer lists pod-local. ``max_concurrent``
        overrides the policy's admission cap per cache (capacity-planning
        sweeps pair it with ``OriginPolicy.cache_spillover``)."""
        if self.topology is None:
            raise ValueError("pod caches require a ClusterTopology")
        if self._pending_arrivals > 0 or any(
            not a.is_origin for a in self.agents.values()
        ):
            raise ValueError(
                "add_pod_caches must be called before peers are added: "
                "already-arrived peers keep their cross-pod connections "
                "and would trade around the cache tier"
            )
        out = []
        cache_policy = self.policy
        if max_concurrent is not None:
            cache_policy = dataclasses.replace(
                self.policy, max_concurrent=max_concurrent
            )
        for pod in range(self.topology.num_pods):
            if pod in self.caches:
                raise ValueError(f"pod {pod} already has a cache")
            cache = PodCacheOrigin(self.metainfo, pod, policy=cache_policy)
            cache.node = self.net.add_node(
                cache.name, up_bps, down_bps if down_bps is not None else up_bps
            )
            self.caches[pod] = cache
            self._cache_by_name[cache.name] = cache
            self._pod_of[cache.name] = pod
            self.tracker.announce(
                self.metainfo, cache.name, uploaded=0, downloaded=0,
                event="started", now=self.net.now, is_web_seed=True,
                peer_protocol=False, tier="pod_cache", pod=pod,
            )
            out.append(cache)
        return out

    # ------------------------------------------------------------- faults
    def fail_mirror(self, name: str) -> None:
        """Hard-kill a mirror mid-swarm: its flows (range serves and cache
        fills) abort and clients/caches fail over to the next ranked
        mirror; the tracker stops handing it out."""
        if name not in self.origin_set.origins:
            raise KeyError(f"unknown mirror {name!r}")
        if self.telemetry.enabled:
            # before the flow aborts: the trace reads fail -> failovers
            self.telemetry.emit(
                "mirror_fail", t=self.net.now, torrent=self.metainfo.name,
                origin=name,
            )
        self.scheduler.on_origin_dead(name)
        agent = self.agents.get(name)
        if agent is not None and not agent.departed:
            self._depart(agent, self.net.now)

    def heal_mirror(self, name: str) -> None:
        """Bring a failed mirror back: its node serves HTTP range requests
        again, the tracker hands it out, and ranked selection re-includes
        it. Peer-protocol connections are *not* re-formed — a healed box
        rejoins as a bare web seed (the HTTP tier is what failover and the
        scenario event timeline exercise)."""
        if name not in self.origin_set.origins:
            raise KeyError(f"unknown mirror {name!r}")
        if self.telemetry.enabled:
            self.telemetry.emit(
                "mirror_heal", t=self.net.now, torrent=self.metainfo.name,
                origin=name,
            )
        self.origin_set.heal(name)
        agent = self.agents.get(name)
        if agent is not None:
            agent.departed = False
            if agent.node is not None:
                agent.node.failed = False
        if self.tracker.failed:
            # the re-register announce can't land: queue it for the heal
            self._dark_healed_mirrors.append(name)
            return
        mirror = self.origin_set.origins[name]
        self.tracker.announce(
            self.metainfo, name,
            uploaded=agent.ledger.uploaded if agent else 0.0,
            downloaded=0.0, event="started", now=self.net.now,
            is_origin=True, is_web_seed=True,
            http_uploaded=mirror.http_uploaded,
            hedge_cancelled=mirror.hedge_cancelled,
        )

    def fail_pod(self, pod: int, now: Optional[float] = None) -> list[str]:
        """Correlated loss of a whole pod: the pod cache dies with its
        contents and every peer homed in the pod departs (sorted order,
        deterministic). Returns the departed peer ids."""
        if now is None:
            now = self.net.now
        cache = self.caches.get(pod)
        if cache is not None and not cache.node.failed:
            self.net.fail_node(cache.node)
            cache.have[:] = False
            if cache.store is not None:
                cache.store.clear()
            if self.tracker.failed:
                self._dark_departed.append(cache.name)
            else:
                self.tracker.announce(
                    self.metainfo, cache.name, uploaded=0.0,
                    downloaded=cache.fill_downloaded, event="stopped",
                    now=now, http_uploaded=cache.http_uploaded,
                    tier="pod_cache", pod=pod,
                )
        victims = sorted(
            pid for pid, a in self.agents.items()
            if not a.is_origin and not a.departed and self._pod(pid) == pod
        )
        for pid in victims:
            self.fail_peer(pid)
        return victims

    # ------------------------------------------------------------- repair
    def repair_fetch(self, piece: int, now: float) -> Optional[str]:
        """Repair-controller hook: start one re-seed of ``piece``.

        Destination: first (sorted) live non-origin client lacking the
        piece with nothing in flight for it. Source tier preference
        follows the durability ladder — ranked live mirrors, then the
        destination's pod cache when it already holds the piece, then a
        live peer replica — all priced through the normal admission path
        so repair traffic contends fairly with foreground transfers."""
        dst = self._repair_dst(piece)
        if dst is None:
            return None
        targets: list[WebSeedOrigin] = list(self.scheduler.ranked_origins(
            dst.peer_id,
            names=self._reachable_names_from(
                dst.peer_id,
                self.tracker.mirror_list(self.metainfo, dst.peer_id),
            ),
            live=self._origin_live,
        ))
        cache = self._live_cache(dst)
        if cache is not None and cache.holds(piece):
            targets.append(cache)
        if targets:
            started = self._request_http(dst, piece, targets, now)
            if started:
                return dst.peer_id
        return self._repair_from_peer(dst, piece, now)

    # ------------------------------------------------------------- scheduling
    def _filter_peer_list(self, agent: PeerAgent, peer_list: list[str]) -> list[str]:
        """With a cache tier, the peer mesh goes pod-local: the cache is the
        pod's doorway to the rest of the fabric, so cross-pod bytes are fill
        traffic only (attach caches before peers arrive)."""
        peer_list = super()._filter_peer_list(agent, peer_list)
        if not self.caches:
            return peer_list
        pod = self._pod(agent.peer_id)
        return [p for p in peer_list if self._pod(p) == pod]

    def _launch(self, agent: PeerAgent, now: float) -> None:
        super()._launch(agent, now)  # peer path (mask-constrained)
        if len(self.origin_set):
            self._launch_http(agent, now)

    def _origin_live(self, name: str) -> bool:
        """Scheduler liveness predicate: the mirror's netsim node is up."""
        magent = self.agents.get(name)
        return (
            magent is not None and magent.node is not None
            and not magent.node.failed
        )

    def _live_cache(self, agent: PeerAgent) -> Optional["PodCacheOrigin"]:
        """This client's pod cache, when one exists and its node is up."""
        if not self.caches:
            return None
        cache = self.caches.get(self._pod(agent.peer_id))
        if cache is not None and not cache.node.failed:
            return cache
        return None

    def _client_view(self, agent: PeerAgent, slots: int) -> ClientView:
        cache = self._live_cache(agent)
        # a live cache with spillover off is the pod's only endpoint: skip
        # the tracker discovery scan its ranking would never consult
        names = None
        if cache is None or self.policy.cache_spillover:
            names = self._reachable_names_from(
                agent.peer_id,
                self.tracker.mirror_list(self.metainfo, agent.peer_id),
            )
        return ClientView(
            agent=agent,
            peer_path=False,
            http_slots=slots,
            cache=cache,
            mirror_names=names,
            origin_live=self._origin_live,
            availability=self._serviceable_availability(agent),
        )

    def _launch_http(self, agent: PeerAgent, now: float) -> None:
        """Drive the scheduler's HTTP decisions: one request per iteration
        (admission outcomes feed back into the next piece choice), until
        the pipeline is full, nothing is eligible, or everything rejected
        (back off and retry)."""
        pol = self.policy
        if (
            agent.departed or agent.node is None or agent.is_seed
            or agent.peer_id in self.origin_set.origins
        ):
            return
        view = None
        while True:
            slots = pol.http_pipeline - self._http_outstanding.get(
                agent.peer_id, 0
            )
            if slots <= 0:
                return
            if view is None:   # discovery/ranking computed once per launch
                view = self._client_view(agent, slots)
            view.http_slots = slots
            req = next(
                (a for a in self.scheduler.next_actions(view)
                 if a.kind == "http"),
                None,
            )
            if req is None:
                return
            started = self._request_http(agent, req.piece, req.targets, now)
            if started is None:      # permanently unservable right now
                return
            if not started:          # everyone rejected: back off and retry
                self._schedule_retry(agent, now)
                return

    def _request_http(
        self,
        agent: PeerAgent,
        piece: int,
        targets: Sequence[WebSeedOrigin],
        now: float,
    ) -> Optional[bool]:
        """Route one range request to the first endpoint that admits it.

        Returns True when a flow (or queued cache fill) is under way, False
        when every endpoint rejected the request (caller backs off), None
        when nothing can serve it at all (dead mirror tier — no retry)."""
        bad = self.scheduler.bad_origins(agent.peer_id, piece)
        servable = False
        for origin in targets:
            if origin.name in bad:
                continue
            servable = True
            size = float(self.metainfo.piece_size(piece))
            if isinstance(origin, PodCacheOrigin):
                if not origin.try_admit():
                    if self.telemetry.enabled:
                        self.telemetry.emit(
                            "admission_deferred", t=now,
                            torrent=self.metainfo.name,
                            client=agent.peer_id, origin=origin.name,
                            piece=piece, nbytes=size, info="capacity",
                        )
                        if self.policy.cache_spillover:
                            self.telemetry.emit(
                                "cache_spill", t=now,
                                torrent=self.metainfo.name,
                                client=agent.peer_id, origin=origin.name,
                                piece=piece, nbytes=size,
                            )
                    continue
                if not origin.holds(piece) and piece not in origin.fill_from:
                    if not self._start_fill(origin, piece, now):
                        # dead mirror tier: nothing to fill from
                        origin.release()
                        return None
                src_tag = f"{origin.name}::http"
                agent.in_flight[piece] = src_tag
                self._http_outstanding[agent.peer_id] = (
                    self._http_outstanding.get(agent.peer_id, 0) + 1
                )
                if self.telemetry.enabled:
                    self.telemetry.emit(
                        "request_issued", t=now, torrent=self.metainfo.name,
                        client=agent.peer_id, origin=origin.name,
                        piece=piece, nbytes=size, info="http",
                    )
                if origin.holds(piece):
                    self._start_http_flow(origin, agent, piece, now)
                else:
                    origin.filling.setdefault(piece, []).append(agent.peer_id)
                return True
            if not self.scheduler.try_admit(
                origin, self.metainfo.piece_size(piece)
            ):
                continue
            agent.in_flight[piece] = f"{origin.name}::http"
            self._http_outstanding[agent.peer_id] = (
                self._http_outstanding.get(agent.peer_id, 0) + 1
            )
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "request_issued", t=now, torrent=self.metainfo.name,
                    client=agent.peer_id, origin=origin.name, piece=piece,
                    nbytes=size, info="http",
                )
            self._start_http_flow(origin, agent, piece, now)
            hedge = self.scheduler.plan_hedge(agent, piece, origin, targets)
            if hedge is not None:
                self._schedule_hedge(agent, piece, origin, hedge, now)
            return True
        if not servable and targets and bad:
            # every live endpoint previously served bad bytes for this
            # piece: heal the exclusions (corrupt-once origins recover) and
            # retry after the backoff instead of giving up
            self.scheduler.heal_bad(agent.peer_id, piece)
            return False
        return False if servable else None

    def _finish_http_request(
        self, origin: WebSeedOrigin, dst_id: str, piece: int
    ) -> Optional[PeerAgent]:
        """Tear down one admitted range request: free the origin's admission
        slot and the client's pipeline slot (the paired invariant every HTTP
        path must maintain). Returns the client agent, if it still exists;
        the caller owns any in-flight cleanup and relaunch."""
        origin.release()
        self._http_outstanding[dst_id] = max(
            0, self._http_outstanding.get(dst_id, 0) - 1
        )
        return self.agents.get(dst_id)

    def _start_http_flow(
        self,
        origin: WebSeedOrigin,
        agent: PeerAgent,
        piece: int,
        now: float,
        expect: Optional[str] = None,
    ) -> None:
        """Start the serving flow origin->client (honoring mirror latency).

        ``expect`` is the in-flight tag that must still be current for the
        flow to be worth starting — the flow's own tag by default; a hedge
        duplicate instead expects its *primary's* tag (the hedge rides
        alongside, it never owns the in-flight slot)."""
        src_tag = f"{origin.name}::http"
        if expect is None:
            expect = src_tag
        cache = self._cache_by_name.get(origin.name)
        src_node = cache.node if cache is not None \
            else self.agents[origin.name].node
        spec = self.origin_set.specs.get(origin.name)
        latency = spec.latency_s if spec is not None else 0.0

        def _start(t: float) -> None:
            dst = self.agents.get(agent.peer_id)
            if (
                dst is None or dst.departed or src_node.failed
                or not self.net.reachable_names(src_node.name, agent.peer_id)
                or dst.in_flight.get(piece) != expect
            ):
                # endpoint vanished (or was partitioned away) during the
                # latency window
                dst = self._finish_http_request(origin, agent.peer_id, piece)
                self.scheduler.hedge_loser(agent.peer_id, piece, origin.name)
                if dst is not None and dst.in_flight.get(piece) == src_tag:
                    del dst.in_flight[piece]
                if dst is not None and not dst.departed:
                    self._launch(dst, t)
                return
            self.net.start_flow(
                src_node,
                dst.node,
                self.metainfo.piece_size(piece),
                tag=(src_tag, dst.peer_id, piece),
                on_complete=self._on_http_done,
                on_abort=self._on_http_abort,
                links=self._links_between(origin.name, dst.peer_id),
            )

        if latency > 0:
            self.net.schedule(now + latency, _start)
        else:
            _start(now)

    # ------------------------------------------------------------- hedging
    def _schedule_hedge(
        self,
        agent: PeerAgent,
        piece: int,
        primary: WebSeedOrigin,
        hedge: WebSeedOrigin,
        now: float,
    ) -> None:
        """Arm the tail-latency insurance: after ``hedge_delay``, duplicate
        the range request to the next ranked mirror. The duplicate takes an
        admission slot and a pipeline slot like any request (insurance is
        not free) but never retries — if the hedge mirror rejects or died,
        the primary simply runs unhedged."""
        primary_tag = f"{primary.name}::http"

        def _fire(t: float) -> None:
            dst = self.agents.get(agent.peer_id)
            if (
                dst is None or dst.departed or dst.bitfield.has(piece)
                or dst.in_flight.get(piece) != primary_tag
            ):
                return                       # primary already resolved
            if not self._origin_live(hedge.name) \
                    or not self.net.reachable_names(dst.peer_id, hedge.name):
                return
            if not self.scheduler.try_admit(
                hedge, self.metainfo.piece_size(piece)
            ):
                return                       # hedge mirror busy: no insurance
            self.scheduler.register_hedge(
                dst.peer_id, piece, primary.name, hedge.name
            )
            self._http_outstanding[dst.peer_id] = (
                self._http_outstanding.get(dst.peer_id, 0) + 1
            )
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "hedge_fired", t=t, torrent=self.metainfo.name,
                    client=dst.peer_id, origin=hedge.name, piece=piece,
                    nbytes=float(self.metainfo.piece_size(piece)),
                )
            self._start_http_flow(hedge, dst, piece, t, expect=primary_tag)

        if self.policy.hedge_delay > 0:
            self.net.schedule(now + self.policy.hedge_delay, _fire)
        else:
            _fire(now)

    # ------------------------------------------------------------- cache fills
    def _schedule_fill_backoff(
        self, cache: PodCacheOrigin, piece: int, now: float
    ) -> None:
        """Park the fill behind a ``<backoff>`` sentinel and retry later."""
        def _retry(t: float) -> None:
            if cache.fill_from.get(piece) == "<backoff>":
                del cache.fill_from[piece]
            if piece in cache.filling and piece not in cache.fill_from \
                    and not cache.holds(piece):
                if not self._start_fill(cache, piece, t):
                    self._drop_fill_waiters(cache, piece, t)

        self.net.schedule(now + self.policy.backoff, _retry)
        cache.fill_from[piece] = "<backoff>"

    def _start_fill(
        self, cache: PodCacheOrigin, piece: int, now: float
    ) -> bool:
        """Start (or restart after failover) the spine fill for one piece.

        Returns False only when the live mirror tier is empty (or the
        cache itself died: a failed pod's cache must not start fills);
        admission rejections — and the corner where every live mirror has
        served bad bytes for this piece (exclusions heal: corrupt-once
        recovers) — are retried after the policy backoff."""
        if cache.node is not None and cache.node.failed:
            return False
        live = [
            (o.name, self.agents[o.name])
            for o in self.scheduler.ranked_origins(
                cache.name,
                names=self._reachable_names_from(
                    cache.name,
                    self.tracker.mirror_list(self.metainfo, cache.name),
                ),
                live=self._origin_live,
            )
        ]
        if not live:
            return False
        excluded = cache.bad_mirrors.get(piece, set())
        usable = [(n, a) for n, a in live if n not in excluded]
        if not usable:
            # every live mirror is excluded for this piece: heal and retry
            cache.bad_mirrors.pop(piece, None)
            self._schedule_fill_backoff(cache, piece, now)
            return True
        for name, magent in usable:
            mirror = self.origin_set.origins[name]
            size = self.metainfo.piece_size(piece)
            if not self.scheduler.try_admit(mirror, size):
                continue
            cache.fill_from[piece] = name
            spec = self.origin_set.specs[name]
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "request_issued", t=now, torrent=self.metainfo.name,
                    client=cache.name, origin=name, piece=piece,
                    nbytes=float(size), info="fill",
                )

            def _start(t: float, name=name, magent=magent, mirror=mirror) -> None:
                if cache.node.failed:
                    # the pod died during the mirror's latency window
                    mirror.release()
                    cache.fill_from.pop(piece, None)
                    return
                if magent.node.failed \
                        or not self.net.reachable_names(name, cache.name):
                    mirror.release()
                    cache.fill_from.pop(piece, None)
                    if self.telemetry.enabled:
                        self.telemetry.emit(
                            "mirror_failover", t=t,
                            torrent=self.metainfo.name, client=cache.name,
                            origin=name, piece=piece, info="death",
                        )
                    if piece in cache.filling and \
                            not self._start_fill(cache, piece, t):
                        self._drop_fill_waiters(cache, piece, t)
                    return
                self.net.start_flow(
                    magent.node,
                    cache.node,
                    size,
                    tag=(f"{name}::fill", cache.name, piece),
                    on_complete=self._on_fill_done,
                    on_abort=self._on_fill_abort,
                    links=self._links_between(name, cache.name),
                )

            if spec.latency_s > 0:
                self.net.schedule(now + spec.latency_s, _start)
            else:
                _start(now)
            return True
        # all mirrors alive but busy: retry the fill after the backoff
        self._schedule_fill_backoff(cache, piece, now)
        return True

    def _drop_fill_waiters(
        self, cache: PodCacheOrigin, piece: int, now: float
    ) -> None:
        """The mirror tier died under a fill: release the pod's waiters so
        they can finish through the peer path."""
        cache.fill_from.pop(piece, None)
        src_tag = f"{cache.name}::http"
        for dst_id in cache.filling.pop(piece, []):
            dst = self._finish_http_request(cache, dst_id, piece)
            if self.repair is not None:
                self.repair.note_failed(dst_id, piece)
            if dst is None or dst.departed:
                continue
            if dst.in_flight.get(piece) == src_tag:
                del dst.in_flight[piece]
            self._launch(dst, now)

    def _on_fill_done(self, flow: Flow, now: float) -> None:
        src_tag, cache_name, piece = flow.tag
        mname = src_tag.rsplit("::", 1)[0]
        mirror = self.origin_set.origins[mname]
        cache = self._cache_by_name[cache_name]
        mirror.release()
        cache.fill_from.pop(piece, None)
        data = mirror.read_piece(piece)   # mirror egress ledger + fault hook
        self.origin_set.observe(mname, flow.size, now - flow.start_time)
        self._announce_mirror(mname, now)
        if data is not None and not self.metainfo.verify_piece(piece, data):
            # bad bytes from this mirror: exclude it for this piece and
            # re-fetch from the next ranked mirror (verified failover)
            cache.fill_wasted += self.metainfo.piece_size(piece)
            cache.bad_mirrors.setdefault(piece, set()).add(mname)
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "mirror_failover", t=now, torrent=self.metainfo.name,
                    client=cache.name, origin=mname, piece=piece,
                    info="verify",
                )
            if piece in cache.filling and \
                    not self._start_fill(cache, piece, now):
                self._drop_fill_waiters(cache, piece, now)
            return
        cache.commit(piece, data)
        if self.telemetry.enabled:
            self.telemetry.emit(
                "cache_fill", t=now, torrent=self.metainfo.name,
                client=cache.name, origin=mname, piece=piece,
                nbytes=float(flow.size),
            )
        self._announce_cache(cache, now)
        for dst_id in cache.filling.pop(piece, []):
            self._serve_from_cache(cache, dst_id, piece, now)

    def _on_fill_abort(self, flow: Flow, now: float) -> None:
        src_tag, cache_name, piece = flow.tag
        mname = src_tag.rsplit("::", 1)[0]
        self.origin_set.origins[mname].release()
        cache = self._cache_by_name[cache_name]
        cache.fill_from.pop(piece, None)
        if cache.holds(piece) or piece not in cache.filling:
            return
        if self.telemetry.enabled:
            magent = self.agents.get(mname)
            if magent is not None and magent.node is not None \
                    and magent.node.failed:
                self.telemetry.emit(
                    "mirror_failover", t=now, torrent=self.metainfo.name,
                    client=cache.name, origin=mname, piece=piece,
                    info="death",
                )
        if not self._start_fill(cache, piece, now):
            self._drop_fill_waiters(cache, piece, now)

    def _serve_from_cache(
        self, cache: PodCacheOrigin, dst_id: str, piece: int, now: float
    ) -> None:
        src_tag = f"{cache.name}::http"
        dst = self.agents.get(dst_id)
        if dst is None or dst.departed:
            self._finish_http_request(cache, dst_id, piece)
            return
        if dst.bitfield.has(piece) or dst.in_flight.get(piece) != src_tag:
            # the peer path delivered it while the fill was in flight
            self._finish_http_request(cache, dst_id, piece)
            if dst.in_flight.get(piece) == src_tag:
                del dst.in_flight[piece]
            self._launch(dst, now)
            return
        self._start_http_flow(cache, dst, piece, now)

    # ------------------------------------------------------------- retries
    def _schedule_retry(self, agent: PeerAgent, now: float) -> None:
        if not self.scheduler.schedule_backoff(agent.peer_id):
            return
        if self.telemetry.enabled:
            self.telemetry.emit(
                "retry", t=now, torrent=self.metainfo.name,
                client=agent.peer_id, value=self.policy.backoff,
            )

        def _retry(t: float, a: PeerAgent = agent) -> None:
            self.scheduler.backoff_fired(a.peer_id)
            if not a.departed:
                self._launch_http(a, t)

        self.net.schedule(now + self.policy.backoff, _retry)

    # ------------------------------------------------------------- HTTP events
    def _origin_by_name(self, name: str) -> WebSeedOrigin:
        cache = self._cache_by_name.get(name)
        return cache if cache is not None else self.origin_set.origins[name]

    def _announce_mirror(self, name: str, now: float) -> None:
        if self.tracker.failed:
            return
        magent = self.agents.get(name)
        mirror = self.origin_set.origins[name]
        self.tracker.announce(
            self.metainfo, name,
            uploaded=magent.ledger.uploaded if magent else 0.0,
            downloaded=0.0, event="update", now=now, is_origin=True,
            http_uploaded=mirror.http_uploaded,
            hedge_cancelled=mirror.hedge_cancelled,
        )

    def _announce_cache(self, cache: PodCacheOrigin, now: float) -> None:
        if self.tracker.failed:
            return
        self.tracker.announce(
            self.metainfo, cache.name, uploaded=0.0,
            downloaded=cache.fill_downloaded, event="update", now=now,
            http_uploaded=cache.http_uploaded, tier="pod_cache",
            pod=cache.pod,
        )

    def _on_http_done(self, flow: Flow, now: float) -> None:
        src_tag, dst_id, piece = flow.tag
        name = src_tag.rsplit("::", 1)[0]
        origin = self._origin_by_name(name)
        cache = self._cache_by_name.get(name)
        dst = self._finish_http_request(origin, dst_id, piece)
        was_hedged = self.scheduler.hedge_loser(dst_id, piece, name)
        if dst is None or dst.departed:
            return
        data = origin.read_piece(piece)
        if cache is None:
            self.origin_set.observe(name, flow.size, now - flow.start_time)
        corrupt = (
            self.cfg.corruption_prob > 0
            and self.rng.random() < self.cfg.corruption_prob
        )
        if corrupt and data is not None:
            data = bytes([data[0] ^ 0xFF]) + data[1:]
        owner = dst.in_flight.get(piece)
        accepted = dst.accept_piece(piece, src_tag, data, now, corrupt=corrupt)
        if (
            was_hedged and not accepted
            and not dst.last_reject_verify and dst.bitfield.has(piece)
        ):
            # hedge pair photo-finish: both mirrors delivered in the same
            # tick — the full duplicate is the hedge's cancelled cost
            origin.hedge_cancelled += float(flow.size)
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "hedge_cancelled", t=now, torrent=self.metainfo.name,
                    client=dst_id, origin=name, piece=piece,
                    nbytes=float(flow.size), info="photo_finish",
                )
        if (
            not accepted and owner not in (None, src_tag)
            and piece not in dst.in_flight
            and any(
                f.tag == (owner, dst_id, piece)
                for f in self.net.flows.values()
            )
        ):
            # a rejected duplicate (e.g. a corrupt hedge arriving first)
            # must not steal the slot from the still-running owner flow —
            # otherwise the relaunch below re-requests the piece a third
            # time while the owner is mid-range
            dst.in_flight[piece] = owner
        if cache is not None:
            self._announce_cache(cache, now)
        else:
            self._announce_mirror(name, now)
        # failover bookkeeping: clear exclusions on success, steer the
        # re-fetch (relaunch below) away from endpoints serving bad bytes.
        # the recorded fetch latency includes the mirror's per-request
        # latency penalty (the flow itself only starts after that window)
        spec = self.origin_set.specs.get(name)
        req_latency = (now - flow.start_time) + (
            spec.latency_s if spec is not None else 0.0
        )
        self.scheduler.on_piece_done(
            dst_id, piece, name, accepted=accepted,
            verify_failed=(not corrupt and dst.last_reject_verify),
            latency=req_latency if accepted else None,
        )
        if self.repair is not None:
            if accepted:
                self.repair.note_done(
                    dst_id, piece,
                    "pod_cache" if cache is not None else "origin",
                    float(flow.size), now,
                )
            elif not corrupt and dst.last_reject_verify \
                    and cache is not None:
                # read-repair: the cache's at-rest replica is poisoned —
                # evict it so the next miss refills from a mirror instead
                # of re-serving bad bytes to the whole pod
                cache.evict(piece)
                self.repair.note_evict(name, piece, now)
        if self.telemetry.enabled:
            if accepted:
                self.telemetry.emit(
                    "piece_done", t=now, torrent=self.metainfo.name,
                    client=dst_id, origin=name, piece=piece,
                    nbytes=float(flow.size), info="http",
                )
            else:
                self.telemetry.emit(
                    "piece_failed", t=now, torrent=self.metainfo.name,
                    client=dst_id, origin=name, piece=piece,
                    info="verify" if dst.last_reject_verify else "duplicate",
                )
                if not corrupt and dst.last_reject_verify and cache is None:
                    # this mirror served bad bytes: the relaunch reroutes
                    self.telemetry.emit(
                        "mirror_failover", t=now, torrent=self.metainfo.name,
                        client=dst_id, origin=name, piece=piece,
                        info="verify",
                    )
        if accepted:
            self._on_piece_accepted(dst, piece, now)
        # rejected (corrupt range) pieces are back in the missing set; the
        # relaunch below re-fetches them
        self._launch(dst, now)

    def _on_http_abort(self, flow: Flow, now: float) -> None:
        src_tag, dst_id, piece = flow.tag
        name = src_tag.rsplit("::", 1)[0]
        origin = self._origin_by_name(name)
        dst = self._finish_http_request(origin, dst_id, piece)
        was_hedged = self.scheduler.hedge_loser(dst_id, piece, name)
        if self.repair is not None and (dst is None or not
                                        dst.bitfield.has(piece)):
            self.repair.note_failed(dst_id, piece)
        if dst is None or dst.departed:
            return
        if was_hedged and dst.bitfield.has(piece) and flow.transferred > 0:
            # the losing half of a hedge pair, cancelled mid-range: its
            # partial bytes are the insurance premium, ledgered separately
            origin.hedge_cancelled += flow.transferred
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "hedge_cancelled", t=now, torrent=self.metainfo.name,
                    client=dst_id, origin=name, piece=piece,
                    nbytes=float(flow.transferred), info="mid_range",
                )
            if self._cache_by_name.get(name) is None:
                self._announce_mirror(name, now)
        self.scheduler.on_piece_failed(dst_id, piece)
        if self.telemetry.enabled:
            self.telemetry.emit(
                "piece_failed", t=now, torrent=self.metainfo.name,
                client=dst_id, origin=name, piece=piece, info="abort",
            )
            if self._cache_by_name.get(name) is None \
                    and not dst.bitfield.has(piece):
                magent = self.agents.get(name)
                if magent is not None and magent.node is not None \
                        and magent.node.failed:
                    # the serving mirror died under this range request: the
                    # relaunch below is the client's failover
                    self.telemetry.emit(
                        "mirror_failover", t=now, torrent=self.metainfo.name,
                        client=dst_id, origin=name, piece=piece,
                        info="death",
                    )
        if dst.in_flight.get(piece) == src_tag:
            del dst.in_flight[piece]
            if was_hedged and not dst.bitfield.has(piece):
                # the aborted flow owned the slot but its hedge partner is
                # still mid-range: hand the slot over instead of letting
                # the relaunch fetch the piece a third time (which would
                # also consume the pair's name-keyed entry and leak the
                # eventual loser's bytes out of every ledger)
                partner = self.scheduler.hedge_partner(dst_id, piece)
                if partner is not None and any(
                    f.tag == (f"{partner}::http", dst_id, piece)
                    for f in self.net.flows.values()
                ):
                    dst.in_flight[piece] = f"{partner}::http"
        self._launch(dst, now)
