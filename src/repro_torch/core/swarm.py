"""Swarm drivers.

Two engines share the same piece/choke/selection logic:

* :class:`SwarmSim` — **time-domain**: peers exchange pieces over the fluid
  netsim; produces completion times, origin load, and the tracker ledger
  (Eq. 1 U/D). This is what reproduces Table 1 / Fig. 1 and the cluster
  cold-start benchmarks.
* :class:`LocalSwarm` — **byte-domain**: a round-based engine that actually
  moves verified bytes between in-process stores. This is the functional
  data plane used by ``repro.data.swarm_loader`` to ingest dataset shards
  and by checkpoint broadcast; on a real fleet each agent would live on one
  host, with the same code driving socket transports.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Iterable, Optional, Sequence

import numpy as np

from .choking import ChokerConfig
from .metainfo import MetaInfo
from .netsim import FluidNetwork, Flow
from .peer import Ledger, PeerAgent
from .scheduler import (
    ClientView, TransferScheduler, percentiles, spec_from_dict, spec_to_dict,
)
from .telemetry import NULL_RECORDER, TraceRecorder
from .topology import ClusterTopology
from .tracker import SwarmStats, Tracker

# --------------------------------------------------------------------------- config


@dataclasses.dataclass
class SwarmConfig:
    policy: str = "rarest_first"
    pipeline: int = 8
    per_peer_requests: int = 2
    max_neighbors: int = 40
    choke_interval: float = 10.0
    max_unchoked: int = 4
    optimistic_slots: int = 1
    corruption_prob: float = 0.0   # fault injection: pieces that fail verification
    endgame: bool = True

    def __post_init__(self) -> None:
        from . import piece_selection as ps

        if self.policy not in ps.POLICIES:
            raise ValueError(
                f"unknown selection policy {self.policy!r} "
                f"(valid: {sorted(ps.POLICIES)})"
            )
        for knob in ("pipeline", "per_peer_requests", "max_neighbors",
                     "max_unchoked"):
            if getattr(self, knob) < 1:
                raise ValueError(f"{knob} must be >= 1")
        if self.choke_interval <= 0:
            raise ValueError("choke_interval must be positive")
        if self.optimistic_slots < 0:
            raise ValueError("optimistic_slots must be >= 0")
        if not 0.0 <= self.corruption_prob <= 1.0:
            raise ValueError("corruption_prob must be in [0, 1]")

    def to_dict(self) -> dict:
        return spec_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "SwarmConfig":
        """Strict construction: unknown keys raise (a typo must never
        silently fall back to a default engine config)."""
        return spec_from_dict(cls, data)


@dataclasses.dataclass
class PeerSpec:
    peer_id: str
    arrive_at: float
    up_bps: float
    down_bps: float
    seed_linger: Optional[float] = None  # None => seed forever; 0 => leave at completion


@dataclasses.dataclass
class SwarmResult:
    sim_time: float
    stats: SwarmStats
    completion_time: dict[str, float]       # peer -> (complete - arrive) seconds
    finish_at: dict[str, float]
    ledgers: dict[str, Ledger]
    origin_uploaded: float                  # mirror-tier egress (peer + HTTP)
    total_downloaded: float
    events: int
    origin_http_uploaded: float = 0.0       # web-seed HTTP share of the above
    pod_cache_uploaded: float = 0.0         # cache-tier serves into the pods
    cross_pod_bytes: float = 0.0            # spine traffic (0 without a spine)
    hedge_cancelled_bytes: float = 0.0      # losing hedge duplicates, cancelled
    fetch_latencies: list[float] = dataclasses.field(default_factory=list)
    # ^ verified per-piece fetch latencies (request start -> accept), event
    #   order, across all clients and both serving paths
    # peer -> seconds from arrival to first accepted piece. Trace-derived:
    # populated only when the run records a trace (empty otherwise).
    first_byte_latencies: dict[str, float] = dataclasses.field(
        default_factory=dict
    )

    @property
    def origin_peer_uploaded(self) -> float:
        return self.origin_uploaded - self.origin_http_uploaded

    @property
    def ud_ratio(self) -> float:
        """Eq. 1: total community download / origin upload."""
        if self.origin_uploaded <= 0:
            return float("inf") if self.total_downloaded else 0.0
        return self.total_downloaded / self.origin_uploaded

    def mean_completion_time(self) -> float:
        if not self.completion_time:
            return 0.0
        return float(np.mean(list(self.completion_time.values())))

    def mean_download_speed(
        self, size_bytes: float, *, exclude_first_byte: bool = False
    ) -> float:
        """Mean per-client speed. ``exclude_first_byte`` subtracts each
        client's trace-derived first-byte latency from its completion time
        (steady-state transfer rate rather than end-to-end); it requires a
        traced run and raises when no first-byte latencies were recorded."""
        if not self.completion_time:
            raise ValueError(
                "mean_download_speed: no client has completed a download"
            )
        if exclude_first_byte:
            if not self.first_byte_latencies:
                raise ValueError(
                    "mean_download_speed: exclude_first_byte needs "
                    "first_byte_latencies (run with telemetry tracing on)"
                )
            t = float(np.mean([
                max(dt - self.first_byte_latencies.get(pid, 0.0), 0.0)
                for pid, dt in self.completion_time.items()
            ]))
        else:
            t = self.mean_completion_time()
        return size_bytes / t if t > 0 else float("inf")

    def completion_percentiles(
        self, ps: Sequence[float] = (50, 95, 99)
    ) -> dict[str, float]:
        """Per-client tail latency: {"p50", "p95", "p99"} of completion
        times (seconds from arrival). Raises when no client completed."""
        if not self.completion_time:
            raise ValueError(
                "completion_percentiles: no client has completed a download"
            )
        return percentiles(self.completion_time.values(), ps)

    def first_byte_percentiles(
        self, ps: Sequence[float] = (50, 95, 99)
    ) -> dict[str, float]:
        """Percentiles of the trace-derived per-client first-byte latency
        (arrival -> first accepted piece). Raises when the run recorded no
        trace (``first_byte_latencies`` is empty)."""
        if not self.first_byte_latencies:
            raise ValueError(
                "first_byte_percentiles: no first-byte latencies recorded "
                "(run with telemetry tracing on)"
            )
        return percentiles(self.first_byte_latencies.values(), ps)

    def fetch_latency_histogram(
        self, bins: int = 16
    ) -> tuple[list[int], list[float]]:
        """Per-piece fetch-latency histogram (counts, bin edges in seconds).

        Raises when no verified fetch was recorded."""
        if not self.fetch_latencies:
            raise ValueError(
                "fetch_latency_histogram: no verified fetches recorded"
            )
        counts, edges = np.histogram(
            np.asarray(self.fetch_latencies, dtype=np.float64), bins=bins
        )
        return counts.tolist(), edges.tolist()


# --------------------------------------------------------------------------- arrivals


def flash_crowd(n: int, at: float = 0.0, prefix: str = "peer") -> list[tuple[str, float]]:
    return [(f"{prefix}{i:04d}", at) for i in range(n)]


def staggered_arrivals(
    n: int, interval: float, start: float = 0.0, prefix: str = "peer"
) -> list[tuple[str, float]]:
    return [(f"{prefix}{i:04d}", start + i * interval) for i in range(n)]


def poisson_arrivals(
    n: int, rate_per_sec: float, rng: np.random.Generator, prefix: str = "peer"
) -> list[tuple[str, float]]:
    gaps = rng.exponential(1.0 / rate_per_sec, size=n)
    times = np.cumsum(gaps)
    return [(f"{prefix}{i:04d}", float(times[i])) for i in range(n)]


# --------------------------------------------------------------------------- time-domain sim


class SwarmSim:
    """Event-driven swarm over the fluid network (see module docstring)."""

    def __init__(
        self,
        metainfo: MetaInfo,
        cfg: SwarmConfig | None = None,
        seed: int = 0,
        topology: Optional[ClusterTopology] = None,
        origin_payload: Optional[dict[int, bytes]] = None,
        same_pod_frac: float = 1.0,
        *,
        net: Optional[FluidNetwork] = None,
        tracker: Optional[Tracker] = None,
        telemetry: Optional[TraceRecorder] = None,
    ):
        """``net``/``tracker`` inject shared infrastructure for multi-torrent
        runs (:class:`repro_torch.core.scenario.MultiTorrentSim`): every torrent's
        flows then contend on one fluid network and announce to one tracker.
        Default (None): the engine owns both — the historical behaviour.
        ``telemetry`` is a shared flight recorder (None => disabled; a
        disabled recorder costs one attribute check per emission site and
        leaves results bit-identical to an untraced run)."""
        self.metainfo = metainfo
        self.cfg = cfg or SwarmConfig()
        self.rng = np.random.default_rng(seed)
        self.net = net if net is not None else FluidNetwork()
        self.topology = topology
        self.tracker = tracker if tracker is not None else Tracker(
            rng=np.random.default_rng(seed + 1), topology=topology,
            same_pod_frac=same_pod_frac,
        )
        self.tracker.register(metainfo)
        # multi-torrent hook: called as (sim, agent, now) when a client
        # completes its download (None => no observer)
        self.on_client_complete = None
        # the unified decision core; WebSeedSwarmSim swaps in one that also
        # carries the HTTP policy + origin set
        self.scheduler = TransferScheduler(
            metainfo, None, endgame=self.cfg.endgame
        )
        self.telemetry = telemetry if telemetry is not None else NULL_RECORDER
        if self.telemetry.enabled:
            self.telemetry.clock = lambda: self.net.now
        self.scheduler.telemetry = self.telemetry
        # self-healing hook: a RepairController wired by the scenario
        # builder (None => every repair code path is inert and the run is
        # bit-identical to a repair-free build)
        self.repair = None
        # adversarial tier, also wired by the scenario builder: None for
        # both means every Byzantine/quarantine code path is inert
        self.adversary = None
        self.quarantine = None
        # tracker-outage state: clients whose announce went dark and are
        # in the capped-exponential re-announce loop, plus departures whose
        # ``stopped`` announce is queued for the heal
        self._reannounce_pending: set[str] = set()
        self._dark_departed: list[str] = []
        self.agents: dict[str, PeerAgent] = {}
        self._origin_payload = origin_payload
        self._tick_scheduled = False
        self._pending_arrivals = 0
        # cross-pod spine: one shared link every cross-pod flow rides
        self._pod_of: dict[str, Optional[int]] = {}
        self.spine = None
        if topology is not None and topology.spine_bps is not None:
            # with an injected net the spine may already exist (one shared
            # link for every torrent's cross-pod traffic)
            self.spine = self.net.links.get("spine") or self.net.add_link(
                "spine", topology.spine_bps
            )

    # ------------------------------------------------------------- locality
    def _pod(self, name: str) -> Optional[int]:
        """Pod of a node name (host addr or registered cache), else None."""
        if name not in self._pod_of:
            addr = self.topology.addr_of(name) if self.topology else None
            self._pod_of[name] = addr.pod if addr is not None else None
        return self._pod_of[name]

    def _links_between(self, a: str, b: str) -> tuple:
        """Shared links an a->b flow traverses: the spine unless both ends
        sit in the same pod (mirrors/origins live behind the spine)."""
        if self.spine is None:
            return ()
        pa, pb = self._pod(a), self._pod(b)
        if pa is not None and pa == pb:
            return ()
        return (self.spine,)

    # ------------------------------------------------------------- membership
    def _new_agent(self, peer_id: str, is_origin: bool) -> PeerAgent:
        store = None
        if self._origin_payload is not None:
            store = dict(self._origin_payload) if is_origin else {}
        choker_cfg = ChokerConfig(
            max_unchoked=self.cfg.max_unchoked,
            optimistic_slots=self.cfg.optimistic_slots,
            interval=self.cfg.choke_interval,
        )
        if (
            not is_origin and self.adversary is not None
            and peer_id in self.adversary.free_riders
        ):
            # free-riders take without giving: a zero-slot choker never
            # unchokes anyone, so no neighbor can ever request from them
            choker_cfg = ChokerConfig(
                max_unchoked=0, optimistic_slots=0,
                interval=self.cfg.choke_interval,
            )
        agent = PeerAgent(
            peer_id,
            self.metainfo,
            np.random.default_rng(self.rng.integers(2**63)),
            is_origin=is_origin,
            policy=self.cfg.policy,
            pipeline=self.cfg.pipeline,
            per_peer_requests=self.cfg.per_peer_requests,
            choker_cfg=choker_cfg,
            store=store,
        )
        self.agents[peer_id] = agent
        return agent

    def add_origin(
        self, up_bps: float, name: str = "origin", down_bps: float = 1.0
    ) -> PeerAgent:
        agent = self._new_agent(name, is_origin=True)
        agent.node = self.net.add_node(name, up_bps, down_bps)
        self.tracker.announce(
            self.metainfo, name, uploaded=0, downloaded=0,
            event="started", now=self.net.now, is_origin=True,
        )
        self.tracker.attach_bitfield(self.metainfo, name, agent.bitfield)
        return agent

    def add_peer(self, spec: PeerSpec) -> None:
        self._pending_arrivals += 1
        self.net.schedule(spec.arrive_at, lambda now, s=spec: self._on_arrival(s, now))

    def add_peers(self, arrivals: Iterable[tuple[str, float]],
                  up_bps: float, down_bps: float,
                  seed_linger: Optional[float] = None) -> None:
        for pid, t in arrivals:
            self.add_peer(PeerSpec(pid, t, up_bps, down_bps, seed_linger))

    # ------------------------------------------------------------- event handlers
    def _on_arrival(self, spec: PeerSpec, now: float) -> None:
        self._pending_arrivals -= 1
        agent = self._new_agent(spec.peer_id, is_origin=False)
        agent.node = self.net.add_node(spec.peer_id, spec.up_bps, spec.down_bps)
        agent.arrived_at = now
        agent.seed_linger = spec.seed_linger  # type: ignore[attr-defined]
        if self.tracker.failed:
            # control plane dark: bootstrap from the engine's cached swarm
            # membership and queue a backoff re-announce for the heal
            peer_list = self._cached_peer_list(spec.peer_id)
            self._mark_dark(spec.peer_id, now)
        else:
            peer_list = self.tracker.announce(
                self.metainfo, spec.peer_id, uploaded=0, downloaded=0,
                event="started", now=now, want_peers=self.cfg.max_neighbors,
            )
            self.tracker.attach_bitfield(
                self.metainfo, spec.peer_id, agent.bitfield
            )
        if self.telemetry.enabled:
            self.telemetry.emit(
                "peer_join", t=now, torrent=self.metainfo.name,
                client=spec.peer_id,
            )
        for other_id in self._filter_peer_list(agent, peer_list):
            other = self.agents.get(other_id)
            if other is None or other.departed:
                continue
            if len(agent.neighbors) >= self.cfg.max_neighbors:
                break
            agent.connect(other_id, other.bitfield)
            other.connect(agent.peer_id, agent.bitfield)
        self._rechoke_all(now)
        self._ensure_tick(now)
        self._launch(agent, now)

    def _filter_peer_list(self, agent: PeerAgent, peer_list: list[str]) -> list[str]:
        """Hook for drivers to restrict tracker peer lists. The base filter
        drops peers on the far side of an open partition (identity when no
        partition is open); subclasses layer locality on top."""
        if not self.net.partitioned:
            return peer_list
        return [
            p for p in peer_list
            if self.net.reachable_names(agent.peer_id, p)
        ]

    def _ensure_tick(self, now: float) -> None:
        if not self._tick_scheduled:
            self._tick_scheduled = True
            self.net.schedule(now + self.cfg.choke_interval, self._choke_tick)

    def _choke_tick(self, now: float) -> None:
        if self.quarantine is not None:
            for pid in self.quarantine.due_parole(now):
                self._parole_peer(pid, now)
        self._rechoke_all(now)
        live_leech = any(
            not a.is_seed and not a.departed for a in self.agents.values()
        )
        if live_leech or self._pending_arrivals > 0:
            self.net.schedule(now + self.cfg.choke_interval, self._choke_tick)
        else:
            self._tick_scheduled = False

    def _rechoke_all(self, now: float) -> None:
        for agent in self.agents.values():
            if agent.departed:
                continue
            interested = {
                pid
                for pid in agent.neighbors
                if (nb := self.agents.get(pid)) is not None
                and not nb.departed
                and not nb.is_seed
                and nb.interested_in(agent.peer_id)
            }
            agent.rechoke(interested, now)
            for pid in agent.neighbors:
                other = self.agents.get(pid)
                if other is None or other.departed:
                    continue
                state = other.neighbors.get(agent.peer_id)
                if state is None:
                    continue
                # mirror the choker's verdict into the scheduler's view
                allowed = agent.choker.allows(pid)
                newly = allowed and not state.unchokes_me
                state.unchokes_me = allowed
                if newly:
                    self._launch(other, now)

    def _serviceable_availability(self, agent: PeerAgent):
        """Availability as seen through peers that will actually serve:
        free-riding neighbors hold replicas nobody can fetch (a zero-slot
        choker never unchokes), so their haves must not mask the HTTP
        fallback — or a piece held only by a free-rider starves the whole
        swarm. None (use the agent's own view) when no adversary is
        declared, keeping adversary-free runs on the untouched code path."""
        if self.adversary is None or not self.adversary.free_riders:
            return None
        avail = agent.availability.copy()
        for pid in self.adversary.free_riders:
            if pid == agent.peer_id or pid not in agent.neighbors:
                continue
            rider = self.agents.get(pid)
            if rider is not None:
                avail -= rider.bitfield.as_array().astype(avail.dtype)
        return np.maximum(avail, 0)

    def _launch(self, agent: PeerAgent, now: float) -> None:
        if agent.departed or agent.node is None:
            return
        for req in self.scheduler.next_actions(ClientView(agent=agent)):
            src = self.agents[req.src]
            if src.node is None or src.node.failed:
                continue
            if not self.net.reachable_names(req.src, agent.peer_id):
                continue  # cross-partition request: retry inside the side
            agent.in_flight.setdefault(req.piece, req.src)
            size = self.metainfo.piece_size(req.piece)
            self.net.start_flow(
                src.node,
                agent.node,
                size,
                tag=(req.src, agent.peer_id, req.piece),
                on_complete=self._on_piece_done,
                on_abort=self._on_piece_abort,
                links=self._links_between(req.src, agent.peer_id),
            )
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "request_issued", t=now, torrent=self.metainfo.name,
                    client=agent.peer_id, origin=req.src, piece=req.piece,
                    nbytes=float(size), info="peer",
                )

    def _on_piece_done(self, flow: Flow, now: float) -> None:
        src_id, dst_id, piece = flow.tag
        src, dst = self.agents.get(src_id), self.agents.get(dst_id)
        if dst is None or dst.departed:
            return
        data = src.read_piece(piece) if src is not None else None
        corrupt = (
            self.cfg.corruption_prob > 0
            and self.rng.random() < self.cfg.corruption_prob
        )
        # Byzantine poisoning: the serving peer corrupts the bytes on the
        # wire (its at-rest replica stays good — quarantine, not
        # read-repair, is the cure for a poisoner)
        poisoned = (
            not corrupt and self.adversary is not None
            and src is not None and not src.is_origin
            and self.adversary.poisons(src_id)
        )
        if poisoned:
            self.adversary.poisoned_pieces += 1
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "piece_poisoned", t=now, torrent=self.metainfo.name,
                    client=dst_id, origin=src_id, piece=piece,
                    nbytes=float(flow.size),
                )
        if (corrupt or poisoned) and data is not None:
            data = bytes([data[0] ^ 0xFF]) + data[1:]  # verification will catch it
        accepted = dst.accept_piece(
            piece, src_id, data, now, corrupt=corrupt or poisoned
        )
        self.scheduler.on_piece_done(
            dst_id, piece, accepted=accepted,
            latency=(now - flow.start_time) if accepted else None,
        )
        if self.repair is not None:
            if accepted:
                tier = "origin" if (src is not None and src.is_origin) \
                    else "peer"
                self.repair.note_done(dst_id, piece, tier, float(flow.size),
                                      now)
            elif (
                not corrupt and not poisoned and dst.last_reject_verify
                and src is not None and not src.is_origin
            ):
                # read-repair: the data was bad at rest (no in-flight
                # injection), so the serving replica is poisoned — evict
                # it before it spreads; the next scan restores the deficit
                if src.store is not None:
                    src.store.pop(piece, None)
                if piece in src.bitfield:
                    src.bitfield.clear(piece)
                self.repair.note_evict(src_id, piece, now)
        if self.telemetry.enabled:
            if accepted:
                self.telemetry.emit(
                    "piece_done", t=now, torrent=self.metainfo.name,
                    client=dst_id, origin=src_id, piece=piece,
                    nbytes=float(flow.size), info="peer",
                )
            else:
                self.telemetry.emit(
                    "piece_failed", t=now, torrent=self.metainfo.name,
                    client=dst_id, origin=src_id, piece=piece,
                    info="verify" if dst.last_reject_verify else "duplicate",
                )
        if (
            self.quarantine is not None and not accepted
            and dst.last_reject_verify
            and src is not None and not src.is_origin
        ):
            # verify failure attributed to the serving source: strike it,
            # and ban once it crosses the threshold
            if self.quarantine.record_failure(src_id, float(flow.size), now):
                self._ban_peer(src_id, now)
        if src is not None and not src.departed:
            src.record_served(piece, dst_id, now)
            self._announce_counters(src, now)
        if accepted:
            self._on_piece_accepted(dst, piece, now)
        self._launch(dst, now)

    def _on_piece_accepted(self, dst: PeerAgent, piece: int, now: float) -> None:
        """Post-verification bookkeeping shared by the peer path and the
        web-seed HTTP path: cancel duplicates, broadcast Have, handle
        completion + seed-linger departure."""
        dst_id = dst.peer_id
        # cancel endgame duplicates still in flight for this piece
        for other_flow in list(self.net.flows.values()):
            _, ofdst, ofpiece = other_flow.tag
            if ofdst == dst_id and ofpiece == piece:
                self.net.abort_flow(other_flow)
        have_targets = []
        for pid in dst.neighbors:
            other = self.agents.get(pid)
            if other is not None and not other.departed:
                other.on_have(dst_id, piece)
                have_targets.append(other)
        self._announce_counters(dst, now)
        # a Have can unblock a stalled neighbor (new candidate piece)
        for other in have_targets:
            if not other.is_seed:
                self._launch(other, now)
        if dst.complete and dst.completed_at is None:
            dst.completed_at = now
            if self.tracker.failed:
                self._mark_dark(dst_id, now)
            else:
                self.tracker.announce(
                    self.metainfo, dst_id,
                    uploaded=dst.ledger.uploaded,
                    downloaded=dst.ledger.downloaded,
                    event="completed", now=now,
                )
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "peer_complete", t=now, torrent=self.metainfo.name,
                    client=dst_id,
                )
            if self.on_client_complete is not None:
                self.on_client_complete(self, dst, now)
            linger = getattr(dst, "seed_linger", None)
            if linger is not None:
                self.net.schedule(
                    now + linger, lambda t, a=dst: self._depart(a, t)
                )

    def _on_piece_abort(self, flow: Flow, now: float) -> None:
        src_id, dst_id, piece = flow.tag
        dst = self.agents.get(dst_id)
        if self.repair is not None:
            self.repair.note_failed(dst_id, piece)
        if dst is None or dst.departed:
            return
        self.scheduler.on_piece_failed(dst_id, piece)
        if self.telemetry.enabled:
            self.telemetry.emit(
                "piece_failed", t=now, torrent=self.metainfo.name,
                client=dst_id, origin=src_id, piece=piece, info="abort",
            )
        if dst.in_flight.get(piece) == src_id:
            del dst.in_flight[piece]
        nb = dst.neighbors.get(src_id)
        if nb is not None:
            nb.outstanding = max(0, nb.outstanding - 1)
        dst.endgame_extra.discard(piece)
        self._launch(dst, now)

    def _announce_counters(self, agent: PeerAgent, now: float) -> None:
        if self.tracker.failed:
            return  # counters refresh on the next successful announce
        self.tracker.announce(
            self.metainfo, agent.peer_id,
            uploaded=agent.ledger.uploaded, downloaded=agent.ledger.downloaded,
            event="update", now=now, is_origin=agent.is_origin,
        )

    def _depart(self, agent: PeerAgent, now: float) -> None:
        if agent.departed:
            return
        agent.departed = True
        if self.telemetry.enabled and not agent.is_origin:
            self.telemetry.emit(
                "peer_churn", t=now, torrent=self.metainfo.name,
                client=agent.peer_id,
                info="post_complete" if agent.completed_at is not None
                else "mid_download",
            )
        if self.tracker.failed:
            # the stopped announce can't land: queue it for the heal so the
            # tracker's membership reconciles once the control plane is back
            self._dark_departed.append(agent.peer_id)
        else:
            self.tracker.announce(
                self.metainfo, agent.peer_id,
                uploaded=agent.ledger.uploaded,
                downloaded=agent.ledger.downloaded,
                event="stopped", now=now,
            )
        if agent.node is not None:
            self.net.fail_node(agent.node)
        for pid in list(agent.neighbors):
            other = self.agents.get(pid)
            if other is not None:
                other.disconnect(agent.peer_id)
            agent.disconnect(pid)
        if self.repair is not None:
            # repairs destined to the departed client can never settle
            for dst, piece in [k for k in self.repair.pending
                               if k[0] == agent.peer_id]:
                self.repair.note_failed(dst, piece)

    def fail_peer(self, peer_id: str) -> None:
        """External fault injection: hard-kill a live peer (node failure)."""
        agent = self.agents.get(peer_id)
        if agent is not None and not agent.departed:
            self._depart(agent, self.net.now)

    def churn_storm(self, count: int, spread: float, seed: int,
                    now: float) -> list[str]:
        """Burst departure: ``count`` live non-origin peers leave, each at
        ``now`` plus an Exponential(``spread``) session-tail draw (all at
        once when ``spread`` is 0). Victims and offsets come from a
        dedicated RNG seeded with ``seed``, so a run without the event
        draws nothing extra from the engine RNG (golden bit-identity)."""
        rng = np.random.default_rng(seed)
        live = sorted(
            pid for pid, a in self.agents.items()
            if not a.is_origin and not a.departed
        )
        if not live:
            return []
        k = min(int(count), len(live))
        idx = rng.choice(len(live), size=k, replace=False)
        idx.sort()
        victims = [live[i] for i in idx]
        for pid in victims:
            delay = float(rng.exponential(spread)) if spread > 0 else 0.0
            if delay <= 0:
                self.fail_peer(pid)
            else:
                self.net.schedule(
                    now + delay, lambda t, p=pid: self.fail_peer(p)
                )
        return victims

    # ------------------------------------------------------------- quarantine
    def _ban_peer(self, peer_id: str, now: float) -> None:
        """Quarantine a Byzantine peer: the tracker stops handing it out
        (and its replicas stop counting), its mesh links tear down, and its
        remaining upload flows abort — but its node stays up. A banned peer
        may keep *downloading* through the HTTP tier: it is quarantined as
        a source, not executed."""
        self.tracker.ban_peer(self.metainfo, peer_id)
        if self.telemetry.enabled:
            self.telemetry.emit(
                "peer_banned", t=now, torrent=self.metainfo.name,
                client=peer_id,
                value=float(self.quarantine.fails.get(peer_id, 0)),
            )
        agent = self.agents.get(peer_id)
        if agent is None or agent.departed:
            return
        # tear down the mesh FIRST, then abort its in-flight uploads: the
        # abort handlers relaunch the victims immediately, and they must
        # not find the banned peer still in their neighbor lists. Its own
        # downloads settle normally — late verify failures on them are
        # attributed to *their* source, not re-counted against this peer
        for pid in list(agent.neighbors):
            other = self.agents.get(pid)
            if other is not None:
                other.disconnect(peer_id)
            agent.disconnect(pid)
        for flow in list(self.net.flows.values()):
            if flow.tag[0] == peer_id:
                self.net.abort_flow(flow)
        self._launch(agent, now)   # keep its download going via HTTP

    def _parole_peer(self, peer_id: str, now: float) -> None:
        """Timed parole: re-admit a banned peer — tracker re-insert plus a
        fresh announce to rejoin the mesh. It re-enters one strike short of
        the threshold, so a single re-offense deterministically re-bans."""
        self.tracker.parole_peer(self.metainfo, peer_id)
        if self.telemetry.enabled:
            self.telemetry.emit(
                "peer_parole", t=now, torrent=self.metainfo.name,
                client=peer_id,
            )
        agent = self.agents.get(peer_id)
        if agent is not None and not agent.departed:
            self._reconnect(agent, now)

    def _reconnect(self, agent: PeerAgent, now: float) -> None:
        """Fresh ``started`` announce + connect to the handed-out peers
        (parole re-admission, tracker recovery, partition heal). Falls back
        to the dark-tracker retry loop when the control plane is down."""
        if self.tracker.failed:
            self._mark_dark(agent.peer_id, now)
            return
        peer_list = self.tracker.announce(
            self.metainfo, agent.peer_id,
            uploaded=agent.ledger.uploaded,
            downloaded=agent.ledger.downloaded,
            event="started", now=now, want_peers=self.cfg.max_neighbors,
        )
        self.tracker.attach_bitfield(
            self.metainfo, agent.peer_id, agent.bitfield
        )
        for other_id in self._filter_peer_list(agent, peer_list):
            if other_id in agent.neighbors:
                continue
            other = self.agents.get(other_id)
            if other is None or other.departed:
                continue
            if len(agent.neighbors) >= self.cfg.max_neighbors:
                break
            agent.connect(other_id, other.bitfield)
            other.connect(agent.peer_id, agent.bitfield)
        self._rechoke_all(now)
        self._ensure_tick(now)
        self._launch(agent, now)

    # ------------------------------------------------------------- tracker outages
    # re-announce backoff: the delay doubles per failed attempt up to the
    # cap; the per-client jitter is a crc32 hash fraction (deterministic,
    # no engine RNG) so the fleet never thunders back in lockstep
    TRACKER_RETRY_BASE = 5.0
    TRACKER_RETRY_CAP = 60.0

    def _retry_delay(self, peer_id: str, attempt: int) -> float:
        base = min(self.TRACKER_RETRY_BASE * (2.0 ** attempt),
                   self.TRACKER_RETRY_CAP)
        jitter = base * 0.5 * (
            (zlib.crc32(peer_id.encode()) % 1000) / 1000.0
        )
        return base + jitter

    def tracker_fail(self, now: float) -> None:
        """Control-plane outage: announces stop landing. Clients keep
        trading on their current mesh (the data plane is untouched),
        arrivals bootstrap from the engine's cached peer list, and every
        client that misses an announce enters the capped-exponential
        re-announce loop."""
        self.tracker.failed = True
        if self.telemetry.enabled:
            self.telemetry.emit(
                "tracker_fail", t=now, torrent=self.metainfo.name,
                info="tracker",
            )

    def tracker_heal(self, now: float) -> None:
        """Control plane back: flush the ``stopped`` announces that went
        dark; live clients re-register through their backoff retries."""
        self.tracker.failed = False
        if self.telemetry.enabled:
            self.telemetry.emit(
                "tracker_heal", t=now, torrent=self.metainfo.name,
                info="tracker",
            )
        for pid in self._dark_departed:
            agent = self.agents.get(pid)
            self.tracker.announce(
                self.metainfo, pid,
                uploaded=agent.ledger.uploaded if agent else 0.0,
                downloaded=agent.ledger.downloaded if agent else 0.0,
                event="stopped", now=now,
            )
        self._dark_departed.clear()

    def _cached_peer_list(self, peer_id: str) -> list[str]:
        """Peer-list fallback while the tracker is dark: the last known
        live swarm membership (sorted, capped), minus banned peers."""
        q = self.quarantine
        out = [
            pid for pid in sorted(self.agents)
            if pid != peer_id
            and not self.agents[pid].departed
            and not self.agents[pid].is_origin
            and (q is None or not q.is_banned(pid))
        ]
        return out[: self.cfg.max_neighbors]

    def _mark_dark(self, peer_id: str, now: float) -> None:
        """This client missed an announce during a tracker outage: it will
        re-announce with capped exponential backoff until one lands."""
        if peer_id in self._reannounce_pending:
            return
        self._reannounce_pending.add(peer_id)
        self.net.schedule(
            now + self._retry_delay(peer_id, 0),
            lambda t, p=peer_id: self._reannounce_fire(p, t, 0),
        )

    def _reannounce_fire(self, peer_id: str, now: float,
                         attempt: int) -> None:
        agent = self.agents.get(peer_id)
        if agent is None or agent.departed:
            self._reannounce_pending.discard(peer_id)
            return
        if self.tracker.failed:
            nxt = attempt + 1
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "retry", t=now, torrent=self.metainfo.name,
                    client=peer_id,
                    value=self._retry_delay(peer_id, nxt), info="tracker",
                )
            self.net.schedule(
                now + self._retry_delay(peer_id, nxt),
                lambda t, p=peer_id, k=nxt: self._reannounce_fire(p, t, k),
            )
            return
        self._reannounce_pending.discard(peer_id)
        self._reconnect(agent, now)

    # ------------------------------------------------------------- partitions
    def _reachable_names_from(
        self, src: str, names: list[str]
    ) -> list[str]:
        """Filter a name list down to the endpoints ``src`` can reach
        (identity when no partition is open)."""
        if not self.net.partitioned:
            return names
        return [n for n in names if self.net.reachable_names(src, n)]

    def _partition_sides(self, target: str) -> tuple[dict[str, int], int]:
        """name -> side map for a partition target. ``"spine"`` cuts every
        pod from every other pod and from the core (mirrors and unmapped
        nodes); ``"pods:1,3"`` isolates the named pod set — internally
        connected — from the rest of the fabric."""
        if target == "spine":
            sides = {}
            for node in self.net.nodes:
                pod = self._pod(node.name)
                if pod is not None:
                    sides[node.name] = pod
            return sides, -1
        if target.startswith("pods:"):
            body = target[len("pods:"):]
            pods = {int(p) for p in body.split(",") if p != ""}
            sides = {}
            for node in self.net.nodes:
                pod = self._pod(node.name)
                if pod is not None and pod in pods:
                    sides[node.name] = 1
            return sides, 0
        raise ValueError(f"unknown partition target {target!r}")

    def start_partition(self, target: str, now: float) -> None:
        """Data-plane partition: cut the spine or isolate a pod set. The
        cross-side mesh tears down first, then every in-flight cross-side
        flow aborts (victims retry inside their side), and origin/mirror
        selection filters to reachable endpoints until
        :meth:`heal_partition`."""
        if self.telemetry.enabled:
            self.telemetry.emit(
                "partition", t=now, torrent=self.metainfo.name, info=target,
            )
        sides, default = self._partition_sides(target)
        # prune the mesh before cutting the network, so the abort handlers'
        # relaunches only ever see same-side neighbors
        for pid, agent in self.agents.items():
            if agent.departed:
                continue
            for oid in list(agent.neighbors):
                if sides.get(pid, default) != sides.get(oid, default):
                    agent.disconnect(oid)
                    other = self.agents.get(oid)
                    if other is not None and pid in other.neighbors:
                        other.disconnect(pid)
        self.net.set_partition(sides, default=default)
        self._rechoke_all(now)
        for pid in sorted(self.agents):
            agent = self.agents[pid]
            if not agent.departed and not agent.is_origin \
                    and not agent.complete:
                self._launch(agent, now)

    def heal_partition(self, now: float) -> None:
        """Partition heals: clear the cut and reconnect every live
        incomplete client through a fresh announce, so the sides reconcile
        (repair scans re-balance replicas on the next pass)."""
        if self.telemetry.enabled:
            self.telemetry.emit(
                "partition_heal", t=now, torrent=self.metainfo.name,
            )
        self.net.clear_partition()
        for pid in sorted(self.agents):
            agent = self.agents[pid]
            if agent.departed or agent.is_origin or agent.complete:
                continue
            self._reconnect(agent, now)

    # ------------------------------------------------------------- repair
    def repair_fetch(self, piece: int, now: float) -> "Optional[str]":
        """Repair-controller hook: start one re-seed transfer of ``piece``.

        The peer-only engine has a single serving tier; the web-seed
        subclass overrides this to prefer mirrors and pod caches. Returns
        the destination client id, or None when no transfer can start."""
        dst = self._repair_dst(piece)
        if dst is None:
            return None
        return self._repair_from_peer(dst, piece, now)

    def _repair_dst(self, piece: int):
        """Lexicographically first live non-origin client that lacks
        ``piece`` and has no transfer of it in flight (deterministic)."""
        q = self.quarantine
        for pid in sorted(self.agents):
            a = self.agents[pid]
            if a.is_origin or a.departed or a.node is None:
                continue
            if q is not None and q.is_banned(pid):
                continue  # a banned replica wouldn't count anyway
            if piece in a.bitfield or piece in a.in_flight:
                continue
            return a
        return None

    def _repair_from_peer(self, dst, piece: int, now: float) -> "Optional[str]":
        """Peer-tier re-seed: first (sorted) live holder serves ``dst``."""
        size = self.metainfo.piece_size(piece)
        for sid in sorted(self.agents):
            src = self.agents[sid]
            if sid == dst.peer_id or src.departed or src.node is None \
                    or src.node.failed:
                continue
            if not self.net.reachable_names(sid, dst.peer_id):
                continue
            if self.quarantine is not None and self.quarantine.is_banned(sid):
                continue
            if piece not in src.bitfield:
                continue
            dst.in_flight[piece] = sid
            self.net.start_flow(
                src.node,
                dst.node,
                size,
                tag=(sid, dst.peer_id, piece),
                on_complete=self._on_piece_done,
                on_abort=self._on_piece_abort,
                links=self._links_between(sid, dst.peer_id),
            )
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "request_issued", t=now, torrent=self.metainfo.name,
                    client=dst.peer_id, origin=sid, piece=piece,
                    nbytes=float(size), info="repair",
                )
            return dst.peer_id
        return None

    # ------------------------------------------------------------- run
    def run(self, until: float = float("inf")) -> SwarmResult:
        self.net.run(until=until)
        return self._result()

    def _result(self) -> SwarmResult:
        """Assemble this torrent's result from the current engine state
        (factored out of :meth:`run` so a multi-torrent driver can run the
        shared network once and collect every torrent's result)."""
        stats = self.tracker.scrape(self.metainfo)
        comp, fin = {}, {}
        for pid, a in self.agents.items():
            if not a.is_origin and a.completed_at is not None:
                comp[pid] = a.completed_at - a.arrived_at
                fin[pid] = a.completed_at
        first_byte: dict[str, float] = {}
        if self.telemetry.enabled:
            first_byte = self.telemetry.first_byte_latencies(
                self.metainfo.name,
                {pid: a.arrived_at for pid, a in self.agents.items()
                 if not a.is_origin},
            )
        return SwarmResult(
            sim_time=self.net.now,
            stats=stats,
            completion_time=comp,
            finish_at=fin,
            ledgers={pid: a.ledger for pid, a in self.agents.items()},
            origin_uploaded=stats.origin_uploaded,
            total_downloaded=stats.total_downloaded,
            events=self.net.events_processed,
            origin_http_uploaded=stats.origin_http_uploaded,
            pod_cache_uploaded=stats.pod_cache_uploaded,
            cross_pod_bytes=(
                self.spine.bytes_through if self.spine is not None else 0.0
            ),
            hedge_cancelled_bytes=stats.hedge_cancelled_bytes,
            fetch_latencies=list(self.scheduler.fetch_latencies),
            first_byte_latencies=first_byte,
        )


# --------------------------------------------------------------------------- byte-domain engine


class LocalSwarm:
    """Round-based functional swarm that moves *real, verified* bytes.

    Every peer is mutually connected and unchoked; fairness is enforced by
    an ``upload_slots`` budget per peer per round (the round is the unit of
    "time"). Selection is rarest-first by default, so the emergent behaviour
    matches :class:`SwarmSim`; rounds-to-completion is the scale-free
    analogue of distribution time and is what the data-pipeline tests
    assert on.
    """

    def __init__(
        self,
        metainfo: MetaInfo,
        origin_store: dict[int, bytes],
        peer_ids: Sequence[str],
        seed: int = 0,
        policy: str = "rarest_first",
        upload_slots: int = 4,
        origin_slots: int = 4,
        needed: Optional[dict[str, np.ndarray]] = None,
        webseed=None,
        mirrors=None,
        pod_of: Optional[dict[str, int]] = None,
        pod_caches: bool = False,
        telemetry: Optional[TraceRecorder] = None,
    ):
        """``needed``: optional per-peer bool mask (num_pieces,) restricting
        which pieces that peer must obtain (partitioned ingest — each data-
        parallel host fetches only its assigned shards). Peers still serve
        everything they hold, so the swarm amplification is unchanged.

        ``webseed``: optional :class:`repro_torch.core.webseed.OriginPolicy`. When
        set, the origin tier is a set of bare HTTP byte-range mirrors (the
        origin joins the peer mesh only if ``serve_peer_protocol``); peers
        fall back to verified range reads for pieces no peer holds — which
        is what lets a swarm cold-start from an origin with zero seeded
        peers.

        ``mirrors``: optional sequence of
        :class:`repro_torch.core.webseed.MirrorSpec` replicating the origin store
        behind divergent endpoints; defaults to one mirror named
        ``"origin"``. Range reads are routed by ``webseed.selection`` and
        fail over to the next ranked mirror when bytes fail verification or
        a mirror is marked dead (:meth:`fail_mirror`).

        ``pod_of``/``pod_caches``: optional peer -> pod map; with
        ``pod_caches=True`` each pod gets a
        :class:`~repro_torch.core.webseed.PodCacheOrigin` and peers range-read
        from their pod cache, which read-through fills (verified) from the
        mirror tier — so cross-pod bytes collapse to ~1 copy per pod.
        ``cross_pod_bytes`` ledgers every transfer whose endpoints sit in
        different pods (mirrors count as outside every pod)."""
        self.metainfo = metainfo
        self.rng = np.random.default_rng(seed)
        self.policy = policy
        self.upload_slots = upload_slots
        self.origin_slots = origin_slots
        self.needed = needed or {}
        self.origin = PeerAgent(
            "origin", metainfo, np.random.default_rng(seed + 1),
            is_origin=True, store=dict(origin_store),
        )
        self.webseed = webseed
        self.origin_set = None
        self.completed_round: dict[str, int] = {}
        self.pod_of = dict(pod_of) if pod_of else {}
        self.pod_caches: dict[int, "PodCacheOrigin"] = {}
        self.cross_pod_bytes = 0.0
        self._pod_have: Optional[dict[int, np.ndarray]] = None
        # fault-injection state: departed peers stop trading/counting and
        # a failed pod's cache is dead (contents lost)
        self.departed: set[str] = set()
        self._failed_pods: set[int] = set()
        self._deferred_departures: dict[int, list[str]] = {}
        # self-healing hook (a RepairController, wired by the scenario
        # builder; None => all repair paths inert)
        self.repair = None
        self._repair_settle: list[tuple[str, int, str, float]] = []
        # adversarial tier (wired by the scenario builder; every code path
        # below is inert while these stay None/empty)
        self.adversary = None
        self.quarantine = None
        self.banned: set[str] = set()
        # control-plane outage: the repair control loop pauses while dark;
        # the full-mesh data plane keeps trading
        self.tracker_dark = False
        # open partition: name -> side id (None => no partition)
        self._partition: Optional[dict[str, int]] = None
        self._partition_default = 0
        if mirrors is not None and webseed is None:
            raise ValueError("mirrors requires a webseed OriginPolicy")
        if pod_caches and webseed is None:
            raise ValueError("pod_caches requires a webseed OriginPolicy")
        if pod_caches and not self.pod_of:
            raise ValueError("pod_caches requires a pod_of peer->pod map")
        if pod_caches:
            # an unmapped peer would be unreachable: isolated from every
            # pod's peer traffic yet denied the pod-filtered HTTP fallback
            unmapped = [p for p in peer_ids if p not in self.pod_of]
            if unmapped:
                raise ValueError(
                    "pod_caches requires a pod for every peer; missing "
                    f"{unmapped[:3]}"
                )
        if webseed is not None:
            from .webseed import MirrorSpec, OriginSet, PodCacheOrigin

            specs = list(mirrors) if mirrors else [
                MirrorSpec("origin", up_bps=webseed.origin_up_bps)
            ]
            self.origin_set = OriginSet(metainfo, policy=webseed)
            for spec in specs:
                self.origin_set.add_mirror(spec, store=self.origin.store)
            if pod_caches:
                for pod in sorted(set(self.pod_of.values())):
                    cache = PodCacheOrigin(metainfo, pod, policy=webseed)
                    self.pod_caches[pod] = cache
                    # register the cache in the pod map so fills from the
                    # (unmapped) mirror tier ledger as cross-pod traffic
                    self.pod_of[cache.name] = pod
        # the same unified decision core the time-domain engines drive
        self.scheduler = TransferScheduler(
            metainfo, webseed, select_policy=policy,
            origin_set=self.origin_set,
        )
        # flight recorder: the byte engine stamps events with the round
        # counter (its unit of "time"); a shared multi-torrent recorder
        # keeps the first swarm's clock for scheduler-side emissions
        self.telemetry = telemetry if telemetry is not None else NULL_RECORDER
        if self.telemetry.enabled and self.telemetry.clock is None:
            self.telemetry.clock = lambda: float(self.rounds)
        self.scheduler.telemetry = self.telemetry
        self.peers: dict[str, PeerAgent] = {}
        for i, pid in enumerate(peer_ids):
            self.peers[pid] = PeerAgent(
                pid, metainfo, np.random.default_rng(seed + 2 + i),
                policy=policy, store={},
            )
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "peer_join", t=0.0, torrent=metainfo.name, client=pid,
                )
        origin_in_mesh = webseed is None or webseed.serve_peer_protocol
        everyone = dict(self.peers)
        if origin_in_mesh:
            everyone["origin"] = self.origin
        for pid, agent in everyone.items():
            for oid, other in everyone.items():
                if pid != oid:
                    agent.connect(oid, other.bitfield)
        self.rounds = 0

    @property
    def web_origin(self):
        """Primary mirror's HTTP front-end (single-origin back-compat)."""
        return self.origin_set.primary if self.origin_set is not None else None

    def fail_mirror(self, name: str) -> None:
        """Fault injection: mark one mirror dead; range reads fail over."""
        if self.origin_set is None:
            raise ValueError("no web-seed mirrors configured")
        if self.telemetry.enabled:
            self.telemetry.emit(
                "mirror_fail", t=float(self.rounds),
                torrent=self.metainfo.name, origin=name,
            )
        self.origin_set.fail(name)

    def heal_mirror(self, name: str) -> None:
        """Fault injection: bring a dead mirror back into the rotation."""
        if self.origin_set is None:
            raise ValueError("no web-seed mirrors configured")
        if self.telemetry.enabled:
            self.telemetry.emit(
                "mirror_heal", t=float(self.rounds),
                torrent=self.metainfo.name, origin=name,
            )
        self.origin_set.heal(name)

    def fail_peer(self, pid: str) -> None:
        """Fault injection: a peer departs mid-run — it stops trading,
        its replicas stop counting, and its mesh links are torn down."""
        if pid not in self.peers or pid in self.departed:
            return
        self.departed.add(pid)
        me = self.peers[pid]
        if self.telemetry.enabled:
            self.telemetry.emit(
                "peer_churn", t=float(self.rounds),
                torrent=self.metainfo.name, client=pid,
                info="post_complete" if pid in self.completed_round
                else "mid_download",
            )
        if self._pod_have is not None:
            pod = self.pod_of.get(pid)
            if pod is not None and pod in self._pod_have:
                self._pod_have[pod] -= me.bitfield.as_array()
        everyone = {**self.peers, "origin": self.origin}
        for oid, other in everyone.items():
            if oid != pid and pid in other.neighbors:
                other.disconnect(pid)
        for oid in list(me.neighbors):
            me.disconnect(oid)

    def churn_storm(self, count: int, spread: float, seed: int) -> list[str]:
        """Burst departure of ``count`` live peers. The byte engine has no
        future-event queue, so the Exponential(``spread``) session-tail
        draws quantize to whole rounds: a victim with offset d departs at
        round ``rounds + floor(d)`` (immediately when that is now).
        Victims/offsets come from a dedicated RNG seeded with ``seed``."""
        rng = np.random.default_rng(seed)
        live = sorted(p for p in self.peers if p not in self.departed)
        if not live:
            return []
        k = min(int(count), len(live))
        idx = rng.choice(len(live), size=k, replace=False)
        idx.sort()
        victims = [live[i] for i in idx]
        for pid in victims:
            delay = int(rng.exponential(spread)) if spread > 0 else 0
            if delay <= 0:
                self.fail_peer(pid)
            else:
                self._deferred_departures.setdefault(
                    self.rounds + delay, []
                ).append(pid)
        return victims

    def fail_pod(self, pod: int) -> list[str]:
        """Correlated loss of a whole pod: the pod cache dies with its
        contents and every peer homed in the pod departs (sorted order)."""
        self._failed_pods.add(pod)
        cache = self.pod_caches.get(pod)
        if cache is not None:
            cache.have[:] = False
            if cache.store is not None:
                cache.store.clear()
        victims = sorted(
            p for p in self.peers
            if p not in self.departed and self.pod_of.get(p) == pod
        )
        for pid in victims:
            self.fail_peer(pid)
        return victims

    # ------------------------------------------------------------- quarantine
    def _ban_peer(self, pid: str) -> None:
        """Quarantine a Byzantine peer: its mesh links tear down (it stops
        serving and trading peer-side), its replicas stop counting, and it
        finishes its own download through the HTTP tier."""
        if pid in self.banned:
            return
        self.banned.add(pid)
        if self.telemetry.enabled:
            self.telemetry.emit(
                "peer_banned", t=float(self.rounds),
                torrent=self.metainfo.name, client=pid,
                value=float(self.quarantine.fails.get(pid, 0))
                if self.quarantine is not None else None,
            )
        me = self.peers[pid]
        if self._pod_have is not None:
            pod = self.pod_of.get(pid)
            if pod is not None and pod in self._pod_have:
                self._pod_have[pod] -= me.bitfield.as_array()
        everyone = {**self.peers, "origin": self.origin}
        for oid, other in everyone.items():
            if oid != pid and pid in other.neighbors:
                other.disconnect(pid)
        for oid in list(me.neighbors):
            me.disconnect(oid)

    def _parole_peer(self, pid: str) -> None:
        """Timed parole: reconnect a banned peer to the mesh; its replicas
        count again. It re-enters one strike short of the threshold, so a
        single re-offense deterministically re-bans."""
        if pid not in self.banned:
            return
        self.banned.discard(pid)
        if self.telemetry.enabled:
            self.telemetry.emit(
                "peer_parole", t=float(self.rounds),
                torrent=self.metainfo.name, client=pid,
            )
        me = self.peers[pid]
        if self._pod_have is not None:
            pod = self.pod_of.get(pid)
            if pod is not None and pod in self._pod_have:
                self._pod_have[pod] += me.bitfield.as_array()
        origin_in_mesh = (
            self.webseed is None or self.webseed.serve_peer_protocol
        )
        everyone = dict(self.peers)
        if origin_in_mesh:
            everyone["origin"] = self.origin
        for oid, other in everyone.items():
            if oid == pid or oid in self.departed or oid in self.banned:
                continue
            me.connect(oid, other.bitfield)
            other.connect(pid, me.bitfield)

    # ------------------------------------------------------------- tracker outages
    def tracker_fail(self) -> None:
        """Byte-domain control-plane outage: the repair control loop (the
        availability consumer) pauses; the full-mesh data plane — already
        bootstrapped — keeps trading."""
        self.tracker_dark = True
        if self.telemetry.enabled:
            self.telemetry.emit(
                "tracker_fail", t=float(self.rounds),
                torrent=self.metainfo.name, info="tracker",
            )

    def tracker_heal(self) -> None:
        self.tracker_dark = False
        if self.telemetry.enabled:
            self.telemetry.emit(
                "tracker_heal", t=float(self.rounds),
                torrent=self.metainfo.name, info="tracker",
            )

    # ------------------------------------------------------------- partitions
    def _partition_sides(self, target: str) -> tuple[dict[str, int], int]:
        """name -> side map mirroring the time engine's semantics:
        ``"spine"`` puts every pod on its own side with mirrors on the core
        side; ``"pods:1,3"`` isolates the named pod set from the rest."""
        if target == "spine":
            sides = {
                n: p for n, p in self.pod_of.items() if p is not None
            }
            return sides, -1
        if target.startswith("pods:"):
            body = target[len("pods:"):]
            pods = {int(p) for p in body.split(",") if p != ""}
            sides = {
                n: 1 for n, p in self.pod_of.items()
                if p is not None and p in pods
            }
            return sides, 0
        raise ValueError(f"unknown partition target {target!r}")

    def _same_side(self, a: str, b: str) -> bool:
        if self._partition is None:
            return True
        d = self._partition_default
        return self._partition.get(a, d) == self._partition.get(b, d)

    def start_partition(self, target: str) -> None:
        """Open a partition: cross-side trades, range reads, and cache
        fills are refused until :meth:`heal_partition`. Round-based rounds
        have no in-flight window, so there is nothing to abort — the side
        filters take effect on the next trade attempt."""
        if self._partition is not None:
            raise RuntimeError("a partition is already open")
        if self.telemetry.enabled:
            self.telemetry.emit(
                "partition", t=float(self.rounds),
                torrent=self.metainfo.name, info=target,
            )
        self._partition, self._partition_default = \
            self._partition_sides(target)

    def heal_partition(self) -> None:
        if self.telemetry.enabled:
            self.telemetry.emit(
                "partition_heal", t=float(self.rounds),
                torrent=self.metainfo.name,
            )
        self._partition = None

    # ------------------------------------------------------------- repair
    def repair_availability(self) -> np.ndarray:
        """Live replica count per piece: the live origin tier (mirrors, or
        the bare origin without one) plus every non-departed peer. Pod
        caches are transient infrastructure and do not count — mirroring
        the tracker map the time engine repairs against."""
        base = (
            len(self.origin_set.live()) if self.origin_set is not None else 1
        )
        out = np.full(self.metainfo.num_pieces, base, dtype=np.int64)
        for pid, a in self.peers.items():
            if pid not in self.departed and pid not in self.banned:
                out += a.bitfield.as_array()
        return out

    def repair_fetch(self, piece: int, now: float) -> Optional[str]:
        """Repair-controller hook: synchronously re-seed one replica.

        Byte-domain rounds have no in-flight window, so the fetch walks
        the durability ladder (ranked mirrors -> the destination's pod
        cache when it holds the piece -> a live peer replica), verifies,
        commits, and queues the settlement ``repair_scan`` flushes after
        the controller registers the schedule."""
        dst = None
        for pid in sorted(self.peers):
            if pid in self.departed or pid in self.banned \
                    or piece in self.peers[pid].bitfield:
                continue
            dst = pid
            break
        if dst is None:
            return None
        me = self.peers[dst]
        size = float(self.metainfo.piece_size(piece))
        t = float(self.rounds)
        tel = self.telemetry
        data, tier, src_name = None, None, None
        if self.origin_set is not None:
            for name in self.origin_set.ranked():
                if not self._same_side(dst, name):
                    continue
                d = self.origin_set.origins[name].read_piece(piece)
                self.origin.record_served(piece, dst, t)
                self._count_cross_pod(name, dst, size)
                if d is not None and self.metainfo.verify_piece(piece, d):
                    data, tier, src_name = d, "origin", name
                    break
        elif self._same_side(dst, "origin"):
            d = self.origin.read_piece(piece)
            if d is not None and self.metainfo.verify_piece(piece, d):
                data, tier, src_name = d, "origin", "origin"
                self.origin.record_served(piece, dst, t)
                self._count_cross_pod("origin", dst, size)
        if data is None and self.pod_caches:
            pod = self.pod_of.get(dst)
            cache = self.pod_caches.get(pod)
            if cache is not None and pod not in self._failed_pods \
                    and cache.holds(piece):
                d = cache.read_piece(piece)
                if d is not None and self.metainfo.verify_piece(piece, d):
                    data, tier, src_name = d, "pod_cache", cache.name
        if data is None:
            for sid in sorted(self.peers):
                if sid == dst or sid in self.departed \
                        or sid in self.banned \
                        or not self._same_side(dst, sid):
                    continue
                src = self.peers[sid]
                if piece not in src.bitfield:
                    continue
                d = src.read_piece(piece)
                if d is not None and self.metainfo.verify_piece(piece, d):
                    data, tier, src_name = d, "peer", sid
                    src.record_served(piece, dst, t)
                    self._count_cross_pod(sid, dst, size)
                    break
        if data is None:
            return None
        if tel.enabled:
            tel.emit(
                "request_issued", t=t, torrent=self.metainfo.name,
                client=dst, origin=src_name, piece=piece, nbytes=size,
                info="repair",
            )
        if not me.accept_piece(piece, f"{src_name}::repair", data, t):
            return None
        if tel.enabled:
            tel.emit(
                "piece_done", t=t, torrent=self.metainfo.name, client=dst,
                origin=src_name, piece=piece, nbytes=size, info="repair",
            )
        self._commit_gain(dst, piece)
        self._repair_settle.append((dst, piece, tier, size))
        return dst

    def repair_scan(self) -> int:
        """One controller scan at a round boundary. Byte-domain re-seeds
        complete within the scan, so the queued settlements flush as soon
        as the controller has registered them; returns pieces repaired."""
        if self.repair is None or self.tracker_dark:
            return 0  # dark tracker: no availability map to scan against
        self.repair.scan(float(self.rounds))
        settled = len(self._repair_settle)
        for dst, piece, tier, size in self._repair_settle:
            self.repair.note_done(dst, piece, tier, size,
                                  float(self.rounds))
        self._repair_settle.clear()
        return settled

    def _agent(self, pid: str) -> PeerAgent:
        return self.origin if pid == "origin" else self.peers[pid]

    def _count_cross_pod(self, a: str, b: str, size: float) -> None:
        """Ledger a transfer a->b as cross-pod when the endpoints' pods
        differ; mirrors (no pod) sit behind the spine, so mirror->pod
        transfers count, while two unmapped endpoints trading do not."""
        if not self.pod_of:
            return
        if self.pod_of.get(a) != self.pod_of.get(b):
            self.cross_pod_bytes += size

    def _peer_done(self, pid: str) -> bool:
        me = self.peers[pid]
        mask = self.needed.get(pid)
        if mask is None:
            return me.complete
        return bool((me.bitfield.as_array() | ~mask).all())

    @property
    def complete(self) -> bool:
        return all(
            self._peer_done(pid) for pid in self.peers
            if pid not in self.departed
        )

    def _local_availability(self, me: PeerAgent) -> np.ndarray:
        """Per-piece holder count within ``me``'s pod — the availability the
        HTTP fallback keys off when a pod-cache tier isolates peer traffic
        inside each pod. Maintained incrementally (seeded lazily from
        current bitfields so resumable pre-seeding is captured, then bumped
        by ``_note_gain`` on every accepted piece) the way
        ``PeerAgent.availability`` is. ``me``'s own holdings are included,
        but fallback only consults *missing* pieces, where me counts 0."""
        if self._pod_have is None:
            self._pod_have = {}
            for pid, agent in self.peers.items():
                pod = self.pod_of.get(pid)
                if pod is None:
                    continue
                if pod not in self._pod_have:
                    self._pod_have[pod] = np.zeros(
                        self.metainfo.num_pieces, dtype=np.int64
                    )
                self._pod_have[pod] += agent.bitfield.as_array()
        my_pod = self.pod_of.get(me.peer_id)
        if my_pod is None or my_pod not in self._pod_have:
            return me.availability
        return self._pod_have[my_pod]

    def _note_gain(self, pid: str, piece: int) -> None:
        """Keep the pod-local availability counters fresh on piece intake."""
        if self._pod_have is None or pid in self.banned:
            return  # a banned peer's gains count again at parole
        pod = self.pod_of.get(pid)
        if pod is not None and pod in self._pod_have:
            self._pod_have[pod][piece] += 1

    def _commit_gain(self, pid: str, piece: int) -> None:
        """Post-accept bookkeeping shared by every intake path (peer trade,
        range read, hedged range read): refresh the pod-local availability
        counters and broadcast the Have."""
        self._note_gain(pid, piece)
        for wid, w in {**self.peers, "origin": self.origin}.items():
            if wid != pid:
                w.on_have(pid, piece)

    def _fill_cache(self, cache, piece: int) -> bool:
        """Read-through fill: verified fetch from the first good mirror,
        excluding (per piece) mirrors that already served bad bytes."""
        if cache.holds(piece):
            return True
        size = self.metainfo.piece_size(piece)
        tel = self.telemetry
        for name in self.origin_set.ranked():
            if not self._same_side(cache.name, name):
                continue  # the mirror tier is across the partition
            if name in cache.bad_mirrors.get(piece, ()):
                continue
            mirror = self.origin_set.origins[name]
            data = mirror.read_piece(piece)   # mirror egress, even if bad
            self.origin.record_served(piece, cache.name, float(self.rounds))
            self._count_cross_pod(name, cache.name, size)  # fills ride the spine
            if tel.enabled:
                tel.emit(
                    "request_issued", t=float(self.rounds),
                    torrent=self.metainfo.name, client=cache.name,
                    origin=name, piece=piece, nbytes=size, info="fill",
                )
            if data is None:
                continue
            if not self.metainfo.verify_piece(piece, data):
                cache.fill_wasted += size
                cache.bad_mirrors.setdefault(piece, set()).add(name)
                if tel.enabled:
                    tel.emit(
                        "mirror_failover", t=float(self.rounds),
                        torrent=self.metainfo.name, client=cache.name,
                        origin=name, piece=piece, info="verify",
                    )
                continue                       # verified failover: next mirror
            cache.commit(piece, data)
            if tel.enabled:
                tel.emit(
                    "cache_fill", t=float(self.rounds),
                    torrent=self.metainfo.name, client=cache.name,
                    origin=name, piece=piece, nbytes=size,
                )
            return True
        if cache.bad_mirrors.get(piece):
            # every live mirror has served bad bytes for this piece: heal
            # the exclusions so a later round retries (corrupt-once heals)
            del cache.bad_mirrors[piece]
        return False

    def _serviceable_availability(self, me: PeerAgent, base):
        """Free-riders hold replicas nobody can trade for: subtract their
        haves from the fallback's availability view so the pieces they
        monopolize stay HTTP-eligible (the time engine does the same
        through :meth:`SwarmSim._serviceable_availability`). ``base`` is
        the pod-local view when a cache tier is up, else None (the agent's
        own view); returned unchanged when no adversary is declared."""
        if self.adversary is None or not self.adversary.free_riders:
            return base
        avail = (base if base is not None else me.availability).copy()
        my_pod = self.pod_of.get(me.peer_id)
        for rid in self.adversary.free_riders:
            if (rid == me.peer_id or rid in self.departed
                    or rid in self.banned):
                continue
            if base is not None and self.pod_of.get(rid) != my_pod:
                continue  # pod-local view only counts same-pod holders
            rider = self.peers.get(rid)
            if rider is not None:
                avail -= rider.bitfield.as_array().astype(avail.dtype)
        return np.maximum(avail, 0)

    def _http_fetch(self, me: PeerAgent, pid: str) -> Optional[int]:
        """One verified range read from the origin fabric; returns the
        piece on success, None when nothing is eligible or every endpoint's
        range failed verification (re-fetched on a later attempt)."""
        from .webseed import PodCacheOrigin

        cache = (
            self.pod_caches.get(self.pod_of.get(pid))
            if self.pod_caches else None
        )
        if cache is not None and cache.pod in self._failed_pods:
            cache = None  # a failed pod's cache serves nothing
        req = next(
            (a for a in self.scheduler.next_actions(ClientView(
                agent=me, peer_path=False, http_slots=1, cache=cache,
                mask=self.needed.get(pid),
                availability=self._serviceable_availability(
                    me,
                    # a banned peer is cut from the pod mesh: its fallback
                    # eligibility keys off its own (empty) neighborhood, or
                    # it could never finish
                    self._local_availability(me)
                    if self.pod_caches and pid not in self.banned else None,
                ),
                round_based=True,
            )) if a.kind == "http"),
            None,
        )
        if req is None:
            return None
        piece = req.piece
        size = self.metainfo.piece_size(piece)
        tel = self.telemetry
        for origin in req.targets:
            if (
                self._partition is not None
                and not isinstance(origin, PodCacheOrigin)
                and not self._same_side(pid, origin.name)
            ):
                continue  # mirror across the partition: unreachable
            if isinstance(origin, PodCacheOrigin):
                if not self._fill_cache(origin, piece):
                    continue
                data = origin.read_piece(piece)   # cache egress + fault hook
                # cache -> client stays inside the pod: no cross-pod bytes
                if tel.enabled:
                    tel.emit(
                        "request_issued", t=float(self.rounds),
                        torrent=self.metainfo.name, client=pid,
                        origin=origin.name, piece=piece, nbytes=size,
                        info="http",
                    )
            else:
                # cross-torrent fairness: a torrent leading its weighted
                # share defers this mirror read to the deficited torrent
                # and retries on a later round (the byte-domain analogue
                # of an admission rejection + backoff)
                if not self.scheduler.fair_allow(origin.name, size):
                    continue
                # hedging is mirror-tier insurance: it arms exactly when a
                # mirror ends up serving (no cache, or the cache path was
                # skipped/spilled) — the same non-cache branch the
                # time-domain engine hedges in, with the pair chosen by the
                # shared scheduler logic
                hedge = self.scheduler.plan_hedge(
                    me, piece, origin, req.targets,
                    mask=self.needed.get(pid),
                )
                # the hedge duplicate is origin service too: it must clear
                # the cross-torrent gate or the request runs unhedged
                if hedge is not None and (
                    self._partition is None
                    or self._same_side(pid, hedge.name)
                ) and self.scheduler.fair_allow(
                    hedge.name, size
                ):
                    return self._http_fetch_hedged(
                        me, pid, piece, [origin, hedge]
                    )
                data = origin.read_piece(piece)
                self.scheduler.fair_record(origin.name, size)
                self.origin.record_served(piece, pid, float(self.rounds))
                self._count_cross_pod(origin.name, pid, size)
                if tel.enabled:
                    tel.emit(
                        "request_issued", t=float(self.rounds),
                        torrent=self.metainfo.name, client=pid,
                        origin=origin.name, piece=piece, nbytes=size,
                        info="http",
                    )
            if me.accept_piece(
                piece, f"{origin.name}::http", data, float(self.rounds)
            ):
                if tel.enabled:
                    tel.emit(
                        "piece_done", t=float(self.rounds),
                        torrent=self.metainfo.name, client=pid,
                        origin=origin.name, piece=piece, nbytes=size,
                        info="http",
                    )
                self._commit_gain(pid, piece)
                return piece
            if tel.enabled:
                tel.emit(
                    "piece_failed", t=float(self.rounds),
                    torrent=self.metainfo.name, client=pid,
                    origin=origin.name, piece=piece,
                    info="verify" if me.last_reject_verify else "duplicate",
                )
            if me.last_reject_verify:
                if isinstance(origin, PodCacheOrigin):
                    if self.repair is not None:
                        # read-repair: the cache replica is poisoned —
                        # evict so the next miss refills from a mirror
                        origin.evict(piece)
                        self.repair.note_evict(
                            origin.name, piece, float(self.rounds)
                        )
                elif tel.enabled:
                    tel.emit(
                        "mirror_failover", t=float(self.rounds),
                        torrent=self.metainfo.name, client=pid,
                        origin=origin.name, piece=piece, info="verify",
                    )
                continue  # bad bytes from this endpoint: fail over to the next
            return None
        return None

    def _http_fetch_hedged(
        self, me: PeerAgent, pid: str, piece: int, pair: list
    ) -> Optional[int]:
        """Tail-latency insurance, round-based: range-read the tail piece
        from the top *two* ranked mirrors in the same round. Both reads are
        accounted as mirror egress; the first verified arrival is committed
        (exactly once — the loser is never offered to the ledger) and the
        loser's bytes are ledgered as ``hedge_cancelled``."""
        size = self.metainfo.piece_size(piece)
        tel = self.telemetry
        reads = []
        for i, origin in enumerate(pair):
            data = origin.read_piece(piece)
            self.scheduler.fair_record(origin.name, size)
            self._count_cross_pod(origin.name, pid, size)
            reads.append((origin, data))
            if tel.enabled:
                tel.emit(
                    "request_issued" if i == 0 else "hedge_fired",
                    t=float(self.rounds), torrent=self.metainfo.name,
                    client=pid, origin=origin.name, piece=piece, nbytes=size,
                    info="http",
                )
        got = None
        for origin, data in reads:
            if got is not None:
                origin.hedge_cancelled += size
                if tel.enabled:
                    tel.emit(
                        "hedge_cancelled", t=float(self.rounds),
                        torrent=self.metainfo.name, client=pid,
                        origin=origin.name, piece=piece, nbytes=size,
                    )
                continue
            self.origin.record_served(piece, pid, float(self.rounds))
            if me.accept_piece(
                piece, f"{origin.name}::http", data, float(self.rounds)
            ):
                got = origin
                if tel.enabled:
                    tel.emit(
                        "piece_done", t=float(self.rounds),
                        torrent=self.metainfo.name, client=pid,
                        origin=origin.name, piece=piece, nbytes=size,
                        info="http",
                    )
                self._commit_gain(pid, piece)
        return piece if got is not None else None

    def step(self) -> int:
        """One round; returns number of pieces moved."""
        self.rounds += 1
        for pid in self._deferred_departures.pop(self.rounds, []):
            self.fail_peer(pid)
        if self.quarantine is not None:
            for pid in self.quarantine.due_parole(float(self.rounds)):
                self._parole_peer(pid)
        budget = {pid: self.upload_slots for pid in self.peers}
        budget["origin"] = self.origin_slots
        http_budget = self.webseed.max_concurrent if self.webseed else 0
        moved = 0
        order = sorted(self.peers)
        self.rng.shuffle(order)

        for pid in order:
            me = self.peers[pid]
            if pid in self.departed or self._peer_done(pid):
                continue
            mask = self.needed.get(pid)
            peer_mask = mask
            routed = self.scheduler.swarm_routed
            if routed is not None:
                peer_mask = routed if mask is None else mask & routed
            for _ in range(me.pipeline):
                sources = [
                    (oid, nb) for oid, nb in sorted(me.neighbors.items())
                    if budget.get(oid, 0) > 0
                ]
                self.rng.shuffle(sources)
                if self.pod_caches:
                    # the cache tier isolates pods: peer traffic stays on
                    # leaf links; pieces enter the pod via cache fills
                    my_pod = self.pod_of.get(pid)
                    sources = [
                        (oid, nb) for oid, nb in sources
                        if self.pod_of.get(oid) == my_pod
                    ]
                elif self.pod_of:
                    # locality preference without isolation: same-pod
                    # sources first (stable partition keeps the shuffle
                    # within each tier, and RNG consumption unchanged)
                    my_pod = self.pod_of.get(pid)
                    sources.sort(
                        key=lambda kv: self.pod_of.get(kv[0]) != my_pod
                    )
                if self.adversary is not None and self.adversary.free_riders:
                    # free-riders never serve (the byte engine has no
                    # choker, so the exclusion is the leverage mechanism)
                    sources = [
                        (oid, nb) for oid, nb in sources
                        if oid not in self.adversary.free_riders
                    ]
                if self._partition is not None:
                    sources = [
                        (oid, nb) for oid, nb in sources
                        if self._same_side(pid, oid)
                    ]
                got = None
                for oid, nb in sources:
                    piece = self.scheduler.select_peer_piece(
                        me, nb.bitfield, peer_mask
                    )
                    if piece is None:
                        continue
                    src = self._agent(oid)
                    data = src.read_piece(piece)
                    if data is None:
                        continue
                    # Byzantine poisoning: the serving peer corrupts the
                    # bytes on the wire; its at-rest replica stays good
                    poisoned = (
                        self.adversary is not None and oid != "origin"
                        and self.adversary.poisons(oid)
                    )
                    if poisoned:
                        data = bytes([data[0] ^ 0xFF]) + data[1:]
                        self.adversary.poisoned_pieces += 1
                        if self.telemetry.enabled:
                            self.telemetry.emit(
                                "piece_poisoned", t=float(self.rounds),
                                torrent=self.metainfo.name, client=pid,
                                origin=oid, piece=piece,
                                nbytes=float(
                                    self.metainfo.piece_size(piece)
                                ),
                            )
                    if self.telemetry.enabled:
                        self.telemetry.emit(
                            "request_issued", t=float(self.rounds),
                            torrent=self.metainfo.name, client=pid,
                            origin=oid, piece=piece,
                            nbytes=float(self.metainfo.piece_size(piece)),
                            info="peer",
                        )
                    if me.accept_piece(piece, oid, data, float(self.rounds)):
                        src.record_served(piece, pid, float(self.rounds))
                        self._count_cross_pod(
                            oid, pid, self.metainfo.piece_size(piece)
                        )
                        budget[oid] -= 1
                        moved += 1
                        got = piece
                        self._commit_gain(pid, piece)
                        if self.telemetry.enabled:
                            self.telemetry.emit(
                                "piece_done", t=float(self.rounds),
                                torrent=self.metainfo.name, client=pid,
                                origin=oid, piece=piece,
                                nbytes=float(self.metainfo.piece_size(piece)),
                                info="peer",
                            )
                    else:
                        if self.repair is not None and not poisoned \
                                and me.last_reject_verify and oid != "origin":
                            # read-repair: the peer's at-rest replica is
                            # poisoned — evict it before it spreads
                            if src.store is not None:
                                src.store.pop(piece, None)
                            if piece in src.bitfield:
                                src.bitfield.clear(piece)
                                spod = self.pod_of.get(oid)
                                if self._pod_have is not None \
                                        and spod in self._pod_have:
                                    self._pod_have[spod][piece] -= 1
                            self.repair.note_evict(
                                oid, piece, float(self.rounds)
                            )
                        if self.telemetry.enabled:
                            self.telemetry.emit(
                                "piece_failed", t=float(self.rounds),
                                torrent=self.metainfo.name, client=pid,
                                origin=oid, piece=piece,
                                info="verify" if me.last_reject_verify
                                else "duplicate",
                            )
                        if self.quarantine is not None \
                                and me.last_reject_verify \
                                and oid != "origin":
                            # verify failure attributed to the source:
                            # strike it, ban past the threshold
                            if self.quarantine.record_failure(
                                oid,
                                float(self.metainfo.piece_size(piece)),
                                float(self.rounds),
                            ):
                                self._ban_peer(oid)
                    break
                if got is None and self.web_origin is not None and http_budget > 0:
                    got = self._http_fetch(me, pid)
                    if got is not None:
                        http_budget -= 1
                        moved += 1
                if got is None:
                    break
        self._note_completions()
        return moved

    def _note_completions(self) -> None:
        """Record the round each peer first satisfied its needed set — the
        byte-domain completion time the ingest reports summarize into
        tail-latency percentiles."""
        for pid in self.peers:
            if pid not in self.completed_round and self._peer_done(pid):
                self.completed_round[pid] = self.rounds
                if self.telemetry.enabled:
                    self.telemetry.emit(
                        "peer_complete", t=float(self.rounds),
                        torrent=self.metainfo.name, client=pid,
                    )

    def completion_percentiles(
        self, ps: Sequence[float] = (50, 95, 99)
    ) -> dict[str, float]:
        """Per-peer tail latency in rounds: {"p50", "p95", "p99"} of the
        round each peer completed in. Raises when no peer completed."""
        self._note_completions()
        if not self.completed_round:
            raise ValueError(
                "completion_percentiles: no peer has completed"
            )
        return percentiles(self.completed_round.values(), ps)

    # a zero-move round is not necessarily a stall: the verified-failover
    # paths legitimately burn a round or two excluding bad endpoints and
    # healing (corrupt-once origins recover on the retry)
    MAX_IDLE_ROUNDS = 3

    def run(self, max_rounds: int = 100_000) -> int:
        idle = 0
        while not self.complete:
            if self.rounds >= max_rounds:
                raise RuntimeError("LocalSwarm did not converge")
            idle = idle + 1 if self.step() == 0 else 0
            if idle > self.MAX_IDLE_ROUNDS and not self.complete:
                raise RuntimeError("LocalSwarm stalled (no eligible transfer)")
        return self.rounds

    def ledgers(self) -> dict[str, Ledger]:
        out = {pid: a.ledger for pid, a in self.peers.items()}
        out["origin"] = self.origin.ledger
        return out

    @property
    def http_uploaded(self) -> float:
        """Mirror-tier bytes served over HTTP ranges — direct serves plus
        pod-cache fills (0 without a web seed)."""
        return self.origin_set.http_uploaded if self.origin_set else 0.0

    @property
    def pod_cache_uploaded(self) -> float:
        """Bytes the pod-cache tier served into its pods over HTTP ranges."""
        return sum(c.http_uploaded for c in self.pod_caches.values())

    @property
    def hedge_cancelled_bytes(self) -> float:
        """Bytes spent on losing hedge duplicates across the origin tier."""
        if self.origin_set is None:
            return 0.0
        return sum(
            o.hedge_cancelled for o in self.origin_set.origins.values()
        ) + sum(c.hedge_cancelled for c in self.pod_caches.values())

    @property
    def ud_ratio(self) -> float:
        up = self.origin.ledger.uploaded
        down = sum(a.ledger.downloaded for a in self.peers.values())
        return down / up if up > 0 else float("inf")
