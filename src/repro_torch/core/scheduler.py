"""Unified delivery scheduler: one decision core for both swarm engines.

Before this module existed, the two engines (`repro_torch.core.swarm.SwarmSim` /
`WebSeedSwarmSim` in the time domain, `repro_torch.core.swarm.LocalSwarm` in the
byte domain) each carried a private copy of piece selection, ranked-origin
choice, endgame duplication, retry/backoff, and verified-failover
bookkeeping — so every new scheduling behaviour had to be implemented twice
and could drift. :class:`TransferScheduler` owns all of that per-client
decision state behind a narrow engine-facing interface:

* ``next_actions(view) -> [Request]`` — given a :class:`ClientView` (the
  engine's snapshot of one client: its :class:`~repro_torch.core.peer.PeerAgent`
  decision state, free HTTP pipeline slots, serving endpoints, and the
  choke state baked into ``NeighborState.unchokes_me`` by
  :mod:`repro_torch.core.choking`), emit the transfers the client should start.
  Peer-path requests are emitted in bulk; HTTP requests are emitted **one
  per call** because origin admission outcomes feed back into the next
  piece choice (the engine loops while it has pipeline slots and the last
  request was admitted).
* ``on_piece_done(client, piece, origin, accepted=..., verify_failed=...,
  latency=...)`` — outcome bookkeeping: clears the verified-failover
  exclusions on success, extends them when an endpoint served bytes that
  failed verification, and folds the fetch latency into the tail-latency
  ledger.
* ``on_piece_failed(client, piece)`` — an aborted transfer (endpoint died
  mid-range); decision state for the piece is reset so the next
  ``next_actions`` re-plans it.
* ``on_origin_dead(name)`` — a mirror left the fabric: drop it from
  ranking and dissolve any hedge pairs it was part of.

The scheduler is also where **client-side mirror hedging** lives — the
HTTP analogue of endgame mode. In the tail of a download
(``OriginPolicy.hedge_tail_fraction`` of the piece space still missing),
``plan_hedge`` duplicates a range request to the next ranked mirror after
``hedge_delay`` seconds; both flows are accounted, the first verified
arrival wins, and the loser's bytes are ledgered separately
(``hedge_cancelled`` per origin, ``SwarmStats.hedge_cancelled_bytes`` in
aggregate) — tail-latency insurance priced in bytes. ``percentiles``
is the shared tail-latency summary used by ``SwarmResult``,
``SwarmStats``, and the data-pipeline ingest reports.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from . import piece_selection as ps
from .metainfo import MetaInfo
from .telemetry import NULL_RECORDER

# --------------------------------------------------------------------------- spec (de)serialization


def spec_from_dict(cls, data: dict):
    """Strict, typed dataclass construction from a plain (JSON) dict.

    Unknown keys raise ``ValueError`` (a typo must never silently produce a
    default), scalar fields are coerced to their declared type (JSON has no
    int/float distinction), and ``None`` passes through for Optional
    fields. Composite specs (nested dataclasses, tuples) convert their
    children first and hand this helper the leaf-ready dict.
    """
    if not isinstance(data, dict):
        raise ValueError(f"{cls.__name__}: expected a mapping, got {data!r}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - set(fields))
    if unknown:
        raise ValueError(
            f"{cls.__name__}: unknown keys {unknown} "
            f"(valid: {sorted(fields)})"
        )
    kwargs = {}
    for key, val in data.items():
        t = str(fields[key].type)
        if val is None:
            kwargs[key] = None
        elif "bool" in t:
            kwargs[key] = bool(val)
        elif "float" in t:
            kwargs[key] = float(val)
        elif "int" in t:
            kwargs[key] = int(val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


def spec_to_dict(obj) -> dict:
    """Flat field dict of a leaf spec dataclass (inverse of
    :func:`spec_from_dict` for scalar-only specs)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


# --------------------------------------------------------------------------- policy


@dataclasses.dataclass
class OriginPolicy:
    """Origin serving + request re-routing policy.

    The full knob table lives in :mod:`repro_torch.core.webseed` (and
    ``docs/ARCHITECTURE.md``); the hedging knobs are scheduler-owned:

    ======================  ==================================================
    ``hedge``               Enable client-side mirror hedging (default off —
                            all pre-hedging configurations are bit-identical
                            with this False).
    ``hedge_tail_fraction`` Fraction of the piece space that counts as the
                            download *tail*: hedging arms once the client's
                            missing set is at most this fraction of all
                            pieces (at least one piece).
    ``hedge_delay``         Seconds to wait after the primary range request
                            before issuing the duplicate (0 = hedge
                            immediately; >0 only hedges requests that are
                            actually slow).
    ``cache_spillover``     Let clients fall back to the ranked mirror tier
                            when their pod cache rejects admission
                            (capacity-planning escape valve; default off —
                            the cache is the pod's only doorway).
    ``fairness``            Scheduler-level sharing of the origin uplinks
                            across *concurrent torrents* (multi-manifest
                            scenarios): ``"none"`` admits first-come
                            first-served; ``"weighted"`` arbitrates every
                            mirror admission through a shared
                            :class:`FairShareLedger` so each torrent's
                            granted origin bytes track its configured
                            weight (Jain index ~1 for equal weights).
    ======================  ==================================================
    """

    mode: str = "swarm_first"          # "swarm_first" | "http_first"
    swarm_fraction: float = 1.0
    origin_up_bps: float = 50e6
    max_concurrent: int = 256
    backoff: float = 2.0
    http_pipeline: int = 1
    http_fallback: bool = True
    serve_peer_protocol: bool = False
    selection: str = "static"          # "static" | "least_loaded" | "ewma"
    hedge: bool = False
    hedge_tail_fraction: float = 0.05
    hedge_delay: float = 0.0
    cache_spillover: bool = False
    fairness: str = "none"             # "none" | "weighted"

    def __post_init__(self) -> None:
        if self.mode not in ("swarm_first", "http_first"):
            raise ValueError(f"unknown origin policy mode {self.mode!r}")
        if not 0.0 <= self.swarm_fraction <= 1.0:
            raise ValueError("swarm_fraction must be in [0, 1]")
        if self.max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if self.http_pipeline < 1:
            raise ValueError("http_pipeline must be >= 1")
        if self.selection not in ("static", "least_loaded", "ewma"):
            raise ValueError(f"unknown mirror selection {self.selection!r}")
        if not 0.0 < self.hedge_tail_fraction <= 1.0:
            raise ValueError("hedge_tail_fraction must be in (0, 1]")
        if self.hedge_delay < 0.0:
            raise ValueError("hedge_delay must be >= 0")
        if self.fairness not in ("none", "weighted"):
            raise ValueError(f"unknown fairness mode {self.fairness!r}")


def swarm_routed_mask(metainfo: MetaInfo, fraction: float) -> np.ndarray:
    """Per-piece route assignment: True => swarm path, False => HTTP path.

    Derived from each piece's content hash, so the assignment is stable
    across runs and *nested* across fractions (the swarm set at f1 is a
    subset of the set at f2 > f1) — which makes origin egress monotone in
    ``fraction`` by construction.
    """
    n = metainfo.num_pieces
    if fraction >= 1.0:
        return np.ones(n, dtype=bool)
    if fraction <= 0.0:
        return np.zeros(n, dtype=bool)
    scores = np.fromiter(
        (int.from_bytes(h[:8], "big") / 2.0**64 for h in metainfo.piece_hashes),
        dtype=np.float64, count=n,
    )
    return scores < fraction


# --------------------------------------------------------------------------- tail latency


def percentiles(
    values: Iterable[float], ps_: Sequence[float] = (50, 95, 99)
) -> dict[str, float]:
    """Tail-latency summary: {"p50": ..., "p95": ..., "p99": ...}.

    Returns ``{}`` for an empty sample (ledger-style callers); the
    ``SwarmResult`` helpers raise instead — see
    :meth:`repro_torch.core.swarm.SwarmResult.completion_percentiles`.
    """
    vals = list(values)
    if not vals:
        return {}
    arr = np.percentile(np.asarray(vals, dtype=np.float64), list(ps_))
    # :g keeps integer percentiles as "p99" while "p99.9" stays distinct
    return {f"p{p:g}": float(v) for p, v in zip(ps_, arr)}


def jain_index(values: Iterable[float]) -> float:
    """Jain's fairness index (sum x)^2 / (n * sum x^2) in (0, 1].

    1.0 means perfectly equal shares; 1/n means one participant got
    everything. The multi-torrent scenarios report it over per-torrent
    weight-normalized origin service.
    """
    vals = np.asarray(list(values), dtype=np.float64)
    if vals.size == 0:
        raise ValueError("jain_index: empty sample")
    denom = float(vals.size * np.square(vals).sum())
    if denom == 0.0:
        return 1.0  # nobody got anything: trivially equal
    return float(np.square(vals.sum()) / denom)


# --------------------------------------------------------------------------- fairness


class FairShareLedger:
    """Weighted fair sharing of origin uplinks across concurrent torrents.

    One ledger is shared by every per-torrent :class:`TransferScheduler` of
    a multi-torrent run. It implements deficit-style arbitration at the
    *admission* boundary (the scheduler-level analogue of weighted fair
    queueing): for each origin it tracks the bytes granted to each torrent,
    and :meth:`allow` admits a request only while the asking torrent's
    weight-normalized service does not lead the most-deficited *live*
    contender by more than one request's worth. A denied client backs off
    and retries exactly like an admission rejection, so the mechanism is
    work-conserving up to the policy backoff; torrents whose demand is
    exhausted (``live()`` false) stop counting as contenders and their
    share is redistributed.
    """

    def __init__(self) -> None:
        self.weights: dict[str, float] = {}
        self._live: dict[str, Callable[[], bool]] = {}
        # (origin name, torrent) -> bytes granted at admission time (telemetry)
        self.granted: dict[tuple[str, str], float] = {}
        # (origin name, torrent) -> weight-normalized service level used for
        # arbitration. Distinct from granted/weight: a torrent observed with
        # NO live demand is marked dormant, and on resuming is
        # fast-forwarded to the current floor (WFQ virtual time — idle past
        # earns no credit, so a late joiner neither starves the fabric
        # before arriving nor floods it catching up). Continuously
        # backlogged torrents are never fast-forwarded: their transient
        # normalized lag is exactly the deficit the weights entitle them to.
        self._service: dict[tuple[str, str], float] = {}
        self._dormant: set[str] = set()
        # fairness denials per torrent (telemetry; origin counters untouched)
        self.deferred: dict[str, int] = {}
        # flight recorder (scenario builder swaps in a live one)
        self.telemetry = NULL_RECORDER

    def register(
        self, torrent: str, weight: float, live: Callable[[], bool]
    ) -> None:
        if weight <= 0:
            raise ValueError(f"torrent {torrent!r}: weight must be positive")
        if torrent in self.weights:
            raise ValueError(f"duplicate torrent {torrent!r}")
        self.weights[torrent] = float(weight)
        self._live[torrent] = live
        self.deferred[torrent] = 0

    def _normalized(self, origin_name: str, torrent: str) -> float:
        return self._service.get((origin_name, torrent), 0.0)

    def _contenders(self, torrent: str) -> list[str]:
        """Torrents with live demand (the asker always counts). Torrents
        observed demand-less are marked dormant for the resume rule."""
        out = []
        for t, live in self._live.items():
            alive = live()
            if not alive:
                self._dormant.add(t)
            if t == torrent or alive:
                out.append(t)
        return out

    def _resume(self, torrent: str) -> None:
        """A dormant torrent's demand is back: fast-forward its service at
        every origin to the most-deficited live rival's level (no credit
        for the idle past, no catch-up flood)."""
        origins = {o for (o, _) in self._service}
        for o in origins:
            rivals = [
                self._normalized(o, t)
                for t in self.weights
                if t != torrent and (o, t) in self._service
            ]
            if rivals:
                key = (o, torrent)
                self._service[key] = max(
                    self._service.get(key, 0.0), min(rivals)
                )
        self._dormant.discard(torrent)

    def allow(self, origin_name: str, torrent: str, nbytes: float) -> bool:
        """May ``torrent`` take one more ``nbytes`` request at this origin?"""
        if torrent not in self.weights:
            return True  # unregistered torrent: fairness not in force
        contenders = self._contenders(torrent)
        if torrent in self._dormant:
            self._resume(torrent)
        if len(contenders) <= 1:
            return True
        mine = self._normalized(origin_name, torrent)
        floor = min(self._normalized(origin_name, t) for t in contenders)
        if mine - floor <= nbytes / self.weights[torrent]:
            return True
        self.deferred[torrent] += 1
        if self.telemetry.enabled:
            self.telemetry.emit(
                "admission_deferred", torrent=torrent, origin=origin_name,
                nbytes=float(nbytes), info="fairness",
            )
        return False

    def record(self, origin_name: str, torrent: str, nbytes: float) -> None:
        """Ledger one granted admission (bytes are committed to the wire)."""
        if torrent not in self.weights:
            return
        self._contenders(torrent)          # refresh dormancy observations
        if torrent in self._dormant:
            self._resume(torrent)
        key = (origin_name, torrent)
        self.granted[key] = self.granted.get(key, 0.0) + float(nbytes)
        self._service[key] = (
            self._service.get(key, 0.0) + float(nbytes) / self.weights[torrent]
        )
        if self.telemetry.enabled:
            self.telemetry.emit(
                "fair_service", torrent=torrent, origin=origin_name,
                nbytes=float(nbytes), value=self._service[key],
            )

    def granted_by_torrent(self) -> dict[str, float]:
        """Total origin bytes granted per torrent, across all origins."""
        out = {t: 0.0 for t in self.weights}
        for (_, torrent), nbytes in self.granted.items():
            out[torrent] = out.get(torrent, 0.0) + nbytes
        return out


# --------------------------------------------------------------------------- quarantine


class Quarantine:
    """Hash-fail quarantine: ban Byzantine peers, price the poisoned waste.

    Engine-independent policy core of the adversarial-resilience tier.
    Verify failures attributed to a serving *peer* (mirrors keep their own
    verified-failover path) are counted here; a peer reaching
    ``ban_threshold`` strikes is banned — engines then evict it from the
    tracker's handout index, drop its mesh connections, and stop selecting
    it as a source. ``parole_after`` (sim-seconds in the time engine,
    rounds in the byte engine) re-admits a banned peer after a cooling-off
    window; parolees return one strike below the threshold, so a single
    re-offense deterministically re-bans. ``parole_after=0`` makes bans
    permanent. Deterministic: no RNG, no wall clock, iteration-order free.
    """

    def __init__(self, ban_threshold: int = 3,
                 parole_after: float = 0.0) -> None:
        if ban_threshold < 1:
            raise ValueError("ban_threshold must be >= 1")
        if parole_after < 0:
            raise ValueError("parole_after must be >= 0")
        self.ban_threshold = int(ban_threshold)
        self.parole_after = float(parole_after)
        self.fails: dict[str, int] = {}      # peer -> strike count
        self.banned: dict[str, float] = {}   # peer -> ban sim-time
        self.wasted_bytes = 0.0              # poisoned bytes thrown away
        self.bans = 0
        self.paroles = 0

    def record_failure(self, peer_id: str, nbytes: float,
                       now: float) -> bool:
        """One verify failure attributed to ``peer_id``; ledger the wasted
        bytes. True iff this strike newly bans the peer — in-flight pieces
        of an already-banned peer settle without re-banning."""
        self.wasted_bytes += float(nbytes)
        if peer_id in self.banned:
            return False
        n = self.fails.get(peer_id, 0) + 1
        self.fails[peer_id] = n
        if n >= self.ban_threshold:
            self.banned[peer_id] = now
            self.bans += 1
            return True
        return False

    def is_banned(self, peer_id: str) -> bool:
        return peer_id in self.banned

    def due_parole(self, now: float) -> list[str]:
        """Pop and return (sorted) the banned peers whose parole window has
        elapsed; callers re-admit them engine-side (tracker re-insert,
        reconnect). Parolees keep ``ban_threshold - 1`` strikes."""
        if self.parole_after <= 0:
            return []
        due = sorted(
            p for p, t0 in self.banned.items()
            if now - t0 >= self.parole_after
        )
        for p in due:
            del self.banned[p]
            self.fails[p] = self.ban_threshold - 1
            self.paroles += 1
        return due

    def summary(self) -> dict:
        """The adversary ledger ``bench_adversarial`` pins at tolerance 0."""
        return {
            "bans": self.bans,
            "paroles": self.paroles,
            "banned_now": sorted(self.banned),
            "wasted_bytes": self.wasted_bytes,
        }


class AdversaryState:
    """Runtime identity of the scenario's Byzantine population.

    Wired onto an engine by the scenario builder (None => no adversary,
    every check short-circuits). ``poisoners`` corrupt the pieces they
    serve over the peer protocol (every upload at ``poison_rate=1``, a
    seeded-RNG fraction below that — the RNG is dedicated, so the engine's
    own stream is untouched and runs without adversaries stay
    bit-identical). ``free_riders`` never serve: the time engine gives
    them a zero-slot choker, the byte engine skips them as trade sources.
    """

    def __init__(self, poisoners=(), poison_rate: float = 1.0,
                 free_riders=(), seed: int = 0) -> None:
        if not 0.0 < poison_rate <= 1.0:
            raise ValueError("poison_rate must be in (0, 1]")
        self.poisoners = frozenset(poisoners)
        self.poison_rate = float(poison_rate)
        self.free_riders = frozenset(free_riders)
        self.rng = np.random.default_rng(seed)
        self.poisoned_pieces = 0

    def poisons(self, peer_id: str) -> bool:
        """Does this upload by ``peer_id`` get corrupted in flight?"""
        if peer_id not in self.poisoners:
            return False
        if self.poison_rate >= 1.0:
            return True
        return bool(self.rng.random() < self.poison_rate)


# --------------------------------------------------------------------------- peer planning


def plan_peer_requests(agent) -> list[tuple[str, int]]:
    """Greedy fill of ``agent``'s request pipeline from unchoked neighbors.

    Returns (source_id, piece) pairs to launch, honoring the pipeline
    depth, the per-neighbor outstanding cap, and the selection policy.
    Endgame: once every missing piece is in flight, duplicate the
    stragglers to other holders (first-finisher wins, the duplicate is
    wasted bytes — that's the cost of tail-latency insurance).

    This is the peer-path half of the scheduler core; the choke state it
    consumes (``NeighborState.unchokes_me``) is produced by
    :class:`repro_torch.core.choking.Choker`.
    """
    plans: list[tuple[str, int]] = []
    if agent.is_seed or agent.departed:
        return plans
    mine = agent._peer_path_bitfield()
    budget = agent.pipeline - len(agent.in_flight) - len(plans)
    sources = [
        (pid, nb)
        for pid, nb in sorted(agent.neighbors.items())
        if nb.unchokes_me and nb.outstanding < agent.per_peer_requests
    ]
    agent.rng.shuffle(sources)
    in_flight = set(agent.in_flight)
    for pid, nb in sources:
        if budget <= 0:
            break
        while budget > 0 and nb.outstanding < agent.per_peer_requests:
            piece = ps.select_piece(
                agent.policy,
                mine,
                nb.bitfield,
                agent.availability,
                in_flight,
                agent.rng,
                pieces_held=agent.bitfield.count(),
            )
            if piece is None:
                break
            plans.append((pid, piece))
            in_flight.add(piece)
            nb.outstanding += 1
            budget -= 1

    # endgame: all missing pieces already in flight -> insure the tail
    if budget > 0 and ps.in_endgame(mine, in_flight):
        for pid, nb in sources:
            if budget <= 0:
                break
            cand = ps.endgame_candidates(
                mine, nb.bitfield,
                agent.endgame_extra | {p for s, p in plans if s == pid},
            )
            for piece in cand.tolist():
                if budget <= 0 or nb.outstanding >= agent.per_peer_requests:
                    break
                if agent.in_flight.get(piece) == pid:
                    continue  # never duplicate to the same source
                plans.append((pid, int(piece)))
                agent.endgame_extra.add(int(piece))
                nb.outstanding += 1
                budget -= 1
    return plans


# --------------------------------------------------------------------------- interface types


@dataclasses.dataclass(frozen=True)
class Request:
    """One transfer the scheduler wants the engine to start.

    ``kind == "peer"``: request ``piece`` from neighbor ``src`` over the
    peer protocol. ``kind == "http"``: range-request ``piece`` from the
    first endpoint in ``targets`` that admits it (the engine owns admission
    and failover mechanics; ``targets`` are already ranked and filtered by
    the client's verified-failover exclusions happening engine-side).
    """

    kind: str                      # "peer" | "http"
    piece: int
    src: str = ""                  # peer path: source peer id
    targets: tuple = ()            # http path: ranked origin endpoints


@dataclasses.dataclass
class ClientView:
    """The engine's per-client snapshot handed to ``next_actions``.

    ``agent`` carries the per-client decision state (bitfield, neighbor
    choke state, availability, in-flight set, RNG). The remaining fields
    describe what the engine can serve this client with right now; the
    byte-domain engine sets ``round_based`` (lowest-index streaming picks,
    no in-flight bookkeeping) and may override ``availability`` with its
    pod-local view.
    """

    agent: object
    peer_path: bool = True
    http_slots: int = 0
    cache: object = None                        # client's pod-cache endpoint
    mirror_names: Optional[Sequence[str]] = None  # tracker-ranked discovery
    origin_live: Optional[Callable[[str], bool]] = None
    mask: Optional[np.ndarray] = None           # byte-domain needed mask
    availability: Optional[np.ndarray] = None   # overriding availability view
    round_based: bool = False


# --------------------------------------------------------------------------- scheduler


class TransferScheduler:
    """Engine-independent transfer decisions + per-client decision state.

    One instance per engine run. ``policy`` is None for a pure peer swarm
    (no HTTP tier); ``origin_set`` is the engine's
    :class:`~repro_torch.core.webseed.OriginSet` (attached after construction by
    engines that build it late). See the module docstring for the
    interface contract.
    """

    def __init__(
        self,
        metainfo: MetaInfo,
        policy: Optional[OriginPolicy] = None,
        *,
        select_policy: str = "rarest_first",
        endgame: bool = True,
        origin_set=None,
        torrent: Optional[str] = None,
        fair_share: Optional[FairShareLedger] = None,
    ):
        self.metainfo = metainfo
        self.policy = policy
        self.select_policy = select_policy
        self.endgame = endgame
        self.origin_set = origin_set
        # multi-torrent identity + the shared cross-torrent admission
        # arbiter (None for single-torrent runs: behaviour is unchanged)
        self.torrent = torrent
        self.fair_share = fair_share
        self.swarm_routed: Optional[np.ndarray] = (
            swarm_routed_mask(metainfo, policy.swarm_fraction)
            if policy is not None else None
        )
        # (client, piece) -> origins that served bytes failing verification
        self.http_bad: dict[tuple[str, int], set[str]] = {}
        # clients with a backoff retry already scheduled (dedupe)
        self._backoff_pending: set[str] = set()
        # (client, piece) -> origin names in the live hedge pair
        self.hedges: dict[tuple[str, int], set[str]] = {}
        # verified per-fetch latencies (seconds), event order
        self.fetch_latencies: list[float] = []
        # flight recorder (engines swap in a live one when telemetry is on)
        self.telemetry = NULL_RECORDER

    # ------------------------------------------------------------- entry point
    def next_actions(self, view: ClientView) -> list[Request]:
        """Transfers ``view.agent`` should start now (see module docstring).

        At most one HTTP request is emitted per call: admission outcomes
        feed back into the next piece choice, so the engine loops while it
        has free pipeline slots and the previous request was admitted.
        """
        acts: list[Request] = []
        agent = view.agent
        if view.peer_path:
            if not self.endgame:
                agent.endgame_extra.clear()
            for src, piece in plan_peer_requests(agent):
                acts.append(Request("peer", piece, src=src))
        if view.http_slots > 0 and self.policy is not None:
            targets = self.ranked_origins(
                agent.peer_id, cache=view.cache, names=view.mirror_names,
                live=view.origin_live,
            )
            if targets:
                piece = self.next_http_piece(
                    agent, mask=view.mask, availability=view.availability,
                    round_based=view.round_based,
                )
                if piece is not None:
                    acts.append(Request("http", piece, targets=tuple(targets)))
        return acts

    # ------------------------------------------------------------- http piece choice
    def next_http_piece(
        self,
        agent,
        *,
        mask: Optional[np.ndarray] = None,
        availability: Optional[np.ndarray] = None,
        round_based: bool = False,
    ) -> Optional[int]:
        """Pick the next piece this client should range-request, or None.

        Time-domain (default): in swarm_first mode, HTTP-routed pieces
        stream in index order and swarm-routed pieces are only
        HTTP-eligible as *fallback* — when no connected peer holds them —
        picked at random so a cold flash crowd pulls disjoint ranges it can
        then trade. In http_first mode every missing piece is eligible and
        the pick is random: identical clients requesting identical
        sequential ranges would hold identical piece prefixes forever, and
        nothing could ever be re-routed to a peer. Pieces already in
        flight are excluded.

        Byte-domain (``round_based=True``): lowest eligible index — the
        immediate Have propagation inside a round self-staggers concurrent
        clients; ``availability`` may be the pod-local holder counts once a
        cache tier isolates pods, and ``mask`` the partitioned-ingest
        needed set.
        """
        pol = self.policy
        avail = availability if availability is not None else agent.availability
        missing = ~agent.bitfield.as_array()
        if mask is not None:
            missing = missing & mask
        if round_based:
            if pol.mode != "http_first":
                eligible = ~self.swarm_routed
                if pol.http_fallback:
                    eligible = eligible | (avail == 0)
                missing = missing & eligible
            idx = np.flatnonzero(missing)
            return int(idx[0]) if idx.size else None
        cand = missing.copy() if pol.mode == "http_first" \
            else missing & ~self.swarm_routed
        fallback = np.zeros_like(cand)
        if pol.mode == "swarm_first" and pol.http_fallback:
            fallback = missing & self.swarm_routed & (avail == 0)
        eligible = cand | fallback
        if agent.in_flight:
            idx = np.fromiter(agent.in_flight, dtype=np.int64)
            eligible[idx] = False
            cand[idx] = False
            fallback[idx] = False
        if not eligible.any():
            return None
        routed = np.flatnonzero(cand)
        if routed.size:
            if pol.mode == "http_first":
                return int(routed[agent.rng.integers(routed.size)])
            return int(routed[0])
        cold = np.flatnonzero(fallback)
        return int(cold[agent.rng.integers(cold.size)])

    # ------------------------------------------------------------- ranked origins
    def ranked_origins(
        self,
        client_id: str,
        *,
        cache=None,
        names: Optional[Sequence[str]] = None,
        live: Optional[Callable[[str], bool]] = None,
    ) -> list:
        """Serving endpoints for ``client_id``, best first.

        The client's pod cache (when one is live) is the pod's doorway to
        the fabric and ranks alone — unless ``OriginPolicy.cache_spillover``
        lets a saturated cache spill clients over to the mirror tier, in
        which case the ranked mirrors follow it. Without a cache, the
        tracker's candidate ``names`` are re-ranked by the client-side
        ``OriginPolicy.selection`` (``OriginSet.ranked``) and filtered by
        the engine's ``live`` predicate.
        """
        out: list = []
        if cache is not None:
            out.append(cache)
            if self.policy is None or not self.policy.cache_spillover:
                return out
        if self.origin_set is None:
            return out
        for name in self.origin_set.ranked(names):
            if live is None or live(name):
                out.append(self.origin_set.origins[name])
        return out

    # ------------------------------------------------------------- peer-path piece choice
    def select_peer_piece(self, me, nb_bitfield, mask) -> Optional[int]:
        """Byte-domain peer-path selection: the configured policy, with the
        partitioned-ingest ``mask`` restricting candidates when set."""
        if mask is None:
            return ps.select_piece(
                self.select_policy, me.bitfield, nb_bitfield,
                me.availability, set(), me.rng,
                pieces_held=me.bitfield.count(),
            )
        cand = np.flatnonzero(
            nb_bitfield.as_array() & ~me.bitfield.as_array() & mask
        )
        if cand.size == 0:
            return None
        if self.select_policy == "sequential":
            return int(cand[0])
        return ps.rarest_among(cand, me.availability, me.rng)

    # ------------------------------------------------------------- outcome hooks
    def on_piece_done(
        self,
        client_id: str,
        piece: int,
        origin_name: Optional[str] = None,
        *,
        accepted: bool,
        verify_failed: bool = False,
        latency: Optional[float] = None,
    ) -> None:
        """A transfer completed. On acceptance, clear the verified-failover
        exclusions for the piece and record the fetch latency; on a
        verification failure, exclude the serving endpoint so the re-fetch
        is steered to the next ranked one."""
        if accepted:
            self.http_bad.pop((client_id, piece), None)
            if latency is not None:
                self.fetch_latencies.append(float(latency))
        elif verify_failed and origin_name is not None:
            self.http_bad.setdefault((client_id, piece), set()).add(origin_name)

    def on_piece_failed(self, client_id: str, piece: int) -> None:
        """A transfer aborted (endpoint died mid-range). The engine owns
        flow/in-flight cleanup; scheduler-side, the piece simply becomes
        plannable again — failover exclusions persist so the re-fetch skips
        endpoints that served bad bytes."""
        # state intentionally retained: http_bad steers the re-fetch, and
        # hedge pairs dissolve through hedge_loser as each flow resolves

    def on_origin_dead(self, name: str) -> None:
        """A mirror left the fabric: stop ranking it and dissolve any hedge
        pairs it was part of (its flows abort engine-side)."""
        if self.origin_set is not None:
            self.origin_set.fail(name)
        for key, pair in list(self.hedges.items()):
            pair.discard(name)
            if not pair:
                del self.hedges[key]

    # ------------------------------------------------------------- admission
    def fair_allow(self, origin_name: str, nbytes: float) -> bool:
        """Cross-torrent fairness verdict for one origin request (True when
        no fair-share ledger is in force — the single-torrent case)."""
        if self.fair_share is None or self.torrent is None:
            return True
        return self.fair_share.allow(origin_name, self.torrent, nbytes)

    def fair_record(self, origin_name: str, nbytes: float) -> None:
        """Ledger one granted origin request with the fair-share arbiter."""
        if self.fair_share is not None and self.torrent is not None:
            self.fair_share.record(origin_name, self.torrent, nbytes)

    def try_admit(self, origin, nbytes: float) -> bool:
        """Admission for one range request at a *mirror*: the cross-torrent
        fairness gate first (a denial looks like a rejection to the caller
        — back off and retry — but is ledgered scheduler-side, not against
        the origin), then the origin's own admission cap."""
        if not self.fair_allow(origin.name, nbytes):
            return False
        if not origin.try_admit():
            if self.telemetry.enabled:
                self.telemetry.emit(
                    "admission_deferred", torrent=self.torrent,
                    origin=origin.name, nbytes=float(nbytes), info="capacity",
                )
            return False
        self.fair_record(origin.name, nbytes)
        return True

    # ------------------------------------------------------------- failover bookkeeping
    def bad_origins(self, client_id: str, piece: int) -> set[str]:
        """Endpoints that served this client bad bytes for this piece."""
        return self.http_bad.get((client_id, piece), set())

    def heal_bad(self, client_id: str, piece: int) -> None:
        """Every live endpoint failed verification for this piece: forget
        the exclusions so a later retry can re-fetch (corrupt-once origins
        recover)."""
        self.http_bad.pop((client_id, piece), None)

    # ------------------------------------------------------------- backoff bookkeeping
    def schedule_backoff(self, client_id: str) -> bool:
        """True when the engine should schedule a backoff retry for this
        client (dedupe: at most one pending retry per client)."""
        if client_id in self._backoff_pending:
            return False
        self._backoff_pending.add(client_id)
        return True

    def backoff_fired(self, client_id: str) -> None:
        self._backoff_pending.discard(client_id)

    # ------------------------------------------------------------- hedging
    def hedge_eligible(self, agent, mask: Optional[np.ndarray] = None) -> bool:
        """In the download tail? (missing set at most ``hedge_tail_fraction``
        of the client's workload, and nonempty). ``mask`` restricts the
        workload to the client's needed set (partitioned ingest) — without
        it a partitioned client would never look tail-shaped."""
        pol = self.policy
        if pol is None or not pol.hedge:
            return False
        if mask is None:
            total = self.metainfo.num_pieces
            held = agent.bitfield.count()
        else:
            total = int(mask.sum())
            held = int((agent.bitfield.as_array() & mask).sum())
        missing = total - held
        return 0 < missing <= max(1, math.ceil(pol.hedge_tail_fraction * total))

    def plan_hedge(
        self,
        agent,
        piece: int,
        primary,
        targets,
        mask: Optional[np.ndarray] = None,
    ) -> Optional[object]:
        """The mirror to duplicate this tail request to, or None.

        The hedge target is the best-ranked endpoint after ``primary`` that
        is a root mirror (caches never hedge — they are the pod's single
        doorway), is not excluded for this piece, and is not already part
        of a hedge pair for it. ``mask`` scopes the tail test to the
        client's needed set (byte-domain partitioned ingest).
        """
        if not self.hedge_eligible(agent, mask=mask):
            return None
        key = (agent.peer_id, piece)
        if key in self.hedges:
            return None
        bad = self.http_bad.get(key, set())
        for origin in targets:
            if origin.name == primary.name:
                continue
            if getattr(origin, "pod", None) is not None:
                continue
            if origin.name in bad:
                continue
            return origin
        return None

    def register_hedge(
        self, client_id: str, piece: int, primary_name: str, hedge_name: str
    ) -> None:
        self.hedges[(client_id, piece)] = {primary_name, hedge_name}

    def hedge_loser(self, client_id: str, piece: int, origin_name: str) -> bool:
        """Resolve one member of a hedge pair. Returns True when the flow
        belonged to a live pair — the caller decides (from whether the
        client already holds the piece) if it lost and should ledger its
        bytes as hedge-cancelled."""
        key = (client_id, piece)
        pair = self.hedges.get(key)
        if not pair or origin_name not in pair:
            return False
        pair.discard(origin_name)
        if not pair:
            del self.hedges[key]
        return True

    def hedge_partner(self, client_id: str, piece: int) -> Optional[str]:
        """The surviving member of a partially-resolved hedge pair, or None.
        Used when one pair member aborts: the engine hands the in-flight
        slot to the partner instead of re-requesting the piece."""
        pair = self.hedges.get((client_id, piece))
        if pair and len(pair) == 1:
            return next(iter(pair))
        return None
