"""Declarative ScenarioSpec API: one serializable config, both engines.

Every experiment in this repo used to be hand-assembled imperatively —
``WebSeedSwarmSim(...)`` + ``add_mirrors(...)`` + ``add_pod_caches(...)``
with a ``fail_mirror`` buried mid-sweep — across dozens of call sites that
drifted independently. This module makes a *scenario* a first-class,
serializable value: a :class:`ScenarioSpec` tree that round-trips through
JSON, validates eagerly (unknown keys and nonsense values raise, they never
silently become defaults), and compiles to either engine:

* ``spec.build("time")`` — the fluid-network engine
  (:class:`~repro_torch.core.webseed.WebSeedSwarmSim`): completion times, origin
  load, tail latency, the tracker ledger.
* ``spec.build("byte")`` — the byte-accurate round engine
  (:class:`~repro_torch.core.swarm.LocalSwarm`): real verified bytes end to end.
* ``spec.build("fleet")`` — the vectorized fluid engine
  (:class:`~repro_torch.core.fleet.FleetSwarmSim`): peers as rows of arrays, for
  10k–100k-client populations the object engines cannot reach.

The spec tree mirrors how a dataset host would describe a deployment:

* :class:`ContentSpec` — one **or more** manifests. Multiple manifests make
  the scenario *multi-torrent*: every torrent's flows share one fluid
  network and the same physical mirror uplinks, one tracker serves all
  infohashes, and ``OriginPolicy.fairness="weighted"`` arbitrates origin
  admission across torrents by :class:`ManifestSpec.weight` (the
  scheduler-level fairness the ROADMAP calls for; the result reports a
  Jain index over weight-normalized origin service).
* :class:`TopologySpec` — pods × hosts, NIC capacities, the shared spine.
* :class:`FabricSpec` — the mirror tier plus the optional pod-cache tier.
* ``policy`` / ``swarm`` — the full :class:`~repro_torch.core.scheduler
  .OriginPolicy` and :class:`~repro_torch.core.swarm.SwarmConfig` knob sets,
  embedded verbatim.
* :class:`ArrivalSpec` — flash / staggered / poisson client populations,
  seeded and reproducible, optionally mapped onto the topology's hosts.
* :class:`EventSpec` — a fault/chaos timeline: ``mirror_fail@t``,
  ``mirror_heal@t``, ``peer_churn@t``, ``corrupt_once``.

Compilation is *transparent*: a single-manifest time-domain build performs
exactly the constructor/`add_*` sequence the imperative benchmarks used, so
the committed ``BENCH_*.json`` goldens stay bit-identical through this API
(pinned in CI via ``benchmarks/run.py --scenario ... --compare``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np

from .fleet import FleetResult, FleetSpec, FleetSwarmSim
from .metainfo import MetaInfo
from .netsim import FluidNetwork
from .repair import RepairController, RepairSpec
from .scheduler import (
    AdversaryState,
    FairShareLedger,
    OriginPolicy,
    Quarantine,
    jain_index,
    spec_from_dict,
    spec_to_dict,
)
from .swarm import (
    LocalSwarm,
    SwarmConfig,
    flash_crowd,
    poisson_arrivals,
    staggered_arrivals,
)
from .telemetry import (
    MetricsSampler,
    NULL_RECORDER,
    TelemetrySpec,
    TraceRecorder,
)
from .topology import ClusterTopology
from .tracker import SwarmStats, Tracker
from .webseed import MirrorSpec, WebSeedSwarmSim

def _finitize(value):
    """Replace non-finite floats with their string spellings so the
    serialized form is strict JSON (json.dumps would otherwise emit the
    non-standard ``Infinity``/``NaN`` tokens)."""
    if isinstance(value, float) and not np.isfinite(value):
        return repr(value)          # "inf" / "-inf" / "nan"
    if isinstance(value, dict):
        return {k: _finitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_finitize(v) for v in value]
    return value


ENGINES = ("time", "byte", "fleet")
ARRIVAL_KINDS = ("flash", "staggered", "poisson")
EVENT_KINDS = (
    "mirror_fail", "mirror_heal", "peer_churn", "corrupt_once",
    "churn_storm", "pod_fail",
    "tracker_fail", "tracker_heal", "partition", "partition_heal",
)
# kinds that act on a population, not a named box/client: target must be empty
UNTARGETED_EVENT_KINDS = ("churn_storm", "pod_fail",
                          "tracker_fail", "tracker_heal")
# fail kind -> the heal kind that closes its window (S2 timeline checks).
# mirror_fail/mirror_heal are deliberately NOT here: healing a mirror that
# never failed is a documented no-op (same-tick ordering tests rely on it).
PAIRED_EVENT_KINDS = {
    "tracker_fail": "tracker_heal",
    "partition": "partition_heal",
}
_HEAL_TO_FAIL = {heal: fail for fail, heal in PAIRED_EVENT_KINDS.items()}
# adversarial-resilience kinds the fleet engine has no model for
ADVERSARIAL_EVENT_KINDS = (
    "tracker_fail", "tracker_heal", "partition", "partition_heal",
)


def _parse_partition_target(target: str, num_pods: int):
    """Validate and parse a partition target: ``"spine"`` (every pod cut
    from every other pod and from the core) or ``"pods:1,3"`` (the named
    pod set isolated from the rest). Returns the isolated pod set, or
    None for a spine cut."""
    if target == "spine":
        return None
    if target.startswith("pods:"):
        body = target[len("pods:"):]
        try:
            pods = {int(p) for p in body.split(",")} if body else set()
        except ValueError:
            pods = set()
        if not pods:
            raise ValueError(
                f"partition target {target!r}: 'pods:' needs a comma-"
                "separated pod list (e.g. 'pods:0,2')"
            )
        bad = sorted(p for p in pods if p < 0 or p >= num_pods)
        if bad:
            raise ValueError(
                f"partition target {target!r} names undeclared pods "
                f"{bad} (topology has {num_pods} pods)"
            )
        return pods
    raise ValueError(
        f"unknown partition target {target!r} (use 'spine' or 'pods:i,j')"
    )
PAYLOAD_MODES = ("size_only", "random")

# --------------------------------------------------------------------------- content


@dataclasses.dataclass
class ManifestSpec:
    """One distributable bundle (torrent) in the scenario.

    ``payload="size_only"`` builds synthetic deterministic hashes (netsim
    benchmarks of multi-TB datasets); ``payload="random"`` materializes a
    deterministic random payload from ``seed`` — required by the byte
    engine and by any scenario exercising real verification (corruption
    events). ``weight`` is the torrent's share of the origin uplinks under
    ``OriginPolicy.fairness="weighted"``.
    """

    name: str
    size_bytes: int
    piece_length: int
    seed: int = 0
    payload: str = "size_only"
    weight: float = 1.0

    def __post_init__(self) -> None:
        if not self.name or not isinstance(self.name, str):
            raise ValueError("manifest name must be a non-empty string")
        if self.size_bytes <= 0:
            raise ValueError(f"manifest {self.name!r}: size_bytes must be positive")
        if self.piece_length <= 0:
            raise ValueError(
                f"manifest {self.name!r}: piece_length must be positive"
            )
        if self.payload not in PAYLOAD_MODES:
            raise ValueError(
                f"manifest {self.name!r}: payload must be one of {PAYLOAD_MODES}"
            )
        if self.weight <= 0:
            raise ValueError(f"manifest {self.name!r}: weight must be positive")

    def build(self) -> tuple[MetaInfo, Optional[dict[int, bytes]]]:
        """(metainfo, origin piece store or None for size-only)."""
        if self.payload == "random":
            data = np.random.default_rng(self.seed).integers(
                0, 256, size=self.size_bytes, dtype=np.uint8
            ).tobytes()
            mi = MetaInfo.from_bytes(data, self.piece_length, name=self.name)
            return mi, dict(mi.split_pieces(data))
        mi = MetaInfo.from_sizes_only(
            self.size_bytes, self.piece_length, name=self.name, seed=self.seed
        )
        return mi, None

    def to_dict(self) -> dict:
        return spec_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "ManifestSpec":
        return spec_from_dict(cls, data)


@dataclasses.dataclass
class ContentSpec:
    """The scenario's catalog: one or more concurrent manifests."""

    manifests: tuple[ManifestSpec, ...]

    def __post_init__(self) -> None:
        self.manifests = tuple(self.manifests)
        if not self.manifests:
            raise ValueError("ContentSpec needs at least one manifest")
        names = [m.name for m in self.manifests]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate manifest names in {names}")

    @property
    def multi(self) -> bool:
        return len(self.manifests) > 1

    def to_dict(self) -> dict:
        return {"manifests": [m.to_dict() for m in self.manifests]}

    @classmethod
    def from_dict(cls, data: dict) -> "ContentSpec":
        unknown = sorted(set(data) - {"manifests"})
        if unknown:
            raise ValueError(f"ContentSpec: unknown keys {unknown}")
        return cls(
            manifests=tuple(
                ManifestSpec.from_dict(m) for m in data.get("manifests", ())
            )
        )


# --------------------------------------------------------------------------- fabric


@dataclasses.dataclass
class PodCacheSpec:
    """Per-pod cache proxy deployment (``add_pod_caches`` arguments)."""

    up_bps: float
    down_bps: Optional[float] = None      # None => symmetric with up_bps
    max_concurrent: Optional[int] = None  # None => policy.max_concurrent

    def __post_init__(self) -> None:
        if self.up_bps <= 0:
            raise ValueError("pod cache up_bps must be positive")
        if self.down_bps is not None and self.down_bps <= 0:
            raise ValueError("pod cache down_bps must be positive")
        if self.max_concurrent is not None and self.max_concurrent < 1:
            raise ValueError("pod cache max_concurrent must be >= 1 (or None)")

    def to_dict(self) -> dict:
        return spec_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "PodCacheSpec":
        return spec_from_dict(cls, data)


@dataclasses.dataclass
class FabricSpec:
    """The delivery fabric: the mirror tier + the optional cache tier."""

    mirrors: tuple[MirrorSpec, ...]
    pod_caches: Optional[PodCacheSpec] = None

    def __post_init__(self) -> None:
        self.mirrors = tuple(self.mirrors)
        if not self.mirrors:
            raise ValueError("FabricSpec needs at least one mirror")
        names = [m.name for m in self.mirrors]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mirror names in {names}")

    def to_dict(self) -> dict:
        return {
            "mirrors": [m.to_dict() for m in self.mirrors],
            "pod_caches": (
                self.pod_caches.to_dict() if self.pod_caches else None
            ),
        }

    @classmethod
    def from_dict(cls, data: dict) -> "FabricSpec":
        unknown = sorted(set(data) - {"mirrors", "pod_caches"})
        if unknown:
            raise ValueError(f"FabricSpec: unknown keys {unknown}")
        caches = data.get("pod_caches")
        return cls(
            mirrors=tuple(
                MirrorSpec.from_dict(m) for m in data.get("mirrors", ())
            ),
            pod_caches=(
                PodCacheSpec.from_dict(caches) if caches is not None else None
            ),
        )


# --------------------------------------------------------------------------- topology


@dataclasses.dataclass
class TopologySpec:
    """Pods × hosts plus fabric capacities (compiles to ClusterTopology)."""

    num_pods: int
    hosts_per_pod: int
    host_up_bps: float = 25e9
    host_down_bps: float = 25e9
    spine_bps: Optional[float] = None
    same_pod_frac: float = 1.0

    def __post_init__(self) -> None:
        if self.num_pods < 1 or self.hosts_per_pod < 1:
            raise ValueError("topology needs >= 1 pod and >= 1 host per pod")
        if self.host_up_bps <= 0 or self.host_down_bps <= 0:
            raise ValueError("host NIC capacities must be positive")
        if self.spine_bps is not None and self.spine_bps <= 0:
            raise ValueError("spine_bps must be positive (or None)")
        if not 0.0 <= self.same_pod_frac <= 1.0:
            raise ValueError("same_pod_frac must be in [0, 1]")

    def build(self) -> ClusterTopology:
        return ClusterTopology(
            num_pods=self.num_pods, hosts_per_pod=self.hosts_per_pod,
            host_up_bps=self.host_up_bps, host_down_bps=self.host_down_bps,
            spine_bps=self.spine_bps,
        )

    def to_dict(self) -> dict:
        return spec_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "TopologySpec":
        return spec_from_dict(cls, data)


# --------------------------------------------------------------------------- arrivals


@dataclasses.dataclass
class ArrivalSpec:
    """One client population joining the scenario.

    ``kind``: ``"flash"`` (everyone at ``at``), ``"staggered"`` (every
    ``interval`` seconds from ``start``), ``"poisson"`` (rate
    ``rate_per_sec``, seeded RNG). ``torrent`` binds the group to one
    manifest (None allowed only in single-manifest scenarios).
    ``topology_hosts=True`` maps the generated arrival times onto the
    topology's ``podX/hostY`` names instead of ``prefix%04d`` ids (the
    cluster scenarios).
    """

    kind: str
    n: int
    up_bps: float
    down_bps: float
    torrent: Optional[str] = None
    at: float = 0.0
    interval: float = 0.0
    start: float = 0.0
    rate_per_sec: float = 0.0
    seed: int = 7
    prefix: str = "peer"
    seed_linger: Optional[float] = None
    topology_hosts: bool = False

    def __post_init__(self) -> None:
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(
                f"unknown arrival kind {self.kind!r} (valid: {ARRIVAL_KINDS})"
            )
        if self.n < 1:
            raise ValueError("arrival group needs n >= 1 clients")
        if self.up_bps <= 0 or self.down_bps <= 0:
            raise ValueError("client NIC capacities must be positive")
        if self.kind == "poisson" and self.rate_per_sec <= 0:
            raise ValueError("poisson arrivals need rate_per_sec > 0")
        if self.kind == "staggered" and self.interval < 0:
            raise ValueError("staggered arrivals need interval >= 0")
        if self.at < 0 or self.start < 0:
            raise ValueError("arrival times must be >= 0")
        if self.seed_linger is not None and self.seed_linger < 0:
            raise ValueError("seed_linger must be >= 0 (or None)")

    def generate(self) -> list[tuple[str, float]]:
        """The (peer_id, arrive_at) list this group contributes."""
        if self.kind == "flash":
            return flash_crowd(self.n, at=self.at, prefix=self.prefix)
        if self.kind == "staggered":
            return staggered_arrivals(
                self.n, interval=self.interval, start=self.start,
                prefix=self.prefix,
            )
        return poisson_arrivals(
            self.n, self.rate_per_sec, np.random.default_rng(self.seed),
            prefix=self.prefix,
        )

    def to_dict(self) -> dict:
        return spec_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "ArrivalSpec":
        return spec_from_dict(cls, data)


# --------------------------------------------------------------------------- events


@dataclasses.dataclass
class EventSpec:
    """One timeline entry. ``at`` is seconds (time engine) or the round
    index (byte engine). Kinds:

    * ``mirror_fail`` — hard-kill mirror ``target`` (flows abort, clients
      and caches fail over to the next ranked mirror).
    * ``mirror_heal`` — bring mirror ``target`` back as a web seed.
    * ``peer_churn`` — depart client ``target`` (time engine only).
    * ``corrupt_once`` — mirror ``target`` serves ``piece`` corrupted once,
      then heals (applied at build time; ``at`` must be 0).
    * ``churn_storm`` — ``count`` live clients depart in a burst, each
      offset by an Exponential(``spread``) session-tail draw from a
      dedicated RNG seeded with ``seed`` (no target: victims are drawn,
      not named).
    * ``pod_fail`` — correlated loss of pod ``pod``: its cache dies with
      its contents and every client homed there departs (no target).
    * ``tracker_fail`` / ``tracker_heal`` — control-plane outage window
      (no target): announces stop landing; clients keep trading on cached
      peer lists and re-announce with capped exponential backoff.
    * ``partition`` / ``partition_heal`` — network partition window.
      ``target`` is ``"spine"`` (every pod cut from every other pod and
      from the mirror core) or ``"pods:1,3"`` (the named pod set isolated
      from the rest); the heal's target must match the open partition's.

    Two events with the same ``at`` fire in their listed order. Paired
    kinds (``*_fail``/``*_heal``, ``partition``/``partition_heal``) must
    form well-nested windows — ``ScenarioSpec`` rejects a heal with no
    open window and a fail that re-opens one.
    """

    kind: str
    at: float = 0.0
    target: str = ""
    piece: int = -1
    torrent: Optional[str] = None
    # churn_storm knobs
    count: int = 0
    spread: float = 0.0
    seed: int = 0
    # pod_fail knob
    pod: int = -1

    def __post_init__(self) -> None:
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown event kind {self.kind!r} (valid: {EVENT_KINDS})"
            )
        if self.at < 0:
            raise ValueError("event time must be >= 0")
        if self.kind in UNTARGETED_EVENT_KINDS:
            if self.target:
                raise ValueError(
                    f"{self.kind} events take no target (got {self.target!r})"
                )
        elif not self.target:
            raise ValueError(f"{self.kind} event needs a target")
        if self.kind == "corrupt_once":
            if self.piece < 0:
                raise ValueError("corrupt_once needs piece >= 0")
            if self.at != 0:
                raise ValueError(
                    "corrupt_once is applied at build time; at must be 0"
                )
        if self.kind == "churn_storm":
            if self.count < 1:
                raise ValueError("churn_storm needs count >= 1")
            if self.spread < 0:
                raise ValueError("churn_storm needs spread >= 0")
        if self.kind == "pod_fail" and self.pod < 0:
            raise ValueError("pod_fail needs pod >= 0")

    def to_dict(self) -> dict:
        return spec_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "EventSpec":
        return spec_from_dict(cls, data)


# --------------------------------------------------------------------------- adversary


@dataclasses.dataclass
class AdversarySpec:
    """Byzantine population declaration (object engines only).

    ``poisoners`` names clients that corrupt every upload on the wire
    (their at-rest replicas stay good — quarantine, not read-repair, is
    the cure); ``poisoner_frac`` additionally drafts that fraction of the
    client population by a deterministic stride over the sorted id list
    (no RNG: the same spec always poisons the same clients).
    ``poison_rate`` makes poisoning intermittent: each upload corrupts
    with this probability, drawn from a dedicated RNG seeded with
    ``seed`` (the engine RNG is untouched, preserving golden
    bit-identity). ``free_riders`` names clients that download but never
    serve. ``ban_threshold`` verify failures attributed to one source
    ban it; ``parole_after`` > 0 re-admits a banned peer after that much
    sim-time (one re-offense re-bans deterministically), 0 means bans
    are permanent. ``enabled=False`` is the master off switch: the run
    is bit-identical to an adversary-free build.
    """

    enabled: bool = True
    poisoners: tuple = ()
    poisoner_frac: float = 0.0
    poison_rate: float = 1.0
    free_riders: tuple = ()
    ban_threshold: int = 3
    parole_after: float = 0.0
    seed: int = 0

    def __post_init__(self) -> None:
        self.poisoners = tuple(self.poisoners)
        self.free_riders = tuple(self.free_riders)
        if not 0.0 <= self.poisoner_frac <= 1.0:
            raise ValueError("poisoner_frac must be in [0, 1]")
        if not 0.0 < self.poison_rate <= 1.0:
            raise ValueError("poison_rate must be in (0, 1]")
        if self.ban_threshold < 1:
            raise ValueError("ban_threshold must be >= 1")
        if self.parole_after < 0:
            raise ValueError("parole_after must be >= 0")
        dup = sorted(set(self.poisoners) & set(self.free_riders))
        if dup:
            raise ValueError(
                f"clients cannot be both poisoner and free-rider: {dup}"
            )

    def to_dict(self) -> dict:
        out = spec_to_dict(self)
        out["poisoners"] = list(self.poisoners)
        out["free_riders"] = list(self.free_riders)
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "AdversarySpec":
        return spec_from_dict(cls, data)


# --------------------------------------------------------------------------- results


@dataclasses.dataclass
class TorrentOutcome:
    """Per-torrent summary of a scenario run. ``raw`` is the engine-native
    result (:class:`~repro_torch.core.swarm.SwarmResult` in the time domain, the
    :class:`~repro_torch.core.swarm.LocalSwarm` itself in the byte domain) so
    callers needing full fidelity — the pinned benchmarks — lose nothing."""

    torrent: str
    weight: float
    clients: int
    completed: int
    duration: float                       # seconds (time) / rounds (byte)
    origin_uploaded: float
    origin_http_uploaded: float
    total_downloaded: float
    ud_ratio: float
    completion_percentiles: dict[str, float]
    raw: object = None

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "raw"}
        return d


@dataclasses.dataclass
class ScenarioResult:
    """The unified result of one compiled scenario run."""

    name: str
    engine: str
    outcomes: dict[str, TorrentOutcome]
    sim_time: float                       # seconds (time) / rounds (byte)
    stats: Optional[SwarmStats] = None    # aggregate tracker scrape (time)
    # fairness telemetry (multi-torrent): per-torrent origin egress
    # snapshotted the instant the first torrent completed (the window in
    # which every torrent was demanding), and the Jain index over those
    # shares normalized by the manifest weights
    concurrent_origin_uploaded: dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    jain_fairness: Optional[float] = None
    # flight recorder (when the spec's TelemetrySpec is enabled): the shared
    # TraceRecorder and MetricsSampler of the run. Deliberately excluded from
    # to_dict — traces are exported separately (JSONL / chrome / metrics
    # blocks), never inlined into benchmark result payloads.
    trace: object = None
    metrics: object = None

    @property
    def primary(self):
        """Engine-native result of a single-torrent scenario."""
        if len(self.outcomes) != 1:
            raise ValueError(
                "primary is only defined for single-torrent scenarios; "
                f"this one has {sorted(self.outcomes)}"
            )
        return next(iter(self.outcomes.values())).raw

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "engine": self.engine,
            "sim_time": self.sim_time,
            "outcomes": {k: o.to_dict() for k, o in self.outcomes.items()},
            "concurrent_origin_uploaded": dict(
                self.concurrent_origin_uploaded
            ),
            "jain_fairness": self.jain_fairness,
            "per_torrent_uploaded": (
                dict(self.stats.per_torrent_uploaded) if self.stats else {}
            ),
        }


# --------------------------------------------------------------------------- scenario


@dataclasses.dataclass
class ScenarioSpec:
    """The root of the declarative tree. See the module docstring."""

    content: ContentSpec
    fabric: FabricSpec
    arrivals: tuple[ArrivalSpec, ...]
    policy: OriginPolicy = dataclasses.field(default_factory=OriginPolicy)
    swarm: SwarmConfig = dataclasses.field(default_factory=SwarmConfig)
    topology: Optional[TopologySpec] = None
    events: tuple[EventSpec, ...] = ()
    seed: int = 0
    name: str = "scenario"
    # byte-engine knobs (ignored by the time engine)
    byte_upload_slots: int = 4
    byte_origin_slots: int = 4
    byte_max_rounds: int = 100_000
    # flight recorder (both engines); None or enabled=False means the run
    # is trace-free and must be bit-identical to a pre-telemetry run
    telemetry: Optional[TelemetrySpec] = None
    # self-healing durability tier (time + byte engines); None or
    # enabled=False means no repair controller is wired and the run is
    # bit-identical to a repair-free build
    repair: Optional[RepairSpec] = None
    # fleet-engine knobs (ignored by the object engines); None == defaults
    fleet: Optional[FleetSpec] = None
    # Byzantine population (object engines only); None or enabled=False
    # means every adversarial code path is inert and the run is
    # bit-identical to an adversary-free build
    adversary: Optional[AdversarySpec] = None

    # ------------------------------------------------------------- validation
    def __post_init__(self) -> None:
        self.arrivals = tuple(self.arrivals)
        self.events = tuple(self.events)
        if not self.arrivals:
            raise ValueError("scenario needs at least one arrival group")
        if self.byte_upload_slots < 1 or self.byte_origin_slots < 1:
            raise ValueError("byte engine slot budgets must be >= 1")
        if self.byte_max_rounds < 1:
            raise ValueError("byte_max_rounds must be >= 1")
        mirror_names = {m.name for m in self.fabric.mirrors}
        for group in self.arrivals:
            self._check_torrent_ref(group.torrent, "arrival group")
        prefixes = [g.prefix for g in self.arrivals if not g.topology_hosts]
        if len(set(prefixes)) != len(prefixes):
            raise ValueError(
                f"arrival prefixes must be unique (peer ids collide): "
                f"{prefixes}"
            )
        host_groups = [g for g in self.arrivals if g.topology_hosts]
        if host_groups:
            if self.topology is None:
                raise ValueError("topology_hosts arrivals need a topology")
            if len(host_groups) > 1:
                raise ValueError(
                    "at most one arrival group may map onto topology hosts"
                )
            n_hosts = self.topology.num_pods * self.topology.hosts_per_pod
            if host_groups[0].n > n_hosts:
                raise ValueError(
                    f"topology_hosts arrivals: n={host_groups[0].n} exceeds "
                    f"the topology's {n_hosts} hosts"
                )
        if self.fabric.pod_caches is not None and self.topology is None:
            raise ValueError("pod caches need a topology")
        if self.content.multi and self.fabric.pod_caches is not None:
            raise ValueError(
                "multi-torrent scenarios do not support pod caches yet"
            )
        seen_events: set[tuple] = set()
        for ev in self.events:
            key = (ev.kind, ev.at, ev.target, ev.piece, ev.torrent,
                   ev.count, ev.spread, ev.seed, ev.pod)
            if key in seen_events:
                raise ValueError(
                    f"duplicate {ev.kind} event at t={ev.at} "
                    "(identical timeline entries fire twice — drop one)"
                )
            seen_events.add(key)
            self._check_torrent_ref(ev.torrent, f"{ev.kind} event")
            if ev.kind in ("mirror_fail", "mirror_heal", "corrupt_once") \
                    and ev.target not in mirror_names:
                raise ValueError(
                    f"{ev.kind} event targets unknown mirror {ev.target!r} "
                    f"(fabric has {sorted(mirror_names)})"
                )
            if ev.kind in ("mirror_fail", "mirror_heal") \
                    and self.content.multi and ev.torrent is not None:
                raise ValueError(
                    f"{ev.kind} events are fleet-wide (mirrors are shared "
                    "boxes); drop the torrent field"
                )
            if ev.kind == "corrupt_once" and self.content.multi \
                    and ev.torrent is None:
                raise ValueError(
                    "corrupt_once in a multi-torrent scenario must name "
                    "its torrent (each torrent has its own range front-end)"
                )
            if ev.kind == "peer_churn" and ev.target not in self._peer_ids():
                raise ValueError(
                    f"peer_churn event targets unknown client {ev.target!r} "
                    "(no arrival group generates that id)"
                )
            if ev.kind == "pod_fail":
                if self.topology is None:
                    raise ValueError("pod_fail events need a topology")
                if ev.pod >= self.topology.num_pods:
                    raise ValueError(
                        f"pod_fail event targets undeclared pod {ev.pod} "
                        f"(topology has {self.topology.num_pods} pods)"
                    )
            if ev.kind in ADVERSARIAL_EVENT_KINDS and self.content.multi:
                raise ValueError(
                    f"{ev.kind} events are single-torrent only for now"
                )
            if ev.kind in ("partition", "partition_heal"):
                if self.topology is None:
                    raise ValueError(f"{ev.kind} events need a topology")
                _parse_partition_target(ev.target, self.topology.num_pods)
        self._check_fault_windows()
        if self.content.multi:
            for group in self.arrivals:
                if group.torrent is None:
                    raise ValueError(
                        "multi-torrent scenarios: every arrival group must "
                        "name its torrent"
                    )
        if self.adversary is not None and self.adversary.enabled:
            if self.content.multi:
                raise ValueError(
                    "adversary tier is single-torrent only for now"
                )
            ids = self._peer_ids()
            for role, names in (
                ("poisoners", self.adversary.poisoners),
                ("free_riders", self.adversary.free_riders),
            ):
                unknown = sorted(set(names) - ids)
                if unknown:
                    raise ValueError(
                        f"adversary.{role} names unknown clients "
                        f"{unknown} (no arrival group generates them)"
                    )

    def _check_fault_windows(self) -> None:
        """Paired fault kinds must form well-nested windows: every heal
        closes an open window for the same target, a fail never re-opens
        one, and at most one partition is open at a time."""
        timeline = sorted(
            (
                ev for ev in self.events
                if ev.kind in PAIRED_EVENT_KINDS or ev.kind in _HEAL_TO_FAIL
            ),
            key=lambda e: e.at,
        )
        open_windows: set[tuple[str, str]] = set()
        open_partition: Optional[str] = None
        for ev in timeline:
            if ev.kind in PAIRED_EVENT_KINDS:      # a fail kind
                key = (ev.kind, ev.target)
                if key in open_windows:
                    raise ValueError(
                        f"{ev.kind} at t={ev.at}: window for "
                        f"{ev.target or 'tracker'!r} is already open "
                        "(heal it before failing it again)"
                    )
                if ev.kind == "partition":
                    if open_partition is not None:
                        raise ValueError(
                            f"partition at t={ev.at}: partition "
                            f"{open_partition!r} is still open (only one "
                            "may be open at a time)"
                        )
                    open_partition = ev.target
                open_windows.add(key)
            else:                                  # a heal kind
                fail_kind = _HEAL_TO_FAIL[ev.kind]
                key = (fail_kind, ev.target)
                if key not in open_windows:
                    raise ValueError(
                        f"{ev.kind} at t={ev.at} has no matching open "
                        f"{fail_kind} window for {ev.target or 'tracker'!r}"
                    )
                open_windows.discard(key)
                if ev.kind == "partition_heal":
                    open_partition = None

    def _check_torrent_ref(self, torrent: Optional[str], what: str) -> None:
        if torrent is None:
            return
        names = {m.name for m in self.content.manifests}
        if torrent not in names:
            raise ValueError(
                f"{what} references unknown torrent {torrent!r} "
                f"(content has {sorted(names)})"
            )

    def _manifest(self, torrent: Optional[str]) -> ManifestSpec:
        if torrent is None:
            return self.content.manifests[0]
        return next(
            m for m in self.content.manifests if m.name == torrent
        )

    def _group_ids(self, group: ArrivalSpec) -> set[str]:
        """Peer ids an arrival group generates (deterministic: the id
        format never depends on the arrival-time RNG)."""
        if group.topology_hosts and self.topology is not None:
            topo = self.topology.build()
            return {h.name for h in topo.hosts()[:group.n]}
        return {f"{group.prefix}{i:04d}" for i in range(group.n)}

    def _peer_ids(self) -> set[str]:
        ids: set[str] = set()
        for group in self.arrivals:
            ids |= self._group_ids(group)
        return ids

    def _torrent_of_peer(self, peer_id: str) -> str:
        """The torrent whose arrival groups generate ``peer_id``."""
        for group in self.arrivals:
            if peer_id in self._group_ids(group):
                return self._manifest(group.torrent).name
        raise ValueError(f"no arrival group generates peer {peer_id!r}")

    def resolve_poisoners(self) -> tuple:
        """The concrete poisoner id set: the explicit ``poisoners`` list
        unioned with a deterministic evenly-strided sample of
        ``poisoner_frac`` of the population (sorted ids, so the pick never
        depends on any RNG)."""
        adv = self.adversary
        if adv is None or not adv.enabled:
            return ()
        out = set(adv.poisoners)
        if adv.poisoner_frac > 0.0:
            ids = sorted(self._peer_ids())
            k = int(round(adv.poisoner_frac * len(ids)))
            if k > 0:
                out.update(ids[(i * len(ids)) // k] for i in range(k))
        return tuple(sorted(out))

    # ------------------------------------------------------------- (de)serialise
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "content": self.content.to_dict(),
            "fabric": self.fabric.to_dict(),
            "policy": spec_to_dict(self.policy),
            "swarm": self.swarm.to_dict(),
            "topology": self.topology.to_dict() if self.topology else None,
            "arrivals": [a.to_dict() for a in self.arrivals],
            "events": [e.to_dict() for e in self.events],
            "byte_upload_slots": self.byte_upload_slots,
            "byte_origin_slots": self.byte_origin_slots,
            "byte_max_rounds": self.byte_max_rounds,
            "telemetry": (
                self.telemetry.to_dict() if self.telemetry else None
            ),
            "repair": self.repair.to_dict() if self.repair else None,
            "fleet": self.fleet.to_dict() if self.fleet else None,
            "adversary": (
                self.adversary.to_dict() if self.adversary else None
            ),
        }

    @classmethod
    def from_dict(cls, data: dict) -> "ScenarioSpec":
        known = {
            "name", "seed", "content", "fabric", "policy", "swarm",
            "topology", "arrivals", "events", "byte_upload_slots",
            "byte_origin_slots", "byte_max_rounds", "telemetry", "repair",
            "fleet", "adversary",
        }
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(
                f"ScenarioSpec: unknown keys {unknown} (valid: {sorted(known)})"
            )
        if "content" not in data or "fabric" not in data \
                or "arrivals" not in data:
            raise ValueError(
                "ScenarioSpec needs 'content', 'fabric' and 'arrivals'"
            )
        topo = data.get("topology")
        kwargs = dict(
            content=ContentSpec.from_dict(data["content"]),
            fabric=FabricSpec.from_dict(data["fabric"]),
            policy=spec_from_dict(OriginPolicy, data.get("policy", {})),
            swarm=SwarmConfig.from_dict(data.get("swarm", {})),
            topology=(
                TopologySpec.from_dict(topo) if topo is not None else None
            ),
            arrivals=tuple(
                ArrivalSpec.from_dict(a) for a in data["arrivals"]
            ),
            events=tuple(
                EventSpec.from_dict(e) for e in data.get("events", ())
            ),
            name=data.get("name", "scenario"),
            seed=int(data.get("seed", 0)),
        )
        for knob in ("byte_upload_slots", "byte_origin_slots",
                     "byte_max_rounds"):
            if knob in data:
                kwargs[knob] = int(data[knob])
        tel = data.get("telemetry")
        if tel is not None:
            kwargs["telemetry"] = TelemetrySpec.from_dict(tel)
        rep = data.get("repair")
        if rep is not None:
            kwargs["repair"] = RepairSpec.from_dict(rep)
        fleet = data.get("fleet")
        if fleet is not None:
            kwargs["fleet"] = FleetSpec.from_dict(fleet)
        adv = data.get("adversary")
        if adv is not None:
            kwargs["adversary"] = AdversarySpec.from_dict(adv)
        return cls(**kwargs)

    def to_json(self, indent: int = 1) -> str:
        """Strict (RFC 8259) JSON: non-finite floats — e.g. a telemetry-only
        ``spine_bps`` of infinity — are encoded as the strings ``"inf"`` /
        ``"-inf"``, which the typed ``from_dict`` coercion parses back via
        ``float()``. No ``Infinity`` tokens ever reach the file."""
        return json.dumps(
            _finitize(self.to_dict()), indent=indent, allow_nan=False
        ) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "ScenarioSpec":
        return cls.from_json(Path(path).read_text())

    # ------------------------------------------------------------- compile
    def build(self, engine: str = "time", device=None) -> "CompiledScenario":
        """Compile to a fully-wired engine run (nothing has executed yet;
        call :meth:`CompiledScenario.run`).

        ``device`` is where the fleet engine's float32 backends run
        (``None`` = CUDA, raising without it; ``"cpu"`` = the kernels'
        plain PyTorch versions). The time and byte engines are host
        engines and take no device."""
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (valid: {ENGINES})")
        if engine == "fleet":
            return self._build_fleet(device)
        if device is not None:
            raise ValueError(
                f"the {engine} engine runs on the host; only the fleet "
                "engine takes a device"
            )
        if engine == "time":
            return self._build_time()
        return self._build_byte()

    # ---- time domain
    def _build_time(self) -> "CompiledScenario":
        multi = self.content.multi
        topo = self.topology.build() if self.topology is not None else None
        spf = self.topology.same_pod_frac if self.topology is not None else 1.0
        net = tracker = fair = None
        shared_nodes: dict = {}
        if multi:
            # one fluid network + tracker for the whole catalog; mirror
            # *nodes* are created once so every torrent's range flows
            # contend on the same physical uplinks
            net = FluidNetwork()
            tracker = Tracker(
                rng=np.random.default_rng(self.seed + 1), topology=topo,
                same_pod_frac=spf,
            )
            for ms in self.fabric.mirrors:
                shared_nodes[ms.name] = net.add_node(
                    ms.name, ms.up_bps, ms.down_bps
                )
            if self.policy.fairness == "weighted":
                fair = FairShareLedger()
        tel = self.telemetry
        recorder = (
            TraceRecorder(enabled=tel.trace)
            if tel is not None and tel.enabled else None
        )
        if recorder is not None and fair is not None:
            fair.telemetry = recorder
        sims: dict[str, WebSeedSwarmSim] = {}
        for i, man in enumerate(self.content.manifests):
            mi, payload = man.build()
            sim = WebSeedSwarmSim(
                mi, self.policy, self.swarm,
                seed=self.seed if not multi else self.seed + 101 * i,
                topology=topo, origin_payload=payload, same_pod_frac=spf,
                net=net, tracker=tracker,
                shared_nodes=shared_nodes or None,
                torrent=man.name if multi else None, fair_share=fair,
                telemetry=recorder,
            )
            sim.add_mirrors(list(self.fabric.mirrors))
            caches = self.fabric.pod_caches
            if caches is not None:
                sim.add_pod_caches(
                    up_bps=caches.up_bps, down_bps=caches.down_bps,
                    max_concurrent=caches.max_concurrent,
                )
            sims[man.name] = sim
            if fair is not None:
                fair.register(
                    man.name, man.weight, live=_time_demand_pred(sim)
                )
        # build-time events, then arrivals, then the timed chaos schedule
        # (matching the imperative order the goldens were produced with;
        # same-time timers fire in insertion order)
        for ev in self.events:
            if ev.kind == "corrupt_once":
                sim = sims[self._manifest(ev.torrent).name]
                sim.origin_set.origins[ev.target].corrupt_once.add(ev.piece)
        for group in self.arrivals:
            sim = sims[self._manifest(group.torrent).name]
            raw = group.generate()
            if group.topology_hosts:
                raw = [(h.name, t) for h, (_, t) in zip(topo.hosts(), raw)]
            sim.add_peers(
                raw, up_bps=group.up_bps, down_bps=group.down_bps,
                seed_linger=group.seed_linger,
            )
        shared_net = next(iter(sims.values())).net
        for ev in self.events:
            if ev.kind == "corrupt_once":
                continue
            if ev.kind == "peer_churn":
                targets = [sims[self._torrent_of_peer(ev.target)]]
            elif ev.kind in ("mirror_fail", "mirror_heal", "pod_fail"):
                # mirrors and pods are shared boxes: the event hits every
                # torrent's view of the fabric (failover state, tracker,
                # hedges, pod membership)
                targets = list(sims.values())
            else:
                targets = [sims[self._manifest(ev.torrent).name]]
            for sim in targets:
                shared_net.schedule(ev.at, _time_event_cb(sim, ev))
        shared_tracker = (
            tracker if multi else next(iter(sims.values())).tracker
        )
        if self.repair is not None and self.repair.enabled:
            for name, sim in sims.items():
                ctrl = RepairController(
                    self.repair, sim.metainfo,
                    availability=(
                        lambda s=sim: s.tracker.availability_map(s.metainfo)
                    ),
                    fetch=sim.repair_fetch,
                    telemetry=(
                        recorder if recorder is not None else NULL_RECORDER
                    ),
                    torrent=name,
                    demand=(
                        _time_demand_source(sim)
                        if self.repair.prioritize == "demand" else None
                    ),
                )
                sim.repair = ctrl
                _install_repair_timer(
                    sim, ctrl, shared_net, self.repair.scan_interval
                )
        if self.adversary is not None and self.adversary.enabled:
            # validated single-torrent, so there is exactly one sim
            sim = next(iter(sims.values()))
            sim.adversary = AdversaryState(
                poisoners=self.resolve_poisoners(),
                poison_rate=self.adversary.poison_rate,
                free_riders=self.adversary.free_riders,
                seed=self.adversary.seed,
            )
            sim.quarantine = Quarantine(
                self.adversary.ban_threshold, self.adversary.parole_after
            )
        sampler = None
        if tel is not None and tel.enabled and tel.metrics:
            sampler = MetricsSampler(
                _time_metrics_source(sims, shared_net, shared_tracker),
                capacity=tel.capacity, interval=tel.sample_interval,
            )
        return CompiledScenario(
            spec=self, engine="time", sims=sims,
            net=shared_net,
            tracker=shared_tracker,
            fair=fair,
            recorder=recorder, sampler=sampler,
        )

    # ---- byte domain
    def _build_byte(self) -> "CompiledScenario":
        for man in self.content.manifests:
            if man.payload != "random":
                raise ValueError(
                    f"byte engine moves real bytes: manifest {man.name!r} "
                    "needs payload='random'"
                )
        for ev in self.events:
            if ev.kind == "peer_churn":
                raise ValueError(
                    "peer_churn events are time-engine only (byte-domain "
                    "departures come from churn_storm/pod_fail, which "
                    "quantize to round boundaries)"
                )
        fair = (
            FairShareLedger()
            if self.content.multi and self.policy.fairness == "weighted"
            else None
        )
        tel = self.telemetry
        recorder = (
            TraceRecorder(enabled=tel.trace)
            if tel is not None and tel.enabled else None
        )
        if recorder is not None and fair is not None:
            fair.telemetry = recorder
        topo = self.topology.build() if self.topology is not None else None
        sims: dict[str, LocalSwarm] = {}
        for i, man in enumerate(self.content.manifests):
            mi, payload = man.build()
            groups = [
                g for g in self.arrivals
                if self._manifest(g.torrent).name == man.name
            ]
            peer_ids: list[str] = []
            for g in groups:
                if g.topology_hosts:
                    peer_ids.extend(h.name for h in topo.hosts()[:g.n])
                else:
                    peer_ids.extend(pid for pid, _ in g.generate())
            pod_of = None
            if topo is not None:
                # balanced pod assignment; host-named peers parse exactly
                pod_of = {}
                for j, pid in enumerate(peer_ids):
                    addr = topo.addr_of(pid) \
                        if pid.startswith("pod") else None
                    pod_of[pid] = addr.pod if addr is not None \
                        else j % topo.num_pods
            swarm = LocalSwarm(
                mi, payload, peer_ids,
                seed=self.seed if not self.content.multi
                else self.seed + 101 * i,
                policy=self.swarm.policy,
                upload_slots=self.byte_upload_slots,
                origin_slots=self.byte_origin_slots,
                webseed=self.policy,
                mirrors=list(self.fabric.mirrors),
                pod_of=pod_of,
                pod_caches=self.fabric.pod_caches is not None,
                telemetry=recorder,
            )
            if fair is not None:
                swarm.scheduler.torrent = man.name
                swarm.scheduler.fair_share = fair
                fair.register(
                    man.name, man.weight,
                    live=(lambda s=swarm: not s.complete),
                )
            sims[man.name] = swarm
        for ev in self.events:
            if ev.kind == "corrupt_once":
                swarm = sims[self._manifest(ev.torrent).name]
                swarm.origin_set.origins[ev.target].corrupt_once.add(ev.piece)
        if self.repair is not None and self.repair.enabled:
            for name, swarm in sims.items():
                swarm.repair = RepairController(
                    self.repair, swarm.metainfo,
                    availability=swarm.repair_availability,
                    fetch=swarm.repair_fetch,
                    telemetry=(
                        recorder if recorder is not None else NULL_RECORDER
                    ),
                    torrent=name,
                    demand=(
                        _byte_demand_source(swarm)
                        if self.repair.prioritize == "demand" else None
                    ),
                )
        if self.adversary is not None and self.adversary.enabled:
            # validated single-torrent, so there is exactly one swarm
            swarm = next(iter(sims.values()))
            swarm.adversary = AdversaryState(
                poisoners=self.resolve_poisoners(),
                poison_rate=self.adversary.poison_rate,
                free_riders=self.adversary.free_riders,
                seed=self.adversary.seed,
            )
            swarm.quarantine = Quarantine(
                self.adversary.ban_threshold, self.adversary.parole_after
            )
        sampler = None
        if tel is not None and tel.enabled and tel.metrics:
            sampler = MetricsSampler(
                _byte_metrics_source(sims),
                capacity=tel.capacity, interval=tel.sample_interval,
            )
        return CompiledScenario(
            spec=self, engine="byte", sims=sims, fair=fair,
            recorder=recorder, sampler=sampler,
        )

    # ---- fleet domain
    def _build_fleet(self, device=None) -> "CompiledScenario":
        """Compile to the vectorized :class:`~repro_torch.core.fleet
        .FleetSwarmSim`. Single-manifest only (the fleet hot loop batches
        one piece space); features the array model does not express yet —
        pod caches, corrupt_once, hedging, dynamic mirror selection —
        raise here rather than silently degrade."""
        if self.content.multi:
            raise ValueError(
                "fleet engine is single-torrent (one batched piece space); "
                "split multi-torrent catalogs across runs"
            )
        if self.fabric.pod_caches is not None:
            raise ValueError("fleet engine does not support pod caches yet")
        if self.repair is not None and self.repair.enabled:
            raise ValueError(
                "fleet engine does not support the repair tier yet (the "
                "array model has no per-replica stores to re-seed)"
            )
        if self.adversary is not None and self.adversary.enabled:
            raise ValueError(
                "fleet engine does not support the adversary tier yet (the "
                "array model has no per-piece verification to fail)"
            )
        for ev in self.events:
            if ev.kind == "corrupt_once":
                raise ValueError(
                    "corrupt_once is object-engine only (the fleet engine "
                    "moves no real bytes to corrupt)"
                )
            if ev.kind in ADVERSARIAL_EVENT_KINDS:
                raise ValueError(
                    f"{ev.kind} events are object-engine only (the fleet "
                    "engine has no tracker/partition model)"
                )
            if ev.kind in UNTARGETED_EVENT_KINDS:
                raise ValueError(
                    f"{ev.kind} events are object-engine only (the fleet "
                    "engine models churn through seed_linger)"
                )
        man = self.content.manifests[0]
        mi, _ = man.build()   # payload bytes unused: fluid pools only
        tel = self.telemetry
        recorder = (
            TraceRecorder(enabled=tel.trace)
            if tel is not None and tel.enabled else None
        )
        topo = self.topology
        sim = FleetSwarmSim(
            mi, self.policy, self.swarm, fleet=self.fleet, seed=self.seed,
            num_pods=topo.num_pods if topo is not None else 0,
            spine_bps=topo.spine_bps if topo is not None else None,
            telemetry=recorder, torrent=man.name, device=device,
        )
        if tel is not None:
            sim.peer_event_limit = tel.per_peer_events_max
        sim.add_mirrors(list(self.fabric.mirrors))
        built_topo = topo.build() if topo is not None else None
        peer_seq = 0
        for group in self.arrivals:
            raw = group.generate()
            if group.topology_hosts:
                raw = [
                    (h.name, t)
                    for h, (_, t) in zip(built_topo.hosts(), raw)
                ]
            pods = None
            if built_topo is not None:
                # balanced pod assignment, host-named peers parse exactly
                # (same rule as the byte engine)
                pods = []
                for pid, _ in raw:
                    addr = (
                        built_topo.addr_of(pid)
                        if pid.startswith("pod") else None
                    )
                    pods.append(
                        addr.pod if addr is not None
                        else peer_seq % built_topo.num_pods
                    )
                    peer_seq += 1
            sim.add_peers(
                raw, up_bps=group.up_bps, down_bps=group.down_bps,
                seed_linger=group.seed_linger, pods=pods,
            )
        for ev in self.events:
            sim.schedule_event(ev.at, ev.kind, ev.target)
        sampler = None
        if tel is not None and tel.enabled and tel.metrics:
            sampler = MetricsSampler(
                _fleet_metrics_source(sim),
                capacity=tel.capacity, interval=tel.sample_interval,
            )
            sim.sampler = sampler
        return CompiledScenario(
            spec=self, engine="fleet", sims={man.name: sim},
            recorder=recorder, sampler=sampler,
        )


def _fleet_metrics_source(sim: FleetSwarmSim):
    """Aggregate gauge closure for the fleet engine: same schema core as
    the time/byte sources (seeders/leechers, tier bytes, replication) so
    metrics blocks stay comparable across engines."""
    def _source() -> dict[str, float]:
        return sim.metrics_gauges()
    return _source


def _time_demand_pred(sim: WebSeedSwarmSim):
    """Does this torrent have live demand *right now*? (fairness contender
    test). Pending-but-unarrived clients deliberately do not count: a
    torrent whose flash crowd lands at t=600 must not throttle a torrent
    downloading at t=0 while the uplink would otherwise sit idle — the
    ledger's no-credit-for-idle rule handles the late joiner when it
    actually arrives."""
    def _live() -> bool:
        return any(
            not a.is_seed and not a.departed for a in sim.agents.values()
        )
    return _live


def _time_demand_source(sim: WebSeedSwarmSim):
    """Per-piece live-demand vector for demand-prioritized repair: how many
    arrived, still-downloading clients are missing each piece. Pure
    observation (no RNG, no mutation)."""
    def _demand() -> np.ndarray:
        want = np.zeros(sim.metainfo.num_pieces, dtype=np.int64)
        for a in sim.agents.values():
            if a.is_origin or a.departed or a.complete:
                continue
            want += ~a.bitfield.as_array()
        return want
    return _demand


def _byte_demand_source(swarm: LocalSwarm):
    """Byte-engine twin of :func:`_time_demand_source` (partial-download
    masks respected: a piece a peer never wanted is not demand)."""
    def _demand() -> np.ndarray:
        want = np.zeros(swarm.metainfo.num_pieces, dtype=np.int64)
        for pid, a in swarm.peers.items():
            if pid in swarm.departed or swarm._peer_done(pid):
                continue
            missing = ~a.bitfield.as_array()
            mask = swarm.needed.get(pid)
            if mask is not None:
                missing = missing & mask
            want += missing
        return want
    return _demand


def _time_event_cb(sim: WebSeedSwarmSim, ev: EventSpec):
    def _fire(now: float) -> None:
        if ev.kind == "mirror_fail":
            sim.fail_mirror(ev.target)
        elif ev.kind == "mirror_heal":
            sim.heal_mirror(ev.target)
        elif ev.kind == "peer_churn":
            sim.fail_peer(ev.target)
        elif ev.kind == "churn_storm":
            sim.churn_storm(ev.count, ev.spread, ev.seed, now)
        elif ev.kind == "pod_fail":
            sim.fail_pod(ev.pod, now)
        elif ev.kind == "tracker_fail":
            sim.tracker_fail(now)
        elif ev.kind == "tracker_heal":
            sim.tracker_heal(now)
        elif ev.kind == "partition":
            sim.start_partition(ev.target, now)
        elif ev.kind == "partition_heal":
            sim.heal_partition(now)
        # faults change the replica map: restart the repair scan timer if
        # it had wound down on a quiescent swarm
        ensure = getattr(sim, "_repair_ensure", None)
        if ensure is not None:
            ensure(now)
    return _fire


def _install_repair_timer(sim, ctrl, net, interval: float) -> None:
    """Self-rescheduling repair scan on the shared event loop.

    The timer must not pin the network alive forever (``net.run`` ends
    when flows and timers drain), so each scan re-arms only while the
    swarm can still make repair progress: clients pending or mid-download,
    repairs in flight, or re-seeds just scheduled. Fault events restart a
    wound-down timer through ``sim._repair_ensure``."""
    state = {"stopped": False}

    def _scan(now: float) -> None:
        if sim.tracker.failed:
            # dark tracker: the availability map is stale/unreachable, so
            # don't scan — just keep the timer alive while the swarm can
            # still make progress (tracker_heal restarts a wound-down one)
            if sim._pending_arrivals > 0 or any(
                not a.is_origin and not a.departed and not a.is_seed
                for a in sim.agents.values()
            ):
                net.schedule(now + interval, _scan)
            else:
                state["stopped"] = True
            return
        scheduled = ctrl.scan(now)
        active = (
            scheduled > 0
            or ctrl.pending_count > 0
            or sim._pending_arrivals > 0
            or any(
                not a.is_origin and not a.departed and not a.is_seed
                for a in sim.agents.values()
            )
        )
        if active:
            net.schedule(now + interval, _scan)
        else:
            state["stopped"] = True

    def _ensure(now: float) -> None:
        if state["stopped"]:
            state["stopped"] = False
            net.schedule(now + interval, _scan)

    sim._repair_ensure = _ensure
    net.schedule(interval, _scan)


def _time_metrics_source(sims, net, tracker):
    """Per-tick gauge closure for the time engine. Pure observation: reads
    the tracker/netsim state without consuming RNG or mutating anything."""
    def _source() -> dict[str, float]:
        metainfos = [s.metainfo for s in sims.values()]
        st = (
            tracker.scrape_fleet(metainfos) if len(metainfos) > 1
            else tracker.scrape(metainfos[0])
        )
        gauges = {
            "seeders": float(st.seeders),
            "leechers": float(st.leechers),
            "origin_bytes": float(st.tier_uploaded.get("origin", 0.0)),
            "cache_bytes": float(st.tier_uploaded.get("pod_cache", 0.0)),
            "peer_bytes": float(st.tier_uploaded.get("peer", 0.0)),
            "inflight_hedges": float(
                sum(len(s.scheduler.hedges) for s in sims.values())
            ),
        }
        mins: list[float] = []
        means: list[float] = []
        for s in sims.values():
            amap = tracker.availability_map(s.metainfo)
            if amap.size:
                mins.append(float(amap.min()))
                means.append(float(amap.mean()))
        gauges["min_replication"] = min(mins) if mins else 0.0
        gauges["mean_replication"] = (
            float(np.mean(means)) if means else 0.0
        )
        _repair_gauges(gauges, sims)
        for lname, link in net.links.items():
            rate = net.link_rate(link)
            cap = link.capacity_bps
            gauges[f"link_{lname}_bps"] = rate
            gauges[f"link_{lname}_util"] = (
                rate / cap if np.isfinite(cap) and cap > 0 else 0.0
            )
        return gauges
    return _source


def _byte_metrics_source(sims):
    """Per-round gauge closure for the byte engine (same schema core as the
    time source so metrics blocks are comparable across engines). Departed
    peers stop counting everywhere: their replicas left with them, and a
    mid-download victim is neither a seeder nor live demand."""
    def _source() -> dict[str, float]:
        gauges = {
            "seeders": 0.0, "leechers": 0.0,
            "origin_bytes": 0.0, "cache_bytes": 0.0, "peer_bytes": 0.0,
            "inflight_hedges": 0.0,
        }
        mins: list[float] = []
        means: list[float] = []
        for s in sims.values():
            gauges["origin_bytes"] += (
                s.http_uploaded if s.origin_set is not None
                else s.origin.ledger.uploaded
            )
            gauges["cache_bytes"] += s.pod_cache_uploaded
            gauges["peer_bytes"] += sum(
                a.ledger.uploaded for a in s.peers.values()
            )
            alive = [pid for pid in s.peers if pid not in s.departed]
            done = sum(1 for pid in alive if s._peer_done(pid))
            gauges["seeders"] += done
            gauges["leechers"] += len(alive) - done
            gauges["inflight_hedges"] += len(s.scheduler.hedges)
            avail = s.repair_availability()
            if avail.size:
                mins.append(float(avail.min()))
                means.append(float(avail.mean()))
        gauges["min_replication"] = min(mins) if mins else 0.0
        gauges["mean_replication"] = (
            float(np.mean(means)) if means else 0.0
        )
        _repair_gauges(gauges, sims)
        return gauges
    return _source


def _repair_gauges(gauges: dict[str, float], sims) -> None:
    """Availability gauge family, added only when a repair controller is
    wired (repair-off metrics blocks keep their pre-repair schema)."""
    ctrls = [
        s.repair for s in sims.values()
        if getattr(s, "repair", None) is not None
    ]
    if not ctrls:
        return
    for tier in ("origin", "pod_cache", "peer"):
        gauges[f"repair_{tier}_bytes"] = float(
            sum(c.repair_bytes.get(tier, 0.0) for c in ctrls)
        )
    gauges["repairs_pending"] = float(sum(c.pending_count for c in ctrls))
    gauges["degraded_pieces"] = float(
        sum(c.degraded_count() for c in ctrls)
    )


# --------------------------------------------------------------------------- compiled


class CompiledScenario:
    """A fully-wired scenario, ready to run exactly once.

    ``sims`` maps torrent name -> engine object
    (:class:`~repro_torch.core.webseed.WebSeedSwarmSim` or
    :class:`~repro_torch.core.swarm.LocalSwarm`). ``sim`` is the single-torrent
    shorthand. In multi-torrent time-domain runs all engines share ``net``
    and ``tracker``; ``fair`` is the cross-torrent admission arbiter (None
    when ``policy.fairness == "none"``).
    """

    def __init__(self, spec, engine, sims, net=None, tracker=None, fair=None,
                 recorder=None, sampler=None):
        self.spec = spec
        self.engine = engine
        self.sims = sims
        self.net = net
        self.tracker = tracker
        self.fair = fair
        # flight recorder (None unless spec.telemetry is enabled)
        self.recorder = recorder
        self.sampler = sampler
        # per-torrent origin egress the instant the first torrent finishes
        self._concurrent_snapshot: dict[str, float] = {}

    @property
    def sim(self):
        if len(self.sims) != 1:
            raise ValueError(
                "CompiledScenario.sim is single-torrent shorthand; this "
                f"scenario has {sorted(self.sims)}"
            )
        return next(iter(self.sims.values()))

    @property
    def repairs(self):
        """torrent name -> RepairController (empty when repair is off)."""
        return {
            n: s.repair for n, s in self.sims.items()
            if getattr(s, "repair", None) is not None
        }

    @property
    def quarantines(self):
        """torrent name -> Quarantine (empty when the adversary tier is
        off; the fleet engine never has one)."""
        return {
            n: s.quarantine for n, s in self.sims.items()
            if getattr(s, "quarantine", None) is not None
        }

    # ------------------------------------------------------------- run
    def run(self, until: float = float("inf")) -> ScenarioResult:
        if self.engine == "time":
            return self._run_time(until)
        if self.engine == "fleet":
            return self._run_fleet(until)
        return self._run_byte()

    # ---- time domain
    def _torrent_done_time(self, sim) -> bool:
        if sim._pending_arrivals > 0:
            return False
        leechers = [a for a in sim.agents.values() if not a.is_origin]
        return bool(leechers) and all(
            a.completed_at is not None for a in leechers
        )

    def _run_time(self, until: float) -> ScenarioResult:
        multi = len(self.sims) > 1
        if multi:
            for name, sim in self.sims.items():
                sim.on_client_complete = self._make_snapshot_hook(name)
        if self.sampler is None:
            self.net.run(until=until)
        else:
            # chunked run: advance in sample_interval slices so the sampler
            # sees the live network mid-flight. Only entered when telemetry
            # is on — the plain run above keeps telemetry-off runs on the
            # exact pre-telemetry code path (bit-identical goldens).
            interval = float(self.sampler.interval)
            self.sampler.sample(self.net.now)
            while True:
                self.net.run(until=min(self.net.now + interval, until))
                self.sampler.sample(self.net.now)
                if self.net.now >= until:
                    break
                if not self.net.flows and not self.net._timers:
                    break
        outcomes: dict[str, TorrentOutcome] = {}
        weights = {m.name: m.weight for m in self.spec.content.manifests}
        for name, sim in self.sims.items():
            res = sim._result()
            clients = sum(1 for a in sim.agents.values() if not a.is_origin)
            outcomes[name] = TorrentOutcome(
                torrent=name, weight=weights[name],
                clients=clients, completed=len(res.completion_time),
                # this torrent's own span (when its last client finished),
                # not the shared network's global end time
                duration=(
                    max(res.finish_at.values()) if res.finish_at
                    else res.sim_time
                ),
                origin_uploaded=res.origin_uploaded,
                origin_http_uploaded=res.origin_http_uploaded,
                total_downloaded=res.total_downloaded,
                ud_ratio=res.ud_ratio,
                completion_percentiles=(
                    res.completion_percentiles() if res.completion_time
                    else {}
                ),
                raw=res,
            )
        stats = (
            self.tracker.scrape_fleet(
                [sim.metainfo for sim in self.sims.values()]
            )
            if multi else next(iter(outcomes.values())).raw.stats
        )
        return ScenarioResult(
            name=self.spec.name, engine="time", outcomes=outcomes,
            sim_time=self.net.now, stats=stats,
            concurrent_origin_uploaded=dict(self._concurrent_snapshot),
            jain_fairness=self._jain(weights),
            trace=self.recorder, metrics=self.sampler,
        )

    def _make_snapshot_hook(self, name: str):
        def _hook(sim, agent, now) -> None:
            if self._concurrent_snapshot or not self._torrent_done_time(sim):
                return
            for other, osim in self.sims.items():
                st = self.tracker.scrape(osim.metainfo)
                self._concurrent_snapshot[other] = st.origin_uploaded
        return _hook

    def _jain(self, weights: dict[str, float]) -> Optional[float]:
        if len(self.sims) < 2 or not self._concurrent_snapshot:
            return None
        return jain_index(
            self._concurrent_snapshot[n] / weights[n] for n in self.sims
        )

    # ---- fleet domain
    def _run_fleet(self, until: float) -> ScenarioResult:
        sim = self.sim
        res: FleetResult = sim.run(until=until)
        man = self.spec.content.manifests[0]
        outcomes = {
            man.name: TorrentOutcome(
                torrent=man.name, weight=man.weight,
                clients=res.n, completed=res.completed,
                duration=(
                    float(np.max(res.completed_at[
                        np.isfinite(res.completed_at)
                    ])) if res.completed else res.sim_time
                ),
                origin_uploaded=res.origin_uploaded,
                origin_http_uploaded=res.origin_http_uploaded,
                total_downloaded=res.total_downloaded,
                ud_ratio=res.ud_ratio,
                completion_percentiles=(
                    res.completion_percentiles() if res.completed else {}
                ),
                raw=res,
            )
        }
        return ScenarioResult(
            name=self.spec.name, engine="fleet", outcomes=outcomes,
            sim_time=res.sim_time, stats=None,
            trace=self.recorder, metrics=self.sampler,
        )

    # ---- byte domain
    def _run_byte(self) -> ScenarioResult:
        spec = self.spec
        pending = [e for e in spec.events if e.kind != "corrupt_once"]
        rounds = 0
        idle = 0
        max_idle = LocalSwarm.MAX_IDLE_ROUNDS if len(self.sims) == 1 else 50
        every = 1
        if self.sampler is not None:
            every = max(1, int(round(self.sampler.interval)))
            self.sampler.sample(0.0)
        while any(not s.complete for s in self.sims.values()):
            if rounds >= spec.byte_max_rounds:
                raise RuntimeError("scenario did not converge (byte engine)")
            still = [e for e in pending if e.at <= rounds]
            for ev in still:
                if ev.kind == "churn_storm":
                    # churn is torrent-scoped: each swarm owns its peers
                    self.sims[
                        spec._manifest(ev.torrent).name
                    ].churn_storm(ev.count, ev.spread, ev.seed)
                    pending.remove(ev)
                    continue
                # mirrors and pods are shared boxes: fail/heal applies to
                # every torrent's view (matching the time engine, where the
                # shared netsim node goes down for the whole fleet)
                for swarm in self.sims.values():
                    if ev.kind == "mirror_fail":
                        swarm.fail_mirror(ev.target)
                    elif ev.kind == "mirror_heal":
                        swarm.heal_mirror(ev.target)
                    elif ev.kind == "pod_fail":
                        swarm.fail_pod(ev.pod)
                    elif ev.kind == "tracker_fail":
                        swarm.tracker_fail()
                    elif ev.kind == "tracker_heal":
                        swarm.tracker_heal()
                    elif ev.kind == "partition":
                        swarm.start_partition(ev.target)
                    elif ev.kind == "partition_heal":
                        swarm.heal_partition()
                pending.remove(ev)
            moved = 0
            for swarm in self.sims.values():
                if not swarm.complete:
                    moved += swarm.step()
                # the repair scan runs after organic trading so re-seeds
                # only fill the deficit the round left behind; repairs
                # count as movement (a repairing swarm is not stalled)
                moved += swarm.repair_scan()
            rounds += 1
            if self.sampler is not None and rounds % every == 0:
                self.sampler.sample(float(rounds))
            idle = idle + 1 if moved == 0 else 0
            if idle > max_idle and not pending:
                # a swarm waiting out a fault window (dark tracker,
                # partition) is not stalled while heal events remain;
                # byte_max_rounds still bounds the run
                raise RuntimeError(
                    "scenario stalled (byte engine: no eligible transfer)"
                )
            if not self._concurrent_snapshot and any(
                s.complete for s in self.sims.values()
            ) and len(self.sims) > 1:
                self._concurrent_snapshot = {
                    n: s.origin.ledger.uploaded
                    for n, s in self.sims.items()
                }
        if self.sampler is not None and rounds % every != 0:
            self.sampler.sample(float(rounds))
        outcomes: dict[str, TorrentOutcome] = {}
        weights = {m.name: m.weight for m in spec.content.manifests}
        for name, swarm in self.sims.items():
            swarm._note_completions()
            outcomes[name] = TorrentOutcome(
                torrent=name, weight=weights[name],
                clients=len(swarm.peers),
                completed=len(swarm.completed_round),
                duration=float(
                    max(swarm.completed_round.values())
                    if swarm.completed_round else swarm.rounds
                ),
                origin_uploaded=swarm.origin.ledger.uploaded,
                origin_http_uploaded=swarm.http_uploaded,
                total_downloaded=sum(
                    a.ledger.downloaded for a in swarm.peers.values()
                ),
                ud_ratio=swarm.ud_ratio,
                completion_percentiles=(
                    swarm.completion_percentiles()
                    if swarm.completed_round else {}
                ),
                raw=swarm,
            )
        return ScenarioResult(
            name=spec.name, engine="byte", outcomes=outcomes,
            sim_time=float(rounds), stats=None,
            concurrent_origin_uploaded=dict(self._concurrent_snapshot),
            jain_fairness=self._jain(weights),
            trace=self.recorder, metrics=self.sampler,
        )
