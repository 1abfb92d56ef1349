"""repro_torch.core — the paper's contribution: P2P data-distribution fabric.

Academic Torrents (Lo & Cohen, 2016) augments a central origin with a
BitTorrent-style swarm. This package implements that system — metainfo piece
tables, rarest-first selection, tit-for-tat choking, tracker U/D accounting
(Eq. 1) — over a deterministic fluid network simulator (time domain) and a
byte-accurate local engine (functional data plane), plus the TPU-cluster
adaptations: locality-aware peer ranking and collective-assisted (ICI
all-gather) replication.

This is the PyTorch port's copy of :mod:`repro.core`. The framework-free
modules are copied unchanged; the fleet engine's device tick runs the CUDA
kernels of :mod:`repro_torch.kernels.swarm`, and ``collective_fabric``
replicates bundles with ``torch.distributed`` where the reference uses a
JAX mesh.
"""

from .accounting import (
    AT_SPEED_BPS,
    CostModel,
    HTTP_SPEED_BPS,
    PAPER_UD_RATIO,
    Projection,
    TABLE1_DATASETS,
    paper_table1,
    project_row,
    reddit_case_study,
    ud_ratio,
)

from .bitfield import Bitfield, availability
from .choking import Choker, ChokerConfig, RateWindow
from .collective_fabric import (
    ColdstartEstimate,
    allgather_bundle,
    broadcast_bundle,
    bundle_to_bytes,
    coldstart_time,
    local_stripe,
    single_rank_group,
    stripe_shards,
)
from .fleet import FleetResult, FleetSpec, FleetSwarmSim, waterfill_rates
from .http_baseline import HttpResult, analytic_http, simulate_http
from .metainfo import FileEntry, MetaInfo, assemble, piece_hash
from .netsim import FluidNetwork, Flow, Link, Node
from .peer import Ledger, PeerAgent
from .repair import REPAIR_TIERS, RepairController, RepairSpec
from .scenario import (
    AdversarySpec,
    ArrivalSpec,
    CompiledScenario,
    ContentSpec,
    EventSpec,
    FabricSpec,
    ManifestSpec,
    PodCacheSpec,
    ScenarioResult,
    ScenarioSpec,
    TopologySpec,
    TorrentOutcome,
)
from .scheduler import (
    AdversaryState,
    ClientView,
    FairShareLedger,
    OriginPolicy,
    Quarantine,
    Request,
    TransferScheduler,
    jain_index,
    percentiles,
    plan_peer_requests,
    spec_from_dict,
    spec_to_dict,
    swarm_routed_mask,
)
from .swarm import (
    LocalSwarm,
    PeerSpec,
    SwarmConfig,
    SwarmResult,
    SwarmSim,
    flash_crowd,
    poisson_arrivals,
    staggered_arrivals,
)
from .telemetry import (
    MetricsSampler,
    NULL_RECORDER,
    TRACE_EVENT_KINDS,
    TelemetrySpec,
    TraceChecker,
    TraceEvent,
    TraceRecorder,
)
from .topology import ClusterTopology, HostAddr
from .tracker import PeerRecord, SwarmStats, Tracker
from .webseed import (
    MirrorSpec,
    OriginSet,
    PodCacheOrigin,
    WebSeedOrigin,
    WebSeedSwarmSim,
)

__all__ = [k for k in dir() if not k.startswith("_")]
