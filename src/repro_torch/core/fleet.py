"""Vectorized fleet-scale swarm engine: peers as rows of arrays.

The fluid engines (:class:`~repro_torch.core.webseed.WebSeedSwarmSim`,
:class:`~repro_torch.core.swarm.LocalSwarm`) advance per-client Python objects —
fine at 16 clients, hopeless at the ROADMAP's millions. This module extends
the array idiom of :meth:`~repro_torch.core.netsim.FluidNetwork._recompute_rates`
to the *whole* hot path:

* peer state is rows of arrays — an ``(n_peers, n_pieces)`` bitfield
  matrix (``have``), per-peer progress/rate/ledger vectors, arrival /
  churn / completion as boolean masks;
* piece selection is a masked argmin over the shared replica-count vector
  (:func:`~repro_torch.core.piece_selection.batched_rarest`), with a fixed
  per-(peer, piece) jitter matrix for tie-breaks so selection consumes no
  per-tick RNG;
* rate allocation is :func:`waterfill_rates` — max-min fair progressive
  filling as a standalone fixed-point array iteration with the exact
  structure (and float semantics) of ``_recompute_rates``, so the two are
  equivalence-tested against each other on random topologies;
* one tick is one synchronous vectorized step of ``dt`` seconds, with its
  compute path behind ``FleetSpec.backend``: ``"pallas"``, the port's
  default, makes the tick device-resident — the have matrix, replica
  counts, and tie-break jitter stay on the device across ticks and
  selection + water-filling run as the CUDA kernels of
  :mod:`repro_torch.kernels.swarm`; ``"jit"`` routes water-filling alone
  through the float32 water-filling kernel; ``"numpy"`` is the float64
  host path. The backend names are the scenario files' own; on a CPU
  tensor each kernel is its plain PyTorch version. The float32 backends
  are a throughput choice; the goldens are held through ``"numpy"``.

Fidelity model (the documented small-N equivalence bound)
---------------------------------------------------------
The fleet engine is a *fluid, tick-quantized* projection of the time
engine, not a re-implementation:

* **HTTP paths align exactly.** A client's HTTP stream serializes range
  requests exactly like the time engine's ``http_pipeline=1`` flows, the
  mirror uplink is fair-shared by the same max-min rule, and per-mirror
  admission (``max_concurrent``) caps concurrent streams the same way. A
  pure-HTTP scenario (``swarm_fraction 0``) therefore completes within one
  tick of the time engine — and *exactly* when completions land on tick
  boundaries. Mid-stream mirror failover keeps the partial piece bytes
  (the time engine refetches the range), adding at most one
  piece-service-time of divergence.
* **Swarm paths align structurally, not per-event.** Flow topology uses
  the same budgets — ``pipeline`` download slots per leecher split
  ``per_peer_requests`` per uploader, at most
  ``(max_unchoked + optimistic_slots) * per_peer_requests`` concurrent
  upload slots per peer, sources re-sampled every ``choke_interval`` — but
  choking is re-sampled uniformly rather than tit-for-tat, pieces progress
  as one fluid pool per stream class, and there is no endgame duplication.
  Completion times track the time engine within tens of percent at small
  N (pinned by ``tests/test_fleet.py``), and the scaling *shape* — the
  paper's self-scaling claim — is preserved.

Tick quantization: arrivals activate at the first tick boundary >= their
arrival time; fault events snap the tick so they fire on their exact
timestamp; completions are stamped at the end of the tick that delivered
the final byte. All reported times are therefore quantized to at most one
``dt``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from time import perf_counter
from typing import Optional, Sequence

import numpy as np
import torch

from ..compat import resolve_device
from .metainfo import MetaInfo
from .piece_selection import batched_rarest
from .scheduler import (
    OriginPolicy,
    percentiles,
    spec_from_dict,
    spec_to_dict,
    swarm_routed_mask,
)
from .swarm import SwarmConfig
from .telemetry import NULL_RECORDER
from .webseed import MirrorSpec

INF = float("inf")


# --------------------------------------------------------------------------- water-filling


def waterfill_rates(
    src: np.ndarray,
    dst: np.ndarray,
    up_cap: np.ndarray,
    down_cap: np.ndarray,
    link_of: Optional[np.ndarray] = None,
    link_cap: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Max-min fair progressive filling as a fixed-point array iteration.

    The standalone, engine-free port of
    :meth:`~repro_torch.core.netsim.FluidNetwork._recompute_rates`: all unfrozen
    flows grow at the same rate until some constraint (a node's uplink or
    downlink, or a shared link) saturates; flows through a saturated
    constraint freeze; repeat. Operations mirror the netsim loop
    (same bincount / min ordering, same ``1e-12`` saturation tolerance), so
    the two produce identical allocations on identical topologies — the
    property test in ``tests/test_fleet.py`` pins this.

    ``src`` / ``dst`` are per-flow node indices into the shared
    ``up_cap`` / ``down_cap`` vectors. ``link_of`` optionally assigns each
    flow to at most one shared link (index into ``link_cap``; ``-1`` for
    none) — the fleet engine's spine constraint.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    nf = src.size
    if nf == 0:
        return np.zeros(0, dtype=np.float64)
    up_cap = np.asarray(up_cap, dtype=np.float64)
    down_cap = np.asarray(down_cap, dtype=np.float64)
    nn = up_cap.size
    nl = 0
    if link_of is not None and link_cap is not None:
        link_of = np.asarray(link_of, dtype=np.int64)
        link_cap = np.asarray(link_cap, dtype=np.float64)
        if (link_of >= 0).any():
            nl = link_cap.size
            link_alloc = np.zeros(nl)
            linked = link_of >= 0
            safe_link = np.where(linked, link_of, 0)

    rate = np.zeros(nf)
    frozen = np.zeros(nf, dtype=bool)
    up_alloc = np.zeros(nn)
    down_alloc = np.zeros(nn)

    for _ in range(2 * nn + nl + 2):  # each iteration saturates >=1 constraint
        active = ~frozen
        if not active.any():
            break
        n_up = np.bincount(src[active], minlength=nn).astype(np.float64)
        n_down = np.bincount(dst[active], minlength=nn).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            du = np.where(n_up > 0, (up_cap - up_alloc) / n_up, INF)
            dd = np.where(n_down > 0, (down_cap - down_alloc) / n_down, INF)
        delta = min(du.min(), dd.min())
        if nl:
            n_link = np.bincount(
                link_of[active & linked], minlength=nl
            ).astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                dl = np.where(n_link > 0, (link_cap - link_alloc) / n_link, INF)
            delta = min(delta, dl.min())
        if not math.isfinite(delta):
            break
        delta = max(delta, 0.0)
        rate[active] += delta
        up_alloc += n_up * delta
        down_alloc += n_down * delta
        sat_up = (du <= delta + 1e-12) & (n_up > 0)
        sat_down = (dd <= delta + 1e-12) & (n_down > 0)
        newly = active & (sat_up[src] | sat_down[dst])
        if nl:
            link_alloc += n_link * delta
            sat_link = (dl <= delta + 1e-12) & (n_link > 0)
            if sat_link.any():
                newly = newly | (active & linked & sat_link[safe_link])
        if not newly.any():
            break
        frozen |= newly
    return rate


# --------------------------------------------------------------------------- spec


@dataclasses.dataclass
class FleetSpec:
    """Fleet-engine knobs carried by :class:`~repro_torch.core.scenario
    .ScenarioSpec` (the ``"fleet"`` block; strict JSON round-trip).

    ``dt``: tick length in seconds; ``None`` derives a quarter of the
    fastest piece service time, clipped to ``[0.05, 60]``. ``fanout``:
    distinct uploaders sampled per leecher; ``None`` derives the time
    engine's effective value ``ceil(pipeline / per_peer_requests)``.

    ``backend`` selects the tick's compute path:

    - ``"pallas"`` (the port's default) — device-resident tick:
      rarest-argmin selection + water-fill kernels
      (``repro_torch.kernels.swarm``), have-matrix / replica counts /
      jitter held on the device across ticks;
    - ``"jit"`` — water-filling through the float32 water-filling kernel
      with host selection (spine-linked topologies go to numpy);
    - ``"numpy"`` — the float64 reference semantics on the host (the
      goldens path), only when asked for by name.

    Both float32 backends run on the engine's ``device``: CUDA unless the
    caller asks for the CPU, where the kernels' plain PyTorch versions run.

    ``None`` normalizes from the deprecated ``jit`` flag (``True`` ->
    ``"jit"``, else ``"pallas"``; the reference resolves it to
    ``"numpy"``); after ``__post_init__`` the two fields are always
    consistent (``jit == (backend == "jit")``).
    """

    dt: Optional[float] = None
    fanout: Optional[int] = None
    jit: bool = False
    backend: Optional[str] = None

    def __post_init__(self) -> None:
        if self.dt is not None and self.dt <= 0:
            raise ValueError("fleet dt must be positive (or None for auto)")
        if self.fanout is not None and self.fanout < 1:
            raise ValueError("fleet fanout must be >= 1 (or None for auto)")
        if self.backend is None:
            if self.jit:
                warnings.warn(
                    "FleetSpec.jit is deprecated; use backend='jit'",
                    DeprecationWarning,
                    stacklevel=2,
                )
            self.backend = "jit" if self.jit else "pallas"
        elif self.backend not in ("numpy", "jit", "pallas"):
            raise ValueError(
                f"fleet backend must be numpy|jit|pallas (got {self.backend!r})"
            )
        elif self.jit and self.backend != "jit":
            raise ValueError(
                f"deprecated jit=True conflicts with backend={self.backend!r}"
            )
        self.jit = self.backend == "jit"

    def to_dict(self) -> dict:
        return spec_to_dict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "FleetSpec":
        return spec_from_dict(cls, data)


# --------------------------------------------------------------------------- result


@dataclasses.dataclass
class FleetResult:
    """Array-native run summary (per-peer dicts are built lazily).

    Ledgers are piece-granular, matching the tracker convention of the
    object engines: ``total_downloaded`` / ``origin_uploaded`` count
    *completed verified pieces* (in-flight partial bytes at run end are
    excluded), so a pure-HTTP run reports exactly ``n * size`` origin
    bytes and ``ud_ratio == 1.0``.
    """

    peer_ids: list
    arrive_at: np.ndarray          # (n,) seconds
    completed_at: np.ndarray       # (n,) absolute seconds; inf = incomplete
    departed_at: np.ndarray        # (n,) absolute seconds; inf = stayed
    downloaded: np.ndarray         # (n,) completed-piece bytes received
    uploaded_wire: np.ndarray      # (n,) bytes served on the peer path
    mirror_names: list
    mirror_uploaded: np.ndarray    # (M,) completed-piece bytes served
    spine_bytes: float
    sim_time: float
    ticks: int
    dt: float
    phase_seconds: Optional[dict] = None  # wall s: select/waterfill/bookkeeping/telemetry

    @property
    def n(self) -> int:
        return len(self.peer_ids)

    @property
    def completed(self) -> int:
        return int(np.isfinite(self.completed_at).sum())

    @property
    def total_downloaded(self) -> float:
        return float(self.downloaded.sum())

    @property
    def origin_uploaded(self) -> float:
        return float(self.mirror_uploaded.sum())

    # mirrors serve over HTTP only in this engine (no peer protocol)
    origin_http_uploaded = origin_uploaded

    @property
    def ud_ratio(self) -> float:
        if self.origin_uploaded <= 0:
            return INF if self.total_downloaded > 0 else 0.0
        return self.total_downloaded / self.origin_uploaded

    @property
    def durations(self) -> np.ndarray:
        """Per-client completion durations (finished clients only)."""
        done = np.isfinite(self.completed_at)
        return (self.completed_at - self.arrive_at)[done]

    @property
    def completion_time(self) -> dict:
        """pid -> seconds from arrival to completion (finished only)."""
        done = np.flatnonzero(np.isfinite(self.completed_at))
        return {
            self.peer_ids[i]: float(self.completed_at[i] - self.arrive_at[i])
            for i in done
        }

    @property
    def finish_at(self) -> dict:
        """pid -> absolute completion time (finished only)."""
        done = np.flatnonzero(np.isfinite(self.completed_at))
        return {self.peer_ids[i]: float(self.completed_at[i]) for i in done}

    def completion_percentiles(
        self, ps_: Sequence[float] = (50, 95, 99)
    ) -> dict:
        vals = self.durations
        if vals.size == 0:
            raise ValueError("no client completed; percentiles are undefined")
        return percentiles(vals.tolist(), ps_)


# --------------------------------------------------------------------------- engine


class FleetSwarmSim:
    """Batched fluid swarm + mirror-tier engine (see module docstring).

    Usage mirrors the object engines::

        sim = FleetSwarmSim(metainfo, policy, swarm_cfg, seed=0)
        sim.add_mirrors([MirrorSpec("origin", up_bps=50e6)])
        sim.add_peers(flash_crowd(10_000), up_bps=25e6, down_bps=50e6)
        res = sim.run()

    or declaratively via ``ScenarioSpec.build("fleet")``.
    """

    def __init__(
        self,
        metainfo: MetaInfo,
        policy: Optional[OriginPolicy] = None,
        swarm: Optional[SwarmConfig] = None,
        fleet: Optional[FleetSpec] = None,
        seed: int = 0,
        num_pods: int = 0,
        spine_bps: Optional[float] = None,
        telemetry=None,
        torrent: Optional[str] = None,
        device=None,
    ) -> None:
        """``device``: where the float32 backends run. ``None`` means
        CUDA and raises without it; pass ``"cpu"`` for the plain PyTorch
        versions. The numpy backend is the host float64 path and takes no
        CUDA device."""
        self.metainfo = metainfo
        self.policy = policy or OriginPolicy()
        self.swarm_cfg = swarm or SwarmConfig()
        self.fleet_cfg = fleet or FleetSpec()
        if self.fleet_cfg.backend == "numpy":
            if device is not None and torch.device(device).type != "cpu":
                raise ValueError(
                    "backend='numpy' is the host float64 path; pick "
                    "backend='pallas' or 'jit' to run on a CUDA device"
                )
            self.device = None
        else:
            self.device = resolve_device(device)
        if self.policy.hedge:
            raise ValueError(
                "fleet engine does not support mirror hedging "
                "(fluid pools have no per-range tail to duplicate)"
            )
        if self.policy.selection != "static":
            raise ValueError(
                "fleet engine supports selection='static' only "
                f"(got {self.policy.selection!r})"
            )
        self.rng = np.random.default_rng(seed)
        self.telemetry = telemetry or NULL_RECORDER
        self.sampler = None            # MetricsSampler, wired by the builder
        self.peer_event_limit = 256    # per-peer trace events only below this
        self.torrent = torrent
        P = metainfo.num_pieces
        self.num_pieces = P
        self.piece_sizes = np.fromiter(
            (metainfo.piece_size(i) for i in range(P)),
            dtype=np.float64, count=P,
        )
        self.swarm_class = swarm_routed_mask(
            metainfo, self.policy.swarm_fraction
        )
        self.num_pods = int(num_pods)
        self.spine_bps = (
            float(spine_bps) if spine_bps is not None else None
        )
        # mirrors
        self.mirror_specs: list[MirrorSpec] = []
        self._mirror_rank: list[int] = []
        self.mirror_alive = np.zeros(0, dtype=bool)
        # peers are appended in blocks, frozen into arrays at first run()
        self._blocks: list = []
        self._frozen = False
        self.now = 0.0
        self.ticks = 0
        self._events: list = []   # (at, seq, kind, target)
        self._ev_seq = 0

    # ------------------------------------------------------------- build-up
    def add_mirrors(self, specs: Sequence[MirrorSpec]) -> None:
        if self._frozen:
            raise RuntimeError("cannot add mirrors after run()")
        for spec in specs:
            if any(s.name == spec.name for s in self.mirror_specs):
                raise ValueError(f"duplicate mirror {spec.name!r}")
            self.mirror_specs.append(spec)
        self.mirror_alive = np.ones(len(self.mirror_specs), dtype=bool)
        # static selection: live mirrors by (-weight, name), fixed up front
        self._mirror_rank = sorted(
            range(len(self.mirror_specs)),
            key=lambda m: (-self.mirror_specs[m].weight,
                           self.mirror_specs[m].name),
        )

    def add_peers(
        self,
        arrivals: Sequence[tuple],
        up_bps: float,
        down_bps: float,
        seed_linger: Optional[float] = None,
        pods: Optional[Sequence[int]] = None,
    ) -> None:
        """Add a block of ``(peer_id, arrive_at)`` clients (one NIC class
        per block, like the object engines' ``add_peers``)."""
        if self._frozen:
            raise RuntimeError("cannot add peers after run()")
        if up_bps <= 0 or down_bps <= 0:
            raise ValueError("peer NIC capacities must be positive")
        ids = [pid for pid, _ in arrivals]
        arrive = np.fromiter(
            (t for _, t in arrivals), dtype=np.float64, count=len(ids)
        )
        linger = INF if seed_linger is None else float(seed_linger)
        pod_arr = (
            np.asarray(list(pods), dtype=np.int64)
            if pods is not None
            else np.full(len(ids), -1, dtype=np.int64)
        )
        if pod_arr.size != len(ids):
            raise ValueError("pods must align with arrivals")
        self._blocks.append((ids, arrive, float(up_bps), float(down_bps),
                             linger, pod_arr))

    def schedule_event(self, at: float, kind: str, target: str) -> None:
        """Timeline faults: ``mirror_fail`` / ``mirror_heal`` /
        ``peer_churn``. Events snap the tick so they apply at exactly
        ``at``; same-time events fire in insertion order."""
        if kind not in ("mirror_fail", "mirror_heal", "peer_churn"):
            raise ValueError(f"unsupported fleet event kind {kind!r}")
        self._ev_seq += 1
        self._events.append((float(at), self._ev_seq, kind, target))

    # ------------------------------------------------------------- freeze
    def _freeze(self) -> None:
        if self._frozen:
            return
        if not self.mirror_specs:
            raise ValueError("fleet engine needs at least one mirror")
        if not self._blocks:
            raise ValueError("fleet engine needs at least one peer block")
        self._frozen = True
        ids: list = []
        arrive_l, up_l, down_l, linger_l, pods_l = [], [], [], [], []
        for bids, arr, up, down, lin, pod in self._blocks:
            ids.extend(bids)
            arrive_l.append(arr)
            up_l.append(np.full(len(bids), up))
            down_l.append(np.full(len(bids), down))
            linger_l.append(np.full(len(bids), lin))
            pods_l.append(pod)
        n = len(ids)
        if len(set(ids)) != n:
            raise ValueError("duplicate peer ids across arrival blocks")
        P = self.num_pieces
        self.n = n
        self.peer_ids = ids
        self._idx_of = {pid: i for i, pid in enumerate(ids)}
        self.arrive = np.concatenate(arrive_l)
        self.up_bps = np.concatenate(up_l)
        self.down_bps = np.concatenate(down_l)
        self.linger = np.concatenate(linger_l)
        self.pods = np.concatenate(pods_l)
        self.have = np.zeros((n, P), dtype=bool)
        self.nhave = np.zeros(n, dtype=np.int64)
        self.replicas = np.zeros(P, dtype=np.int64)
        # fixed tie-break jitter: one float32 draw per (peer, piece)
        self.jitter = self.rng.random((n, P), dtype=np.float32)
        # stream state: one HTTP stream + one swarm-piece pool per leecher
        self.cur_http = np.full(n, -1, dtype=np.int64)
        self.cur_swarm = np.full(n, -1, dtype=np.int64)
        self.prog_http = np.zeros(n)
        self.prog_swarm = np.zeros(n)
        self.n_missing_http = np.full(
            n, int((~self.swarm_class).sum()), dtype=np.int64
        )
        self.n_missing_swarm = np.full(
            n, int(self.swarm_class.sum()), dtype=np.int64
        )
        # lifecycle
        self.joined = np.zeros(n, dtype=bool)
        self.completed_at = np.full(n, INF)
        self.departed_at = np.full(n, INF)   # scheduled (linger / churn)
        self.departed = np.zeros(n, dtype=bool)
        # ledgers (piece-granular for down/origin; wire-level for peers)
        self.downloaded = np.zeros(n)
        self.uploaded_wire = np.zeros(n)
        self.mirror_uploaded = np.zeros(len(self.mirror_specs))
        self.spine_bytes = 0.0
        # swarm source table: fanout uploaders per leecher for the leecher's
        # current swarm piece; -1 = empty slot. Rebuilt on rechoke ticks and
        # (per changed row) when the current piece changes.
        cfg = self.swarm_cfg
        self.fanout = self.fleet_cfg.fanout or max(
            1, -(-cfg.pipeline // cfg.per_peer_requests)
        )
        self.src_tab = np.full((n, self.fanout), -1, dtype=np.int64)
        self.upload_slots = (
            (cfg.max_unchoked + cfg.optimistic_slots) * cfg.per_peer_requests
        )
        self.dt = self.fleet_cfg.dt or float(
            np.clip(
                self.piece_sizes.min() / np.median(self.down_bps) / 4.0,
                0.05, 60.0,
            )
        )
        self.rechoke_ticks = max(
            1, int(round(cfg.choke_interval / self.dt))
        )
        # backend resolution: both float32 backends water-fill with the
        # kernel on self.device; "pallas" also keeps the selection state
        # there. No fallback: a missing CUDA raised in __init__.
        self._backend = self.fleet_cfg.backend
        self._dev = None
        if self._backend != "numpy":
            from ..kernels import swarm as swarm_kernels

            self._waterfill_dev = functools.partial(
                swarm_kernels.fleet_waterfill, device=self.device
            )
            if self._backend == "pallas":
                self._dev = swarm_kernels.FleetDeviceState(
                    self.jitter, self.swarm_class, device=self.device
                )
        # wall-clock per phase across the whole run (run.py --profile)
        self.phase_seconds = {
            "select": 0.0, "waterfill": 0.0,
            "bookkeeping": 0.0, "telemetry": 0.0,
        }
        self._events.sort(key=lambda e: (e[0], e[1]))
        self._next_sample = 0.0

    # ------------------------------------------------------------- helpers
    def _mirror_caps(self) -> np.ndarray:
        pol = self.policy
        return np.fromiter(
            (
                s.max_concurrent if s.max_concurrent is not None
                else pol.max_concurrent
                for s in self.mirror_specs
            ),
            dtype=np.int64, count=len(self.mirror_specs),
        )

    def _apply_event(self, kind: str, target: str, now: float) -> None:
        if kind in ("mirror_fail", "mirror_heal"):
            m = next(
                (i for i, s in enumerate(self.mirror_specs)
                 if s.name == target), None,
            )
            if m is None:
                raise KeyError(f"unknown mirror {target!r}")
            self.mirror_alive[m] = kind == "mirror_heal"
            if self.telemetry.enabled:
                self.telemetry.emit(
                    kind, t=now, origin=target, torrent=self.torrent
                )
        else:  # peer_churn
            i = self._idx_of.get(target)
            if i is None:
                raise KeyError(f"unknown peer {target!r}")
            self.departed_at[i] = min(self.departed_at[i], now)

    def _depart_rows(self, rows: np.ndarray, now: float) -> None:
        if rows.size == 0:
            return
        self.departed[rows] = True
        self.replicas -= self.have[rows].sum(axis=0)
        if self._dev is not None:
            self._dev.drop_rows(rows)
        if self.telemetry.enabled and self.n <= self.peer_event_limit:
            for i in rows:
                self.telemetry.emit(
                    "peer_churn", t=now, client=self.peer_ids[i],
                    torrent=self.torrent,
                    info=(
                        "post_complete"
                        if np.isfinite(self.completed_at[i])
                        else "mid_download"
                    ),
                )

    def _select(
        self, rows: np.ndarray, stream: str, live_mirror: bool
    ) -> None:
        """(Re-)select the current piece for ``rows`` on one stream class."""
        if rows.size == 0:
            return
        if stream == "http" and not live_mirror:
            return
        t0 = perf_counter()
        other = (
            self.cur_swarm[rows] if stream == "http"
            else self.cur_http[rows]
        )
        if self._dev is not None:
            # device path: cand mask built on the device, only the
            # (k,) pick vector crosses back
            pick = self._dev.select(
                rows, other, stream=stream,
                mode=self.policy.mode,
                fallback=self.policy.http_fallback,
            )
        else:
            missing = ~self.have[rows]
            if stream == "http":
                if self.policy.mode == "http_first":
                    cand = missing.copy()
                else:
                    cand = missing & ~self.swarm_class[None, :]
                    if self.policy.http_fallback:
                        # origin rescue for swarm-routed pieces nobody serves
                        cand |= missing & self.swarm_class[None, :] \
                            & (self.replicas == 0)[None, :]
            else:
                cand = missing & self.swarm_class[None, :] \
                    & (self.replicas > 0)[None, :]
            has_other = other >= 0
            if has_other.any():
                cand[np.flatnonzero(has_other), other[has_other]] = False
            pick = batched_rarest(cand, self.replicas, self.jitter[rows])
        self.phase_seconds["select"] += perf_counter() - t0
        if stream == "http":
            self.cur_http[rows] = pick
            self.prog_http[rows[pick < 0]] = 0.0
        else:
            self.cur_swarm[rows] = pick
            self.prog_swarm[rows[pick < 0]] = 0.0
            self._resample_sources(rows[pick >= 0])

    def _resample_sources(self, rows: np.ndarray) -> None:
        """Sample up to ``fanout`` uploaders per row from the holders of the
        row's current swarm piece (all of them when few — the dense
        small-N graph the equivalence gate relies on)."""
        if rows.size == 0:
            return
        self.src_tab[rows] = -1
        present = self._present
        pieces = self.cur_swarm[rows]
        for p in np.unique(pieces):
            grp = rows[pieces == p]
            holders = np.flatnonzero(self.have[:, p] & present)
            if holders.size == 0:
                continue
            if holders.size <= self.fanout:
                self.src_tab[grp[:, None], np.arange(holders.size)[None, :]] \
                    = holders[None, :]
            else:
                self.src_tab[grp] = holders[
                    self.rng.integers(
                        0, holders.size, (grp.size, self.fanout)
                    )
                ]
        # no self-serving
        self.src_tab[rows] = np.where(
            self.src_tab[rows] == rows[:, None], -1, self.src_tab[rows]
        )

    # ------------------------------------------------------------- run
    def run(self, until: float = INF, max_ticks: int = 10_000_000):
        self._freeze()
        cfg = self.swarm_cfg
        ppr = cfg.per_peer_requests
        dt0 = self.dt
        ev = self._events
        ei = 0
        caps = self._mirror_caps()
        use_spine = (
            self.spine_bps is not None
            and math.isfinite(self.spine_bps)
            and self.num_pods > 0
        )
        if self.sampler is not None:
            self.sampler.sample(self.now)
            self._next_sample = self.now + self.sampler.interval
        # node capacity vectors are tick-invariant: peers 0..n-1, mirrors
        # n..n+M-1 (hoisted out of the loop; failed mirrors admit nobody)
        M = len(self.mirror_specs)
        up_cap = np.concatenate([
            self.up_bps,
            [s.up_bps for s in self.mirror_specs],
        ])
        down_cap = np.concatenate([self.down_bps, np.full(M, INF)])
        ph = self.phase_seconds

        for _ in range(max_ticks):
            tick_t0 = perf_counter()
            snap = ph["select"] + ph["waterfill"] + ph["telemetry"]
            t = self.now
            # events due exactly now (ticks snap onto event times below)
            while ei < len(ev) and ev[ei][0] <= t + 1e-9:
                self._apply_event(ev[ei][2], ev[ei][3], t)
                ei += 1
            # scheduled departures (seed linger / churn)
            due = np.flatnonzero(
                ~self.departed & (self.departed_at <= t + 1e-9)
            )
            self._depart_rows(due, t)
            arrived = self.arrive <= t + 1e-9
            present = arrived & ~self.departed
            self._present = present
            complete = np.isfinite(self.completed_at)
            leech = present & ~complete
            if self.telemetry.enabled and self.n <= self.peer_event_limit:
                fresh = np.flatnonzero(arrived & ~self.joined)
                for i in fresh:
                    self.telemetry.emit(
                        "peer_join", t=max(t, self.arrive[i]),
                        client=self.peer_ids[i], torrent=self.torrent,
                    )
                self.joined[arrived] = True
            pending_arrivals = (~arrived).any()
            if not leech.any():
                if not pending_arrivals:
                    break
                # idle: fast-forward to the next arrival boundary
                nxt = self.arrive[~arrived].min()
                self.now = t + dt0 * max(1.0, np.floor((nxt - t) / dt0))
                ph["bookkeeping"] += perf_counter() - tick_t0
                continue
            if t >= until:
                break
            # tick length: snap onto the next fault event
            dt = min(dt0, until - t) if math.isfinite(until) else dt0
            if ei < len(ev) and ev[ei][0] < t + dt - 1e-9:
                dt = ev[ei][0] - t
            if dt <= 0:
                break

            live_rank = [m for m in self._mirror_rank if self.mirror_alive[m]]
            # --- expire stale fallback picks: a swarm-routed piece queued
            # for origin rescue while it had no replicas goes back to the
            # swarm the moment holders appear — only unstarted streams
            # (zero progress) switch, mid-range fetches keep their bytes.
            # Without this, peers that queued during bootstrap drain
            # through the admission cap in O(n) waves at fleet scale.
            if self.policy.mode == "swarm_first":
                rows = np.flatnonzero(
                    leech & (self.cur_http >= 0) & (self.prog_http <= 0.0)
                )
                if rows.size:
                    picks = self.cur_http[rows]
                    stale = self.swarm_class[picks] & (self.replicas[picks] > 0)
                    self.cur_http[rows[stale]] = -1
            # --- piece selection (only rows with an idle stream)
            self._select(
                np.flatnonzero(leech & (self.cur_http < 0)),
                "http", bool(live_rank),
            )
            if self.replicas.max() > 0:
                self._select(
                    np.flatnonzero(leech & (self.cur_swarm < 0)),
                    "swarm", bool(live_rank),
                )
            # --- rechoke: resample every source table periodically
            if self.ticks % self.rechoke_ticks == 0:
                self._resample_sources(
                    np.flatnonzero(leech & (self.cur_swarm >= 0))
                )

            # --- HTTP admission: index order (FCFS for a flash crowd),
            # ranked live mirrors fill to their admission caps in turn
            http_rows = np.flatnonzero(leech & (self.cur_http >= 0))
            mirror_of = np.full(self.n, -1, dtype=np.int64)
            if live_rank:
                lo = 0
                for m in live_rank:
                    hi = min(lo + int(caps[m]), http_rows.size)
                    mirror_of[http_rows[lo:hi]] = m
                    lo = hi
                    if lo >= http_rows.size:
                        break
            admitted = http_rows[mirror_of[http_rows] >= 0]

            # --- flow table: peers 0..n-1, mirrors n..n+M-1
            n = self.n
            swarm_rows = np.flatnonzero(leech & (self.cur_swarm >= 0))
            s_src = self.src_tab[swarm_rows].ravel()
            s_dst = np.repeat(swarm_rows, self.fanout)
            keep = (s_src >= 0) & present[np.clip(s_src, 0, None)]
            s_src, s_dst = s_src[keep], s_dst[keep]
            # per-uploader concurrency: drop random excess flows above the
            # unchoke budget (choking, in aggregate)
            budget = self.upload_slots // ppr  # distinct-pair slots
            if s_src.size:
                cnt = np.bincount(s_src, minlength=n)
                if (cnt > budget).any():
                    order = np.lexsort(
                        (self.rng.random(s_src.size), s_src)
                    )
                    ss = s_src[order]
                    starts = np.zeros(n, dtype=np.int64)
                    starts[1:] = np.cumsum(np.bincount(ss, minlength=n))[:-1]
                    rank = np.arange(ss.size) - starts[ss]
                    keep2 = np.zeros(s_src.size, dtype=bool)
                    keep2[order] = rank < budget
                    s_src, s_dst = s_src[keep2], s_dst[keep2]
            # per-peer-requests: each surviving pair carries ppr flows
            if ppr > 1 and s_src.size:
                s_src = np.repeat(s_src, ppr)
                s_dst = np.repeat(s_dst, ppr)
            h_src = n + mirror_of[admitted]
            h_dst = admitted
            fsrc = np.concatenate([s_src, h_src])
            fdst = np.concatenate([s_dst, h_dst])
            nsw = s_src.size

            if fsrc.size:
                link_of = link_cap = None
                if use_spine:
                    pod_src = np.where(
                        fsrc < n, self.pods[np.clip(fsrc, 0, n - 1)], -1
                    )
                    pod_dst = self.pods[fdst]
                    cross = (pod_src != pod_dst) | (pod_src < 0)
                    link_of = np.where(cross, 0, -1).astype(np.int64)
                    link_cap = np.array([self.spine_bps])
                wf_t0 = perf_counter()
                if self._dev is not None:
                    # the water-filling kernel handles spine links natively
                    rates = self._waterfill_dev(
                        fsrc, fdst, up_cap, down_cap, link_of, link_cap
                    )
                elif self._backend == "jit" and link_of is None:
                    rates = self._waterfill_dev(fsrc, fdst, up_cap, down_cap)
                else:
                    rates = waterfill_rates(
                        fsrc, fdst, up_cap, down_cap, link_of, link_cap
                    )
                ph["waterfill"] += perf_counter() - wf_t0
                # --- advance one tick
                sw_in = np.bincount(
                    fdst[:nsw], weights=rates[:nsw], minlength=n
                )
                ht_in = np.bincount(
                    fdst[nsw:], weights=rates[nsw:], minlength=n
                )
                self.prog_swarm += sw_in * dt
                self.prog_http += ht_in * dt
                out = np.bincount(
                    fsrc, weights=rates, minlength=n + M
                )
                self.uploaded_wire += out[:n] * dt
                if use_spine:
                    self.spine_bytes += float(
                        rates[link_of >= 0].sum()
                    ) * dt
            t_end = t + dt
            # --- completions (loop: a fat pipe can finish several pieces
            # in one tick; chained selection keeps streams busy)
            for _ in range(self.num_pieces + 1):
                did = False
                for stream in ("http", "swarm"):
                    cur = self.cur_http if stream == "http" else self.cur_swarm
                    prog = (
                        self.prog_http if stream == "http"
                        else self.prog_swarm
                    )
                    rows = np.flatnonzero(
                        (cur >= 0)
                        & (prog >= self.piece_sizes[np.clip(cur, 0, None)]
                           - 1e-6)
                    )
                    if rows.size == 0:
                        continue
                    did = True
                    pieces = cur[rows]
                    sizes = self.piece_sizes[pieces]
                    # duplicate-free by construction (selection never picks
                    # a held piece and the two streams exclude each other)
                    self.have[rows, pieces] = True
                    self.nhave[rows] += 1
                    np.add.at(self.replicas, pieces, 1)
                    if self._dev is not None:
                        self._dev.add_pieces(rows, pieces)
                    prog[rows] -= sizes
                    self.downloaded[rows] += sizes
                    was_http_class = ~self.swarm_class[pieces]
                    np.add.at(
                        self.n_missing_http, rows[was_http_class], -1
                    )
                    np.add.at(
                        self.n_missing_swarm, rows[~was_http_class], -1
                    )
                    if stream == "http":
                        np.add.at(
                            self.mirror_uploaded, mirror_of[rows], sizes
                        )
                    cur[rows] = -1
                    self._select(rows, stream, bool(live_rank))
                if not did:
                    break
            # stale pools: a stream with no piece must not bank progress
            self.prog_http[self.cur_http < 0] = 0.0
            self.prog_swarm[self.cur_swarm < 0] = 0.0
            # --- peer completion at the end of the delivering tick
            done_rows = np.flatnonzero(
                leech & (self.nhave >= self.num_pieces)
            )
            if done_rows.size:
                self.completed_at[done_rows] = t_end
                finite_linger = np.isfinite(self.linger[done_rows])
                lrows = done_rows[finite_linger]
                self.departed_at[lrows] = np.minimum(
                    self.departed_at[lrows],
                    t_end + self.linger[lrows],
                )
                if self.telemetry.enabled \
                        and self.n <= self.peer_event_limit:
                    for i in done_rows:
                        self.telemetry.emit(
                            "peer_complete", t=t_end,
                            client=self.peer_ids[i], torrent=self.torrent,
                            nbytes=float(self.downloaded[i]),
                        )
            self.now = t_end
            self.ticks += 1
            if self.sampler is not None:
                tel_t0 = perf_counter()
                while self._next_sample <= self.now + 1e-9:
                    self.sampler.sample(self._next_sample)
                    self._next_sample += self.sampler.interval
                ph["telemetry"] += perf_counter() - tel_t0
            # bookkeeping = tick wall minus what the timed phases took
            ph["bookkeeping"] += (perf_counter() - tick_t0) - (
                ph["select"] + ph["waterfill"] + ph["telemetry"] - snap
            )
        else:
            raise RuntimeError("max_ticks exceeded — runaway fleet run")
        return self._result()

    # ------------------------------------------------------------- result
    def _result(self) -> FleetResult:
        return FleetResult(
            peer_ids=self.peer_ids,
            arrive_at=self.arrive.copy(),
            completed_at=self.completed_at.copy(),
            departed_at=np.where(
                self.departed, self.departed_at, INF
            ),
            downloaded=self.downloaded.copy(),
            uploaded_wire=self.uploaded_wire.copy(),
            mirror_names=[s.name for s in self.mirror_specs],
            mirror_uploaded=self.mirror_uploaded.copy(),
            spine_bytes=self.spine_bytes,
            sim_time=self.now,
            ticks=self.ticks,
            dt=self.dt,
            phase_seconds=dict(self.phase_seconds),
        )

    # ------------------------------------------------------------- gauges
    def metrics_gauges(self) -> dict:
        """Aggregate sampler gauges (schema core shared with the object
        engines). Pure observation; per-peer values never leave here —
        above ``peer_event_limit`` this is the *only* telemetry."""
        present = (
            (self.arrive <= self.now + 1e-9) & ~self.departed
            if self._frozen else np.zeros(0, dtype=bool)
        )
        complete = (
            np.isfinite(self.completed_at) if self._frozen
            else np.zeros(0, dtype=bool)
        )
        gauges = {
            "seeders": float((present & complete).sum()),
            "leechers": float((present & ~complete).sum()),
            "origin_bytes": float(self.mirror_uploaded.sum())
            if self._frozen else 0.0,
            "cache_bytes": 0.0,
            "peer_bytes": float(self.uploaded_wire.sum())
            if self._frozen else 0.0,
            "inflight_hedges": 0.0,
        }
        if self._frozen and self.replicas.size:
            gauges["min_replication"] = float(self.replicas.min())
            gauges["mean_replication"] = float(self.replicas.mean())
        else:
            gauges["min_replication"] = 0.0
            gauges["mean_replication"] = 0.0
        return gauges
