"""Self-healing durability tier: proactive re-seeding + read-repair.

The paper's promise is that the swarm keeps data *available* as the
sharer's burden shrinks — but availability decays silently: churned peers
take replicas with them, a failed pod takes a whole cache tier, and a
corrupt replica poisons every peer that trades with it. This module closes
the loop the tracker's ``availability_map`` opened:

- :class:`RepairSpec` — declarative repair policy carried by
  ``ScenarioSpec`` (target replication factor, scan interval, bandwidth
  budget, hysteresis). ``None``/``enabled=False`` is the master off switch:
  runs are bit-identical to a repair-free build.
- :class:`RepairController` — engine-agnostic scan loop. Each scan reads
  the live piece→replica map, finds pieces whose *effective* replication
  (live replicas + in-flight repairs) has fallen below the hysteresis
  band, and asks the engine to re-seed them — most-degraded first, priced
  against a per-scan byte allowance so repair traffic cannot starve
  foreground transfers. Engines report transfer outcomes back through
  ``note_done`` / ``note_failed``, and read-repair evictions through
  ``note_evict``; the controller ledgers repair bytes by serving tier and
  tracks time-to-repair episodes for the durability benchmark.

The controller is deterministic: no RNG, scheduling order is (most
degraded, lowest piece index), and destination choice is delegated to the
engine's ``fetch`` callable (which picks the lexicographically first
eligible client). It imports no engine code; engines import it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from .metainfo import MetaInfo
from .telemetry import NULL_RECORDER, TraceRecorder

__all__ = ["RepairSpec", "RepairController", "REPAIR_TIERS"]

# Serving tiers a repair transfer can be sourced from, in preference order
# (mirrors first: they never decay; pod caches next: spine-free; peers
# last: they spend community upload slots).
REPAIR_TIERS: tuple[str, ...] = ("origin", "pod_cache", "peer")


@dataclasses.dataclass
class RepairSpec:
    """Declarative repair policy carried by ``ScenarioSpec``.

    ``target_replication`` is the floor the controller restores pieces to
    (counting every live replica: origins, caches, and peers).
    ``scan_interval`` is seconds of sim-time in the time engine and rounds
    in the byte engine. ``budget_bps`` caps repair traffic: each scan may
    schedule at most ``budget_bps * scan_interval`` bytes of re-seeds (the
    allowance does not carry over — unused budget is gone, so a burst
    after a quiet period cannot exceed the configured rate).
    ``hysteresis`` widens the trigger into a dead band: a piece starts
    repairing only when its effective replication drops *below*
    ``target_replication - hysteresis``, but is then restored all the way
    to ``target_replication`` — so replication oscillating at the target
    boundary cannot thrash the scheduler.
    ``prioritize`` orders the scan queue: ``"degraded"`` (default, the
    PR 9 order — most-degraded first, then piece index) or ``"demand"`` —
    pieces hot in live clients' ``needed`` masks first (ties broken by
    degradation then index), so repair bandwidth lands where downloads
    are actually waiting. The trigger set is identical either way; only
    the order within one scan changes.
    """

    enabled: bool = True
    target_replication: int = 2
    scan_interval: float = 5.0
    budget_bps: float = float("inf")
    hysteresis: int = 0
    prioritize: str = "degraded"

    def __post_init__(self) -> None:
        if self.target_replication < 1:
            raise ValueError("target_replication must be >= 1")
        if self.scan_interval <= 0:
            raise ValueError("scan_interval must be positive")
        if self.budget_bps <= 0:
            raise ValueError("budget_bps must be positive")
        if not 0 <= self.hysteresis < self.target_replication:
            raise ValueError(
                "hysteresis must satisfy 0 <= hysteresis < target_replication"
            )
        if self.prioritize not in ("degraded", "demand"):
            raise ValueError(
                "prioritize must be 'degraded' or 'demand' "
                f"(got {self.prioritize!r})"
            )

    def to_dict(self) -> dict:
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)}
        if math.isinf(out["budget_bps"]):
            out["budget_bps"] = "inf"  # JSON has no Infinity literal
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "RepairSpec":
        from .scheduler import spec_from_dict  # late: avoid import cycle
        return spec_from_dict(cls, data)


class RepairController:
    """Scan-driven re-seeding against a live availability map.

    ``availability`` returns the current piece→live-replica int64 array
    (the tracker map in the time engine; a local sum in the byte engine).
    ``fetch(piece, now)`` is the engine hook that actually starts one
    re-seed transfer of ``piece`` toward a destination of the engine's
    choice; it returns the destination client id, or ``None`` when no
    transfer can be started (no eligible destination or every source
    rejected admission). The engine later settles the transfer through
    :meth:`note_done` / :meth:`note_failed` keyed by (destination, piece).
    """

    def __init__(
        self,
        spec: RepairSpec,
        metainfo: MetaInfo,
        availability: Callable[[], np.ndarray],
        fetch: Callable[[int, float], Optional[str]],
        telemetry: TraceRecorder = NULL_RECORDER,
        torrent: Optional[str] = None,
        demand: Optional[Callable[[], np.ndarray]] = None,
    ) -> None:
        self.spec = spec
        self.metainfo = metainfo
        self.availability = availability
        self.fetch = fetch
        # piece -> live-client want count (``prioritize="demand"`` only);
        # engines wire it from their needed masks, None falls back to the
        # degradation order
        self.demand = demand
        self.telemetry = telemetry
        self.torrent = torrent if torrent is not None else metainfo.name
        # (destination, piece) -> sim-time the re-seed was scheduled
        self.pending: dict[tuple[str, int], float] = {}
        self._inflight: dict[int, int] = {}
        self.repair_bytes: dict[str, float] = {t: 0.0 for t in REPAIR_TIERS}
        self.repairs_scheduled = 0
        self.repairs_done = 0
        self.repairs_failed = 0
        self.evictions = 0
        self.scans = 0
        # (t, min live replication) per scan + repair-episode bookkeeping
        self.min_history: list[tuple[float, float]] = []
        self.episodes = 0
        self.time_to_repair = 0.0   # duration of the last closed episode
        self._episode_start: Optional[float] = None

    # ------------------------------------------------------------------ scan
    def scan(self, now: float) -> int:
        """One repair pass; returns the number of re-seeds scheduled."""
        spec = self.spec
        if not spec.enabled:
            return 0
        self.scans += 1
        avail = self.availability()
        m = float(avail.min()) if len(avail) else float("inf")
        self.min_history.append((now, m))
        # episode tracking runs on *live* replication (not effective):
        # an episode opens when the floor breaches the dead band and
        # closes when every piece is back at target
        if self._episode_start is None:
            if m < spec.target_replication - spec.hysteresis:
                self._episode_start = now
        elif m >= spec.target_replication:
            self.episodes += 1
            self.time_to_repair = now - self._episode_start
            self._episode_start = None

        allowance = spec.budget_bps * spec.scan_interval
        eff = avail.astype(np.int64, copy=True)
        for piece, n in self._inflight.items():
            eff[piece] += n
        trigger = spec.target_replication - spec.hysteresis
        degraded = np.flatnonzero(eff < trigger)
        if len(degraded) == 0:
            return 0
        # most-degraded first, then piece index — deterministic
        order = degraded[np.argsort(eff[degraded], kind="stable")]
        if spec.prioritize == "demand" and self.demand is not None:
            # hottest pieces first; the stable re-sort keeps the
            # (degradation, index) order within equal-demand ties
            d = np.asarray(self.demand())
            order = order[np.argsort(-d[order], kind="stable")]
        scheduled = 0
        for piece in order.tolist():
            size = self.metainfo.piece_size(piece)
            while eff[piece] < spec.target_replication:
                if allowance < size:
                    return scheduled  # budget exhausted for this scan
                dst = self.fetch(piece, now)
                if dst is None:
                    break  # no eligible destination/source for this piece
                allowance -= size
                self.pending[(dst, piece)] = now
                self._inflight[piece] = self._inflight.get(piece, 0) + 1
                eff[piece] += 1
                scheduled += 1
                self.repairs_scheduled += 1
                if self.telemetry.enabled:
                    self.telemetry.emit(
                        "repair_scheduled", t=now, torrent=self.torrent,
                        client=dst, piece=piece, nbytes=float(size),
                    )
        return scheduled

    # ------------------------------------------------------------- settlement
    def note_done(self, dst: str, piece: int, tier: str,
                  nbytes: float, now: float) -> bool:
        """Settle a landed transfer; True iff it was a scheduled repair.

        Engines call this from their generic completion paths — an organic
        transfer that happens to satisfy a pending repair counts (the
        replica exists either way), which is why the return value gates
        the caller's ledger, not the call itself.
        """
        t0 = self.pending.pop((dst, piece), None)
        if t0 is None:
            return False
        self._dec_inflight(piece)
        self.repairs_done += 1
        self.repair_bytes[tier] = self.repair_bytes.get(tier, 0.0) + nbytes
        if self.telemetry.enabled:
            self.telemetry.emit(
                "repair_done", t=now, torrent=self.torrent, client=dst,
                piece=piece, nbytes=float(nbytes), info=tier,
            )
        return True

    def note_failed(self, dst: str, piece: int) -> bool:
        """A pending repair transfer aborted (churned destination, dead
        source); the next scan re-detects the deficit and reschedules."""
        if self.pending.pop((dst, piece), None) is None:
            return False
        self._dec_inflight(piece)
        self.repairs_failed += 1
        return True

    def note_evict(self, holder: str, piece: int, now: float,
                   reason: str = "corrupt") -> None:
        """Read-repair: a verify failure traced to ``holder``'s replica of
        ``piece``; the replica was evicted and the deficit (if any) will be
        picked up by the next scan."""
        self.evictions += 1
        if self.telemetry.enabled:
            self.telemetry.emit(
                "repair_evict", t=now, torrent=self.torrent, client=holder,
                piece=piece, info=reason,
            )

    def _dec_inflight(self, piece: int) -> None:
        n = self._inflight.get(piece, 0) - 1
        if n > 0:
            self._inflight[piece] = n
        else:
            self._inflight.pop(piece, None)

    # ------------------------------------------------------------- reporting
    @property
    def pending_count(self) -> int:
        return len(self.pending)

    def degraded_count(self) -> int:
        """Pieces currently below target (live replicas, gauges only)."""
        avail = self.availability()
        return int((avail < self.spec.target_replication).sum())

    def summary(self) -> dict:
        """The durability ledger ``bench_durability`` pins at tolerance 0."""
        lows = [m for _, m in self.min_history]
        return {
            "repairs_scheduled": self.repairs_scheduled,
            "repairs_done": self.repairs_done,
            "repairs_failed": self.repairs_failed,
            "evictions": self.evictions,
            "episodes": self.episodes,
            "time_to_repair": self.time_to_repair,
            "min_replication_low": min(lows) if lows else float("inf"),
            "min_replication_final": lows[-1] if lows else float("inf"),
            "repair_bytes": dict(self.repair_bytes),
        }
