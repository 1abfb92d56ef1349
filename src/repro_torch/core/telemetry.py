"""Flight-recorder telemetry: event tracing, tick metrics, trace checking.

End-of-run aggregates (``SwarmStats``, ``SwarmResult``) say *how much* was
served; they cannot say *when* a mirror failed over, *why* a hedge fired, or
how piece replication evolved during a churn storm. This module records that
time-resolved story without perturbing the simulation:

- :class:`TraceRecorder` — append-only log of typed lifecycle events with
  sim-time timestamps and torrent/client/origin tags. Engines guard every
  emission with ``if telemetry.enabled:`` so a disabled recorder costs one
  attribute check and consumes no RNG; results are bit-identical to an
  untraced run.
- :class:`MetricsSampler` — per-tick gauges (tier egress, link utilization,
  seeder/leecher counts, piece replication, in-flight hedges) in numpy ring
  buffers, fed by an engine-supplied source callable.
- Exporters — JSONL (one event per line), Chrome ``trace_event`` JSON for
  chrome://tracing, and a ``BENCH_*``-style metrics block. Exporting an
  empty trace is a no-op: no file is written.
- :class:`TraceChecker` — replays a trace against causal invariants (no
  request to a dead mirror, hedge byte reconciliation, fairness-ledger
  monotonicity, request-before-done ordering) so tests and CI assert
  causality, not just totals.

The module sits at the bottom of the core dependency graph: it imports no
engine code at module scope, and engines import :data:`NULL_RECORDER` from
here.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

__all__ = [
    "TRACE_EVENT_KINDS",
    "TraceEvent",
    "TraceRecorder",
    "NULL_RECORDER",
    "TelemetrySpec",
    "MetricsSampler",
    "TraceChecker",
]

# The full event taxonomy. Engines may emit a subset (flow-control kinds
# like ``retry`` and ``admission_deferred`` are engine-specific), but no
# engine may emit a kind outside this tuple.
TRACE_EVENT_KINDS: tuple[str, ...] = (
    "request_issued",     # a transfer was admitted and started
    "piece_done",         # a piece arrived and was accepted (verified, new)
    "piece_failed",       # a piece arrived but was rejected, or was aborted
    "hedge_fired",        # a duplicate request was issued against the tail
    "hedge_cancelled",    # the losing half of a hedge pair was ledgered
    "retry",              # a backoff retry was scheduled after origin churn
    "mirror_fail",        # a web-seed endpoint died
    "mirror_heal",        # a dead web-seed endpoint rejoined
    "mirror_failover",    # a client rerouted off a failed/corrupt mirror
    "cache_fill",         # a pod cache committed a piece fetched upstream
    "cache_spill",        # a saturated cache spilled a request to the mirrors
    "admission_deferred", # an admission slot or fairness grant was denied
    "fair_service",       # cumulative normalized service (fairness ledger)
    "peer_join",          # a client joined the swarm
    "peer_churn",         # a client departed (info: mid_download / post_complete)
    "peer_complete",      # a client finished its download
    "repair_scheduled",   # the repair controller queued a re-seed of a piece
    "repair_done",        # a scheduled re-seed landed (info: serving tier)
    "repair_evict",       # read-repair evicted a corrupt replica (info: holder)
    "piece_poisoned",     # a Byzantine peer served a corrupted piece
    "peer_banned",        # quarantine banned a peer past the hash-fail threshold
    "peer_parole",        # a banned peer's timed parole elapsed; it rejoined
    "tracker_fail",       # the tracker went dark (control plane down)
    "tracker_heal",       # the tracker came back; clients re-announce
    "partition",          # the network partitioned (info: target spec)
    "partition_heal",     # the partition healed; sides reconcile
)

# Kinds that constitute the engine-independent "skeleton" of a download:
# the per-client order of these is identical between the time-domain and
# byte-domain engines on the same scenario (flow-control kinds are not).
SKELETON_KINDS: tuple[str, ...] = (
    "peer_join", "request_issued", "piece_done", "peer_complete",
)


@dataclasses.dataclass(slots=True)
class TraceEvent:
    """One recorded lifecycle event. Unused tags stay ``None``."""

    t: float
    kind: str
    torrent: Optional[str] = None
    client: Optional[str] = None
    origin: Optional[str] = None
    piece: Optional[int] = None
    nbytes: Optional[float] = None
    value: Optional[float] = None
    info: Optional[str] = None

    def to_dict(self) -> dict:
        out: dict = {"t": self.t, "kind": self.kind}
        for field in ("torrent", "client", "origin", "piece", "nbytes",
                      "value", "info"):
            val = getattr(self, field)
            if val is not None:
                out[field] = val
        return out


class TraceRecorder:
    """Append-only event log with a sim-time clock.

    ``clock`` supplies the default timestamp (the time engines bind it to
    ``net.now``; the byte engine stamps rounds explicitly). A recorder with
    ``enabled=False`` is inert — :data:`NULL_RECORDER` is the shared
    singleton engines fall back to, so emission sites need only an
    ``if telemetry.enabled:`` guard.
    """

    def __init__(self, enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.enabled = enabled
        self.clock = clock
        self.events: list[TraceEvent] = []

    def __len__(self) -> int:
        return len(self.events)

    # ------------------------------------------------------------- recording
    def emit(
        self,
        kind: str,
        *,
        t: Optional[float] = None,
        torrent: Optional[str] = None,
        client: Optional[str] = None,
        origin: Optional[str] = None,
        piece: Optional[int] = None,
        nbytes: Optional[float] = None,
        value: Optional[float] = None,
        info: Optional[str] = None,
    ) -> None:
        if not self.enabled:
            return
        if kind not in TRACE_EVENT_KINDS:
            raise ValueError(f"unknown trace event kind {kind!r}")
        if t is None:
            t = self.clock() if self.clock is not None else 0.0
        self.events.append(TraceEvent(
            t=float(t), kind=kind, torrent=torrent, client=client,
            origin=origin, piece=piece, nbytes=nbytes, value=value, info=info,
        ))

    # ------------------------------------------------------------- queries
    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for ev in self.events:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    def skeleton(self, torrent: Optional[str] = None) -> dict[str, tuple[str, ...]]:
        """Per-client first-occurrence order of :data:`SKELETON_KINDS`.

        Only clients with a ``peer_join`` are included (pod caches issue
        requests but never join), so the result is comparable between the
        time-domain and byte-domain engines on the same scenario.
        """
        joined = {
            ev.client for ev in self.events
            if ev.kind == "peer_join"
            and (torrent is None or ev.torrent == torrent)
        }
        out: dict[str, list[str]] = {}
        for ev in self.events:
            if ev.kind not in SKELETON_KINDS or ev.client not in joined:
                continue
            if torrent is not None and ev.torrent != torrent:
                continue
            seq = out.setdefault(ev.client, [])
            if ev.kind not in seq:
                seq.append(ev.kind)
        return {client: tuple(seq) for client, seq in out.items()}

    def first_byte_latencies(
        self, torrent: str, arrivals: dict[str, float]
    ) -> dict[str, float]:
        """Seconds from each client's arrival to its first accepted piece.

        ``arrivals`` maps client id -> arrival sim-time; clients with no
        accepted piece in the trace are omitted.
        """
        out: dict[str, float] = {}
        for ev in self.events:
            if ev.kind != "piece_done" or ev.torrent != torrent:
                continue
            if ev.client in arrivals and ev.client not in out:
                out[ev.client] = ev.t - arrivals[ev.client]
        return out

    # ------------------------------------------------------------- exporters
    def to_jsonl(self, path: str | Path) -> Optional[Path]:
        """Write one JSON object per event. No-op (no file) when empty."""
        if not self.events:
            return None
        path = Path(path)
        with path.open("w", encoding="utf-8") as fh:
            for ev in self.events:
                fh.write(json.dumps(ev.to_dict(), sort_keys=True) + "\n")
        return path

    def to_chrome(self, path: str | Path) -> Optional[Path]:
        """Write Chrome ``trace_event`` JSON (load in chrome://tracing).

        Torrents map to processes and clients to threads. Each
        ``request_issued``/``hedge_fired`` is paired FIFO with the next
        resolution (``piece_done``/``piece_failed``) for the same
        (torrent, client, piece) into an ``X`` complete event; everything
        else becomes an ``i`` instant. Timestamps are microseconds of
        sim-time. No-op (no file) when the trace is empty.
        """
        if not self.events:
            return None
        pids: dict[str, int] = {}
        tids: dict[tuple[str, str], int] = {}
        trace_events: list[dict] = []

        def _pid(torrent: Optional[str]) -> int:
            key = torrent or "-"
            if key not in pids:
                pids[key] = len(pids) + 1
                trace_events.append({
                    "ph": "M", "name": "process_name", "pid": pids[key],
                    "tid": 0, "args": {"name": key},
                })
            return pids[key]

        def _tid(torrent: Optional[str], client: Optional[str]) -> int:
            if client is None:
                return 0
            key = (torrent or "-", client)
            if key not in tids:
                tids[key] = len(tids) + 1
                trace_events.append({
                    "ph": "M", "name": "thread_name", "pid": _pid(torrent),
                    "tid": tids[key], "args": {"name": client},
                })
            return tids[key]

        open_reqs: dict[tuple, list[TraceEvent]] = {}
        for ev in self.events:
            pid, tid = _pid(ev.torrent), _tid(ev.torrent, ev.client)
            args = {k: v for k, v in ev.to_dict().items()
                    if k not in ("t", "kind")}
            key = (ev.torrent, ev.client, ev.piece)
            if ev.kind in ("request_issued", "hedge_fired"):
                open_reqs.setdefault(key, []).append(ev)
                continue
            if ev.kind in ("piece_done", "piece_failed") and open_reqs.get(key):
                start = open_reqs[key].pop(0)
                trace_events.append({
                    "ph": "X", "name": f"piece {ev.piece}",
                    "cat": ev.kind, "pid": pid, "tid": tid,
                    "ts": start.t * 1e6,
                    "dur": max(ev.t - start.t, 0.0) * 1e6,
                    "args": args,
                })
                continue
            trace_events.append({
                "ph": "i", "name": ev.kind, "cat": ev.kind, "pid": pid,
                "tid": tid, "ts": ev.t * 1e6, "s": "t", "args": args,
            })
        # requests never resolved (aborted without a piece_failed, or still
        # in flight at shutdown) render as zero-duration instants
        for reqs in open_reqs.values():
            for ev in reqs:
                trace_events.append({
                    "ph": "i", "name": ev.kind, "cat": ev.kind,
                    "pid": _pid(ev.torrent), "tid": _tid(ev.torrent, ev.client),
                    "ts": ev.t * 1e6, "s": "t",
                    "args": {k: v for k, v in ev.to_dict().items()
                             if k not in ("t", "kind")},
                })
        path = Path(path)
        path.write_text(json.dumps({"traceEvents": trace_events},
                                   sort_keys=True), encoding="utf-8")
        return path


NULL_RECORDER = TraceRecorder(enabled=False)


@dataclasses.dataclass
class TelemetrySpec:
    """Declarative telemetry config carried by ``ScenarioSpec``.

    ``enabled`` is the master switch: when False (the default) the run is
    bit-identical to an untraced run — no recorder, no sampler, no extra
    timer activity. ``sample_interval`` is seconds of sim-time in the time
    engines and rounds in the byte engine. ``per_peer_events_max`` bounds
    per-peer lifecycle tracing in the fleet engine: above that population
    the engine emits aggregate sampler gauges only (a 100k-peer trace of
    join/complete events would dwarf the simulation itself).
    """

    enabled: bool = False
    trace: bool = True           # record lifecycle events
    metrics: bool = True         # sample per-tick gauges
    sample_interval: float = 5.0
    capacity: int = 4096         # metrics ring-buffer depth
    per_peer_events_max: int = 256

    def __post_init__(self) -> None:
        if self.sample_interval <= 0:
            raise ValueError("sample_interval must be positive")
        if self.capacity < 2:
            raise ValueError("capacity must be >= 2")
        if self.per_peer_events_max < 0:
            raise ValueError("per_peer_events_max must be >= 0")

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, data: dict) -> "TelemetrySpec":
        from .scheduler import spec_from_dict  # late: avoid import cycle
        return spec_from_dict(cls, data)


class MetricsSampler:
    """Per-tick gauges in fixed-capacity numpy ring buffers.

    ``source`` is an engine-supplied callable returning ``{gauge: value}``;
    its key set must be stable after the first call (buffers are allocated
    lazily from it). When more than ``capacity`` samples arrive the oldest
    are overwritten and counted in ``dropped``.
    """

    def __init__(self, source: Callable[[], dict[str, float]],
                 capacity: int = 4096, interval: float = 5.0) -> None:
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self.source = source
        self.capacity = int(capacity)
        self.interval = float(interval)
        self._t = np.zeros(self.capacity, dtype=np.float64)
        self._buf: dict[str, np.ndarray] = {}
        self._n = 0

    @property
    def samples(self) -> int:
        """Total samples taken (including any overwritten)."""
        return self._n

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def sample(self, now: float) -> None:
        gauges = self.source()
        if not self._buf:
            self._buf = {
                name: np.zeros(self.capacity, dtype=np.float64)
                for name in gauges
            }
        idx = self._n % self.capacity
        self._t[idx] = float(now)
        for name, arr in self._buf.items():
            arr[idx] = float(gauges.get(name, 0.0))
        self._n += 1

    def series(self) -> dict[str, np.ndarray]:
        """Chronologically ordered series, ``"t"`` plus one per gauge."""
        n = min(self._n, self.capacity)
        if self._n <= self.capacity:
            order = np.arange(n)
        else:
            head = self._n % self.capacity
            order = np.r_[head:self.capacity, 0:head]
        out = {"t": self._t[order].copy()}
        for name, arr in self._buf.items():
            out[name] = arr[order].copy()
        return out

    def to_block(self) -> dict:
        """A ``BENCH_*.json``-style time-series block.

        Cumulative ``*_bytes`` gauges additionally get a derived
        ``*_rate_bps`` series (forward difference over the sample times,
        leading zero) — the per-tier egress rates.
        """
        series = self.series()
        t = series["t"]
        block_series: dict[str, list[float]] = {
            name: [float(x) for x in arr] for name, arr in series.items()
        }
        if len(t) >= 2:
            dt = np.diff(t)
            dt[dt <= 0] = np.inf
            for name, arr in series.items():
                if name.endswith("_bytes"):
                    rate = np.r_[0.0, np.diff(arr) / dt]
                    block_series[name[:-6] + "_rate_bps"] = [
                        float(x) for x in rate
                    ]
        return {
            "interval": self.interval,
            "samples": self._n,
            "capacity": self.capacity,
            "dropped": self.dropped,
            "series": block_series,
        }

    def to_json(self, path: str | Path) -> Optional[Path]:
        """Write the metrics block. No-op (no file) when never sampled."""
        if self._n == 0:
            return None
        path = Path(path)
        path.write_text(json.dumps(self.to_block(), indent=2, sort_keys=True),
                        encoding="utf-8")
        return path


class TraceChecker:
    """Replays a trace against causal invariants.

    Events are checked in recorded (causal) order, not sorted by timestamp:
    same-tick events keep their emission order, which is the causal order.

    Invariants:

    - **I1 dead-mirror silence** — after a ``mirror_fail`` for origin O and
      until a ``mirror_heal``, no ``request_issued``, ``hedge_fired``,
      ``piece_done`` or ``cache_fill`` may name O as its origin.
    - **I2 hedge reconciliation** — every ``hedge_cancelled`` has a prior
      ``hedge_fired`` for the same (torrent, client, piece), and the summed
      ``nbytes`` equals the engine's ``hedge_cancelled_bytes`` ledger when
      one is supplied.
    - **I3 fairness monotonicity** — ``fair_service`` values are
      non-decreasing per (torrent, origin): normalized service is
      cumulative by construction.
    - **I4 single acceptance** — at most one ``piece_done`` per
      (torrent, client, piece).
    - **I5 request-before-done** — every ``piece_done`` is preceded by a
      ``request_issued`` or ``hedge_fired`` for the same key.
    - **I6 join-first** — a client's events never precede its
      ``peer_join`` (clients without one, e.g. pod caches, are exempt).
    - **I7 repair causality** — every ``repair_done`` has a prior
      ``repair_scheduled`` for the same (torrent, client, piece).
    - **I8 banned-peer silence** — after a ``peer_banned`` for peer P and
      until a ``peer_parole`` for P, no ``piece_done`` or
      ``request_issued`` may name P as its serving origin (quarantined
      peers receive no handouts and serve no bytes).
    - **I9 paired fault windows** — ``tracker_heal`` requires an open
      ``tracker_fail`` window for the same target, ``partition_heal`` an
      open ``partition``; re-opening an already-open window is a violation.
    - **I10 partition isolation** — while a partition is open, no
      ``piece_done`` may cross it. Requires ``pod_of`` (entity name ->
      pod index; unlisted entities, e.g. mirrors, count as the spineside
      core). Skipped when ``pod_of`` is not supplied.
    """

    def __init__(self, trace: "TraceRecorder | Iterable[TraceEvent]") -> None:
        events = trace.events if isinstance(trace, TraceRecorder) else trace
        self.events: list[TraceEvent] = list(events)

    def check(self, *, hedge_cancelled_bytes: Optional[float] = None,
              rel_tol: float = 1e-6,
              pod_of: Optional[dict[str, int]] = None) -> list[str]:
        """Return a list of violation strings (empty == trace is clean)."""
        problems: list[str] = []
        dead: dict[str, float] = {}
        join_t: dict[tuple, float] = {}
        requested: set[tuple] = set()
        done: set[tuple] = set()
        fired: set[tuple] = set()
        fair_last: dict[tuple, float] = {}
        repair_sched: set[tuple] = set()
        banned: dict[str, float] = {}
        tracker_dark: dict[str, float] = {}
        partition_open: Optional[str] = None
        cancelled_total = 0.0

        def _side(entity: Optional[str], target: str) -> int:
            """Which partition side ``entity`` is on under ``target``
            (``"spine"`` or ``"pods:i,j"``). Unlisted entities are the
            core (side -1 for spine cuts, side 0 for pod isolation)."""
            pod = (pod_of or {}).get(entity or "", -1)
            if target == "spine":
                return pod
            isolated = {int(p) for p in target.split(":", 1)[1].split(",")}
            return 1 if pod in isolated else 0

        for i, ev in enumerate(self.events):
            where = f"event[{i}] t={ev.t:g} {ev.kind}"
            ckey = (ev.torrent, ev.client)
            if ev.client is not None and ckey in join_t \
                    and ev.t < join_t[ckey] - 1e-9:
                problems.append(
                    f"{where}: client {ev.client!r} active at t={ev.t:g} "
                    f"before its peer_join at t={join_t[ckey]:g}"
                )
            if ev.kind == "mirror_fail" and ev.origin is not None:
                dead[ev.origin] = ev.t
            elif ev.kind == "mirror_heal" and ev.origin is not None:
                dead.pop(ev.origin, None)
            elif ev.kind == "peer_join":
                join_t.setdefault(ckey, ev.t)
            elif ev.kind == "peer_banned" and ev.client is not None:
                banned[ev.client] = ev.t
            elif ev.kind == "peer_parole" and ev.client is not None:
                banned.pop(ev.client, None)
            elif ev.kind == "tracker_fail":
                tkey = ev.info or "tracker"
                if tkey in tracker_dark:
                    problems.append(
                        f"{where}: tracker_fail for {tkey!r} while already "
                        f"dark since t={tracker_dark[tkey]:g}"
                    )
                tracker_dark[tkey] = ev.t
            elif ev.kind == "tracker_heal":
                tkey = ev.info or "tracker"
                if tkey not in tracker_dark:
                    problems.append(
                        f"{where}: tracker_heal for {tkey!r} without an "
                        "open tracker_fail window"
                    )
                tracker_dark.pop(tkey, None)
            elif ev.kind == "partition":
                if partition_open is not None:
                    problems.append(
                        f"{where}: partition while one is already open "
                        f"({partition_open!r})"
                    )
                partition_open = ev.info or "spine"
            elif ev.kind == "partition_heal":
                if partition_open is None:
                    problems.append(
                        f"{where}: partition_heal without an open partition"
                    )
                partition_open = None

            if ev.kind in ("request_issued", "hedge_fired", "piece_done",
                           "cache_fill") and ev.origin in dead:
                problems.append(
                    f"{where}: traffic to dead mirror {ev.origin!r} "
                    f"(failed at t={dead[ev.origin]:g}, piece={ev.piece})"
                )
            if ev.kind in ("request_issued", "piece_done") \
                    and ev.origin in banned:
                problems.append(
                    f"{where}: traffic served by banned peer {ev.origin!r} "
                    f"(banned at t={banned[ev.origin]:g}, piece={ev.piece})"
                )
            if partition_open is not None and pod_of is not None \
                    and ev.kind == "piece_done" and ev.origin is not None:
                cs = _side(ev.client, partition_open)
                os_ = _side(ev.origin, partition_open)
                if cs != os_:
                    problems.append(
                        f"{where}: cross-partition bytes "
                        f"({ev.origin!r} side {os_} -> {ev.client!r} "
                        f"side {cs}, partition {partition_open!r})"
                    )

            key = (ev.torrent, ev.client, ev.piece)
            if ev.kind == "request_issued":
                requested.add(key)
            elif ev.kind == "hedge_fired":
                fired.add(key)
                requested.add(key)
            elif ev.kind == "piece_done":
                if key in done:
                    problems.append(
                        f"{where}: duplicate piece_done for client "
                        f"{ev.client!r} piece {ev.piece}"
                    )
                done.add(key)
                if key not in requested:
                    problems.append(
                        f"{where}: piece_done without a prior request "
                        f"(client {ev.client!r} piece {ev.piece})"
                    )
            elif ev.kind == "hedge_cancelled":
                cancelled_total += float(ev.nbytes or 0.0)
                if key not in fired:
                    problems.append(
                        f"{where}: hedge_cancelled without a prior "
                        f"hedge_fired (client {ev.client!r} piece {ev.piece})"
                    )
            elif ev.kind == "repair_scheduled":
                repair_sched.add(key)
            elif ev.kind == "repair_done":
                if key not in repair_sched:
                    problems.append(
                        f"{where}: repair_done without a prior "
                        f"repair_scheduled (client {ev.client!r} "
                        f"piece {ev.piece})"
                    )
            elif ev.kind == "fair_service":
                fkey = (ev.torrent, ev.origin)
                last = fair_last.get(fkey)
                val = float(ev.value or 0.0)
                if last is not None and val < last - 1e-9:
                    problems.append(
                        f"{where}: fairness ledger for {fkey} went backwards "
                        f"({last:g} -> {val:g})"
                    )
                fair_last[fkey] = max(val, last or 0.0)

        if hedge_cancelled_bytes is not None:
            tol = rel_tol * max(abs(hedge_cancelled_bytes), 1.0)
            if abs(cancelled_total - hedge_cancelled_bytes) > tol:
                problems.append(
                    "hedge_cancelled events sum to "
                    f"{cancelled_total:g} bytes but the engine ledgered "
                    f"{hedge_cancelled_bytes:g}"
                )
        return problems

    def failover_summary(self) -> dict[str, dict[str, float]]:
        """Per failed origin: death time, failover count, post-death
        requests (the causal mirror-kill story the acceptance test reads)."""
        out: dict[str, dict[str, float]] = {}
        for ev in self.events:
            if ev.kind == "mirror_fail" and ev.origin is not None \
                    and ev.origin not in out:
                out[ev.origin] = {
                    "failed_at": ev.t,
                    "failovers": 0,
                    "requests_after_fail": 0,
                }
        for ev in self.events:
            rec = out.get(ev.origin or "")
            if rec is None or ev.t < rec["failed_at"]:
                continue
            if ev.kind == "mirror_failover":
                rec["failovers"] += 1
            elif ev.kind in ("request_issued", "hedge_fired", "cache_fill"):
                rec["requests_after_fail"] += 1
        return out
