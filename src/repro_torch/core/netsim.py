"""Deterministic discrete-event network simulator with max-min fair sharing.

The paper's Table 1 / Fig. 1 claims are statements about *bandwidth
allocation*: a client-server origin fair-shares its egress across N
downloads (per-client speed ~ C/N, origin bytes ~ N·size), while a swarm
lets every downloader's uplink join the serving set. The right fidelity for
reproducing those claims is a **fluid-flow model**: each active transfer
gets the max-min fair rate subject to every node's up/down capacity
(progressive filling), and the simulation advances from rate-change event to
rate-change event. TCP-level dynamics are deliberately abstracted away
(DESIGN.md §6) — the paper's own numbers are projections at this same level.

Everything is deterministic: ties break on insertion order, randomness comes
only from caller-provided seeds.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Optional

import numpy as np

INF = float("inf")


@dataclasses.dataclass
class Node:
    """A network endpoint with dedicated up/down capacity (bytes/sec)."""

    name: str
    up_bps: float
    down_bps: float
    index: int = -1  # assigned by the network
    failed: bool = False


@dataclasses.dataclass
class Link:
    """A shared capacity constraint between node endpoints (bytes/sec).

    Models an aggregation layer the endpoint caps cannot see — e.g. the
    cross-pod *spine*: every flow tagged with the link fair-shares its
    capacity in addition to the per-node up/down limits. ``bytes_through``
    accumulates all payload carried over the link (the cross-pod byte
    ledger the mirror-fabric benchmarks assert on); an infinite capacity
    turns the link into pure telemetry.
    """

    name: str
    capacity_bps: float
    index: int = -1  # assigned by the network
    bytes_through: float = 0.0


@dataclasses.dataclass
class Flow:
    """One in-flight transfer of ``size`` bytes from ``src`` to ``dst``."""

    fid: int
    src: Node
    dst: Node
    size: float
    links: tuple[Link, ...] = ()
    tag: object = None
    on_complete: Optional[Callable[["Flow", float], None]] = None
    on_abort: Optional[Callable[["Flow", float], None]] = None
    remaining: float = 0.0
    rate: float = 0.0
    start_time: float = 0.0
    end_time: float = -1.0
    aborted: bool = False
    # cached incidence rows: a flow's link set is immutable for its whole
    # life (flows are aborted and restarted on re-route, never re-linked),
    # so the link→row indices are computed once here instead of being
    # rebuilt from Python loops on every rate recompute
    link_idx: np.ndarray = dataclasses.field(default=None, repr=False)

    def __post_init__(self) -> None:
        self.remaining = float(self.size)
        self.link_idx = np.fromiter(
            (l.index for l in self.links), dtype=np.int64, count=len(self.links)
        )

    @property
    def done(self) -> bool:
        return self.remaining <= 1e-9 and not self.aborted

    @property
    def transferred(self) -> float:
        """Bytes that actually crossed the wire so far. For a flow aborted
        mid-range (failover, hedge cancellation) this is the partial payload
        the scheduler ledgers as cancelled."""
        return float(self.size) - max(float(self.remaining), 0.0)


class FluidNetwork:
    """Event-driven fluid network. See module docstring."""

    def __init__(self) -> None:
        self.now = 0.0
        self.nodes: list[Node] = []
        self.links: dict[str, Link] = {}
        self.flows: dict[int, Flow] = {}
        self._timers: list[tuple[float, int, Callable[[float], None]]] = []
        self._seq = 0
        self._fid = 0
        self._rates_dirty = True
        # telemetry
        self.bytes_sent: dict[str, float] = {}
        self.bytes_received: dict[str, float] = {}
        self.events_processed = 0
        # open partition: node name -> side id. Nodes on different sides
        # are unreachable; nodes absent from the map sit on the default
        # side. None == fully connected.
        self._partition: Optional[dict[str, int]] = None
        self._partition_default = 0

    # ------------------------------------------------------------- topology
    def add_node(self, name: str, up_bps: float, down_bps: float) -> Node:
        node = Node(name=name, up_bps=float(up_bps), down_bps=float(down_bps))
        node.index = len(self.nodes)
        self.nodes.append(node)
        self.bytes_sent.setdefault(name, 0.0)
        self.bytes_received.setdefault(name, 0.0)
        return node

    def add_link(self, name: str, capacity_bps: float) -> Link:
        if name in self.links:
            raise ValueError(f"duplicate link {name!r}")
        link = Link(name=name, capacity_bps=float(capacity_bps))
        link.index = len(self.links)
        self.links[name] = link
        return link

    def fail_node(self, node: Node) -> None:
        """Abort all flows touching ``node`` (peer churn / host failure)."""
        node.failed = True
        for flow in [f for f in self.flows.values() if f.src is node or f.dst is node]:
            self.abort_flow(flow)

    # ------------------------------------------------------------- partitions
    def set_partition(self, sides: dict[str, int], default: int = 0) -> None:
        """Partition the network: nodes on different sides become mutually
        unreachable. ``sides`` maps node names to side ids; unlisted nodes
        sit on ``default``. Every in-flight cross-side flow aborts (the
        callers' ``on_abort`` hooks drive their in-partition retries), and
        :meth:`start_flow` refuses cross-side endpoints until
        :meth:`clear_partition`. Only one partition may be open at a time.
        """
        if self._partition is not None:
            raise RuntimeError("a partition is already open")
        self._partition = dict(sides)
        self._partition_default = int(default)
        for flow in [
            f for f in self.flows.values()
            if not self.reachable(f.src, f.dst)
        ]:
            self.abort_flow(flow)

    def clear_partition(self) -> None:
        """Heal the partition (idempotent): all nodes reconnect."""
        self._partition = None

    @property
    def partitioned(self) -> bool:
        return self._partition is not None

    def side_of(self, node: Node) -> int:
        """The open partition's side id for ``node`` (default side when no
        partition is open or the node is unlisted)."""
        if self._partition is None:
            return self._partition_default
        return self._partition.get(node.name, self._partition_default)

    def reachable(self, src: Node, dst: Node) -> bool:
        """Can a flow run between these endpoints right now (partition
        check only — liveness is the caller's ``failed`` check)."""
        if self._partition is None:
            return True
        return self.side_of(src) == self.side_of(dst)

    def reachable_names(self, a: str, b: str) -> bool:
        """Name-keyed :meth:`reachable` (partition sides are name-keyed, so
        no Node lookup is needed)."""
        if self._partition is None:
            return True
        d = self._partition_default
        return self._partition.get(a, d) == self._partition.get(b, d)

    # ------------------------------------------------------------- flows/timers
    def start_flow(
        self,
        src: Node,
        dst: Node,
        size: float,
        tag: object = None,
        on_complete: Optional[Callable[[Flow, float], None]] = None,
        on_abort: Optional[Callable[[Flow, float], None]] = None,
        links: tuple[Link, ...] = (),
    ) -> Flow:
        if src.failed or dst.failed:
            raise RuntimeError("flow endpoints must be live")
        if not self.reachable(src, dst):
            raise RuntimeError("flow endpoints are partitioned")
        if size <= 0:
            raise ValueError("flow size must be positive")
        self._fid += 1
        flow = Flow(
            fid=self._fid,
            src=src,
            dst=dst,
            size=float(size),
            links=tuple(links),
            tag=tag,
            on_complete=on_complete,
            on_abort=on_abort,
            start_time=self.now,
        )
        self.flows[flow.fid] = flow
        self._rates_dirty = True
        return flow

    def abort_flow(self, flow: Flow) -> None:
        if flow.fid in self.flows:
            del self.flows[flow.fid]
            flow.aborted = True
            flow.end_time = self.now
            self._rates_dirty = True
            if flow.on_abort is not None:
                flow.on_abort(flow, self.now)

    def schedule(self, at: float, callback: Callable[[float], None]) -> None:
        if at < self.now - 1e-9:
            raise ValueError(f"cannot schedule in the past ({at} < {self.now})")
        self._seq += 1
        heapq.heappush(self._timers, (float(at), self._seq, callback))

    def call_later(self, delay: float, callback: Callable[[float], None]) -> None:
        self.schedule(self.now + delay, callback)

    # ------------------------------------------------------------- rate assignment
    def _recompute_rates(self) -> None:
        """Max-min fair allocation by progressive filling (vectorized).

        All unfrozen flows grow at the same rate until some constraint (a
        node's uplink or downlink, or a shared link) saturates; flows
        through a saturated constraint freeze at their current rate; repeat.
        """
        flows = list(self.flows.values())
        nf = len(flows)
        if nf == 0:
            self._rates_dirty = False
            return
        nn = len(self.nodes)
        src = np.fromiter((f.src.index for f in flows), dtype=np.int64, count=nf)
        dst = np.fromiter((f.dst.index for f in flows), dtype=np.int64, count=nf)
        up_cap = np.fromiter((n.up_bps for n in self.nodes), dtype=np.float64, count=nn)
        down_cap = np.fromiter((n.down_bps for n in self.nodes), dtype=np.float64, count=nn)
        nl = len(self.links) if any(f.links for f in flows) else 0
        if nl:
            # fancy-indexed build from the per-flow cached index arrays
            lens = np.fromiter(
                (f.link_idx.size for f in flows), dtype=np.int64, count=nf
            )
            incidence = np.zeros((nl, nf), dtype=bool)
            incidence[
                np.concatenate([f.link_idx for f in flows]),
                np.repeat(np.arange(nf), lens),
            ] = True
            link_cap = np.fromiter(
                (l.capacity_bps for l in self.links.values()),
                dtype=np.float64, count=nl,
            )
            link_alloc = np.zeros(nl)
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
                n_link = incidence[:, active].sum(axis=1).astype(np.float64)
                with np.errstate(divide="ignore", invalid="ignore"):
                    dl = np.where(
                        n_link > 0, (link_cap - link_alloc) / n_link, INF
                    )
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
                    newly = newly | (active & incidence[sat_link].any(axis=0))
            if not newly.any():
                break
            frozen |= newly

        for f, r in zip(flows, rate):
            f.rate = float(r)
        self._rates_dirty = False

    # ------------------------------------------------------------- event loop
    def _advance(self, dt: float) -> None:
        if dt <= 0:
            return
        for f in self.flows.values():
            moved = f.rate * dt
            f.remaining -= moved
            self.bytes_sent[f.src.name] += moved
            self.bytes_received[f.dst.name] += moved
            for link in f.links:
                link.bytes_through += moved
        self.now += dt

    def _next_completion(self) -> float:
        t = INF
        for f in self.flows.values():
            if f.rate > 0:
                t = min(t, f.remaining / f.rate)
        return t

    def run(self, until: float = INF, max_events: int = 50_000_000) -> float:
        """Run until no work remains or ``until`` is reached. Returns now."""
        for _ in range(max_events):
            if self._rates_dirty:
                self._recompute_rates()
            t_done = self._next_completion()
            t_timer = self._timers[0][0] - self.now if self._timers else INF
            dt = min(t_done, t_timer)
            if not math.isfinite(dt):
                if self.flows and not self._timers:
                    raise RuntimeError(
                        "deadlock: active flows but zero aggregate rate"
                    )
                return self.now  # idle
            if self.now + dt > until:
                self._advance(until - self.now)
                return self.now
            self._advance(dt)
            self.events_processed += 1
            # fire completions (tolerance for float accumulation)
            finished = [f for f in self.flows.values() if f.remaining <= 1e-6 * max(f.size, 1.0)]
            for f in finished:
                f.remaining = 0.0
                f.end_time = self.now
                del self.flows[f.fid]
                self._rates_dirty = True
            for f in finished:
                if f.on_complete is not None:
                    f.on_complete(f, self.now)
            # fire due timers
            while self._timers and self._timers[0][0] <= self.now + 1e-9:
                _, _, cb = heapq.heappop(self._timers)
                cb(self.now)
        raise RuntimeError("max_events exceeded — runaway simulation")

    # ------------------------------------------------------------- telemetry
    def total_bytes_moved(self) -> float:
        return sum(self.bytes_sent.values())

    def link_rate(self, link: Link) -> float:
        """Instantaneous aggregate rate (bytes/sec) through ``link``."""
        if self._rates_dirty:
            self._recompute_rates()
        return sum(f.rate for f in self.flows.values() if link in f.links)
