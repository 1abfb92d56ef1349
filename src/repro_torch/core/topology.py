"""Cluster topology: the two-tier TPU fabric the swarm runs over.

The paper's swarm runs over an undifferentiated WAN. A TPU fleet is not
undifferentiated: hosts within a pod see each other across fast DCN leaf
switches (and their chips share ICI), while cross-pod traffic transits the
spine and the origin (blob store) has a fixed egress budget. Locality-aware
peer ranking is our TPU adaptation of the paper's "download speed is limited
only by the pipe" observation: prefer pipes that are actually wide.

Hardware constants used throughout benchmarks (order-of-magnitude realistic,
stated in EXPERIMENTS.md): host DCN NIC 25 GB/s full duplex within a pod's
leaf domain, 6.25 GB/s effective cross-pod, origin egress 12.5 GB/s,
ICI 4 links x ~50 GB/s per chip for the collective-assist path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class HostAddr:
    pod: int
    host: int

    @property
    def name(self) -> str:
        return f"pod{self.pod}/host{self.host}"


@dataclasses.dataclass
class ClusterTopology:
    """Static description of pods × hosts plus fabric capacities (bytes/s)."""

    num_pods: int
    hosts_per_pod: int
    host_up_bps: float = 25e9
    host_down_bps: float = 25e9
    cross_pod_penalty: float = 4.0     # cross-pod flows see up/penalty effective share
    origin_up_bps: float = 12.5e9
    ici_bps_per_host: float = 4 * 50e9  # aggregate ICI bandwidth per host (collective assist)
    # Aggregate cross-pod spine capacity (bytes/s). When set, the swarm
    # drivers route every cross-pod flow — peer traffic, direct mirror
    # range requests, and pod-cache fills — over one shared netsim Link,
    # so the cache tier's fill traffic contends realistically. None keeps
    # the pre-spine behaviour (cross-pod flows limited only by endpoint
    # NICs); float("inf") tracks cross-pod bytes without constraining them.
    spine_bps: Optional[float] = None

    def hosts(self) -> list[HostAddr]:
        return [
            HostAddr(p, h)
            for p in range(self.num_pods)
            for h in range(self.hosts_per_pod)
        ]

    @property
    def num_hosts(self) -> int:
        return self.num_pods * self.hosts_per_pod

    def addr_of(self, name: str) -> HostAddr | None:
        """Parse a ``podX/hostY`` name into a :class:`HostAddr`.

        Names that do not start with ``pod`` (``origin``, mirrors,
        ``cache/...``) are simply *not hosts* and return None. A name that
        starts with ``pod`` but does not parse (``"pod3"``, ``"pod3/host"``,
        ``"pod3/cache"``) is a caller typo and raises, instead of silently
        degrading to "cross-pod" locality.
        """
        if not name.startswith("pod"):
            return None
        try:
            pod_s, host_s = name.split("/")
            if not host_s.startswith("host"):
                raise ValueError(host_s)
            return HostAddr(int(pod_s[3:]), int(host_s[4:]))
        except ValueError:
            raise ValueError(
                f"malformed host name {name!r}: expected 'pod<int>/host<int>'"
            ) from None

    def same_pod(self, a: str, b: str) -> bool:
        aa, bb = self.addr_of(a), self.addr_of(b)
        return aa is not None and bb is not None and aa.pod == bb.pod

    def rank_peers(self, me: str, candidates: Sequence[str],
                   rng=None, same_pod_frac: float = 1.0) -> list[str]:
        """Locality-aware ordering: same-pod hosts first, origin last resort.

        With ``rng`` and ``same_pod_frac < 1``, produce a *locality-weighted
        shuffle* instead of a strict sort: ~same_pod_frac of each prefix is
        same-pod, the rest cross-pod (§Perf HC3 — strict ranking makes every
        newcomer connect to the same same-pod subset, creating hot spots and
        starving cross-pod piece diversity; mixing restores it while keeping
        most traffic on cheap links).
        """
        def tier(pid: str) -> int:
            if pid.startswith("origin"):
                return 2
            return 0 if self.same_pod(me, pid) else 1

        if rng is None or same_pod_frac >= 1.0:
            return sorted(candidates, key=lambda pid: (tier(pid), pid))
        local = [p for p in candidates if tier(p) == 0]
        remote = [p for p in candidates if tier(p) == 1]
        other = [p for p in candidates if tier(p) == 2]
        rng.shuffle(local)
        rng.shuffle(remote)
        out: list[str] = []
        li = ri = 0
        while li < len(local) or ri < len(remote):
            take_local = (li < len(local)) and (
                ri >= len(remote) or rng.random() < same_pod_frac
            )
            if take_local:
                out.append(local[li]); li += 1
            else:
                out.append(remote[ri]); ri += 1
        return out + other
