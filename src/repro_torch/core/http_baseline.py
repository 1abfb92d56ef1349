"""Client-server (HTTP) baseline — the system the paper compares against.

Two fidelities:

* :func:`simulate_http` — the same fluid netsim, one origin, N clients, no
  peer exchange. Origin egress fair-shares across concurrent downloads;
  origin bytes grow linearly with N (Fig. 1 left panel).
* :func:`analytic_http` — closed-form projection used by Table 1 (origin
  bytes = N x size; per-client time = size / min(client_down, origin_up/N)).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from .metainfo import MetaInfo
from .netsim import FluidNetwork, Flow


@dataclasses.dataclass
class HttpResult:
    sim_time: float
    origin_uploaded: float
    total_downloaded: float
    completion_time: dict[str, float]

    def mean_completion_time(self) -> float:
        return float(np.mean(list(self.completion_time.values())))

    def mean_download_speed(self, size_bytes: float) -> float:
        t = self.mean_completion_time()
        return size_bytes / t if t > 0 else float("inf")


def simulate_http(
    metainfo: MetaInfo,
    arrivals: Iterable[tuple[str, float]],
    origin_up_bps: float,
    client_down_bps: float,
    client_up_bps: float = 1.0,
) -> HttpResult:
    net = FluidNetwork()
    origin = net.add_node("origin", origin_up_bps, 1.0)
    done: dict[str, float] = {}
    arrive: dict[str, float] = {}

    def on_complete(flow: Flow, now: float) -> None:
        done[flow.tag] = now - arrive[flow.tag]

    def make_arrival(pid: str):
        def _arrive(now: float) -> None:
            arrive[pid] = now
            node = net.add_node(pid, client_up_bps, client_down_bps)
            net.start_flow(origin, node, metainfo.length, tag=pid,
                           on_complete=on_complete)
        return _arrive

    for pid, t in arrivals:
        net.schedule(t, make_arrival(pid))
    net.run()
    n = len(done)
    return HttpResult(
        sim_time=net.now,
        origin_uploaded=float(n) * metainfo.length,
        total_downloaded=float(n) * metainfo.length,
        completion_time=done,
    )


def analytic_http(
    size_bytes: float,
    n_downloads: int,
    origin_up_bps: float,
    client_down_bps: float,
    concurrency: int = 1,
) -> tuple[float, float]:
    """(origin_bytes, per-client seconds) under client-server serving.

    ``concurrency`` is the expected number of simultaneous downloads; the
    per-client rate is min(client_down, origin_up / concurrency) — with
    concurrency=1 this is the paper's serial-download projection (their
    500 KB/s university-mirror observation folds origin+path limits into
    ``client_down_bps``).
    """
    rate = min(client_down_bps, origin_up_bps / max(concurrency, 1))
    return float(n_downloads) * size_bytes, size_bytes / rate
