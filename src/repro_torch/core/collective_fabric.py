"""Collective-assisted distribution (beyond-paper, DESIGN.md §2).

The paper's insight — "downloaders re-serve, so the origin uploads ~one
copy" — has a degenerate, *faster* form inside a pod: fetch a distinct
1/N stripe of the bundle to each host (origin uploads exactly one copy,
like a fully-efficient swarm), then replicate pod-wide with one all-gather
over the interconnect. The interconnect performs the swarm's amplification
in a single collective instead of O(N log N) piece exchanges.

Two layers here:

* a **time model** (`coldstart_time`) comparing origin-only / swarm /
  stripe+all-gather for a cluster cold start (a copy of the reference's);
* a **functional path** (`stripe_shards` / `allgather_bundle` /
  `broadcast_bundle`) used by checkpoint broadcast, on ``torch.distributed``
  where the reference has a JAX mesh: each rank of a process group holds
  one uint8 stripe of the bundle on its device, and one all-gather over
  the group replicates it (NCCL for CUDA tensors, over NVLink between the
  cards of a host; gloo for CPU tensors). The stripe count is the group's
  world size.

A group is never guessed: ``group=None`` is the default group, which must
be initialised, and its backend must be the one for the device (``nccl``
for CUDA, ``gloo`` for the CPU), or the call raises.
:func:`single_rank_group` makes the one-rank group of a one-card run, the
counterpart of the reference's ``make_test_mesh((1, 1))``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..compat import host_tensor, resolve_device
from .topology import ClusterTopology

#: The process-group backend for each device type.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

# all_gather_single is the newer name of all_gather_into_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class ColdstartEstimate:
    strategy: str
    origin_bytes: float
    seconds: float


def coldstart_time(
    topo: ClusterTopology,
    size_bytes: float,
    strategy: str,
    swarm_efficiency: float = 0.85,
) -> ColdstartEstimate:
    """Analytic cold-start time for distributing ``size_bytes`` to every host.

    origin_only:    every host pulls the full bundle from the origin;
                    origin egress is the bottleneck.
    swarm:          origin uploads ~1 copy; the swarm pipelines pieces, so
                    steady-state per-host rate approaches
                    ``swarm_efficiency x`` min(host NIC, aggregate fair
                    share); time ~ max(1-copy origin time, piece-pipelined
                    replication time).
    collective:     stripe 1/N per host over DCN, then ICI all-gather
                    within each pod + one cross-pod swarm/relay of stripes.
    """
    n = topo.num_hosts
    if strategy == "origin_only":
        t = size_bytes * n / topo.origin_up_bps
        t = max(t, size_bytes / topo.host_down_bps)
        return ColdstartEstimate(strategy, size_bytes * n, t)
    if strategy == "swarm":
        t_origin = size_bytes / topo.origin_up_bps  # one copy out of the origin
        per_host = min(topo.host_down_bps, topo.host_up_bps) * swarm_efficiency
        t_replicate = size_bytes / per_host
        return ColdstartEstimate(strategy, size_bytes, max(t_origin, t_replicate))
    if strategy == "collective":
        stripe = size_bytes / n
        t_stripe = max(
            size_bytes / topo.origin_up_bps,  # origin still ships one copy total
            stripe / topo.host_down_bps,
        )
        # ring all-gather within a pod: each host receives (H-1)/H of the pod
        # bundle over ICI; pods exchange their missing stripes over DCN.
        h = topo.hosts_per_pod
        t_ici = size_bytes * (h - 1) / h / topo.ici_bps_per_host
        t_xpod = 0.0
        if topo.num_pods > 1:
            cross = size_bytes * (topo.num_pods - 1) / topo.num_pods / topo.num_pods
            t_xpod = cross / (topo.host_up_bps / topo.cross_pod_penalty)
        return ColdstartEstimate(strategy, size_bytes, t_stripe + t_ici + t_xpod)
    raise ValueError(f"unknown strategy {strategy!r}")


# --------------------------------------------------------------------------- functional path


def stripe_shards(payload: bytes, n: int) -> list[np.ndarray]:
    """Split a bundle into n equal uint8 stripes (zero-padded tail)."""
    pad = (-len(payload)) % n
    buf = np.frombuffer(payload + b"\x00" * pad, dtype=np.uint8)
    return list(buf.reshape(n, -1))


def _checked_device(group, device) -> torch.device:
    """The device a bundle on ``group`` lives on, after checking that the
    group exists and that its backend serves that device."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: call "
            "torch.distributed.init_process_group (or single_rank_group for "
            "a one-card run) first"
        )
    kind = torch.device("cuda" if device is None else device).type
    if kind not in BACKENDS:
        raise ValueError(f"unsupported device {device} (cuda or cpu)")
    backend = dist.get_backend(group)
    if backend != BACKENDS[kind]:
        raise ValueError(
            f"the process group's backend is {backend!r}; a bundle on "
            f"{kind} needs {BACKENDS[kind]!r}"
        )
    return resolve_device(device)


def single_rank_group(device=None):
    """Initialise the default process group as one rank (rank 0 of 1) with
    the backend for ``device`` (``None`` = the CUDA card), or return it
    if it already is exactly that; the counterpart of
    ``make_test_mesh((1, 1))`` for a one-card run. Its store lives in this
    process, so it opens no port."""
    dev = resolve_device(device)
    backend = BACKENDS[dev.type]
    if dist.is_initialized():
        if dist.get_world_size() != 1 or dist.get_backend() != backend:
            raise RuntimeError(
                f"a default process group of {dist.get_world_size()} "
                f"rank(s) on {dist.get_backend()!r} already exists"
            )
        return dist.group.WORLD
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return dist.group.WORLD


def local_stripe(payload, group=None, device=None) -> torch.Tensor:
    """This rank's ``(1, stripe_len)`` uint8 stripe of ``payload`` on
    ``device``: row ``rank`` of ``np.stack(stripe_shards(payload, world))``,
    copied straight from the payload's buffer (no host copy is made)."""
    dev = _checked_device(group, device)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    data = host_tensor(memoryview(payload))
    length = data.numel()
    width = -(-length // world)
    lo, hi = min(rank * width, length), min((rank + 1) * width, length)
    stripe = torch.empty((1, width), dtype=torch.uint8, device=dev)
    stripe[0, : hi - lo].copy_(data[lo:hi])
    stripe[0, hi - lo:].zero_()
    return stripe


def allgather_bundle(striped: torch.Tensor, group=None) -> torch.Tensor:
    """Replicate a host-striped uint8 bundle via one all-gather over
    ``group``.

    ``striped`` is this rank's ``(1, stripe_len)`` stripe; the result is the
    whole bundle, ``(world, stripe_len)``, on the stripe's device: every
    rank (host) holds all of it.
    """
    _checked_device(group, striped.device)
    if striped.dim() != 2 or striped.shape[0] != 1:
        raise ValueError(
            f"striped must be this rank's (1, stripe_len) stripe "
            f"(got {tuple(striped.shape)})"
        )
    world = dist.get_world_size(group)
    out = torch.empty((world, striped.shape[1]), dtype=striped.dtype,
                      device=striped.device)
    _all_gather(out, striped.contiguous(), group=group)
    return out


def broadcast_bundle(
    payload, group=None, device=None
) -> tuple[torch.Tensor, int]:
    """End-to-end: stripe -> place this rank's stripe on ``device`` ->
    all-gather. Returns (replicated uint8 tensor of shape
    ``(world, stripe_len)``, original length)."""
    stripe = local_stripe(payload, group, device)
    return allgather_bundle(stripe, group), memoryview(payload).nbytes


def bundle_to_bytes(replicated: torch.Tensor, length: int) -> bytes:
    return replicated.reshape(-1)[:length].cpu().numpy().tobytes()
