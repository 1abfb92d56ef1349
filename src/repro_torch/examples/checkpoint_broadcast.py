"""Checkpoint distribution three ways: origin-only vs swarm vs
collective-assisted (one all-gather) — the paper's Table-1 economics
applied to model weights. The port of ``examples/checkpoint_broadcast.py``,
stage for stage:

1. a swarm broadcast of a 4 MB bundle to 8 hosts through ``LocalSwarm``
   (verified bytes);
2. stripe -> all-gather over a process group -> ``device_checksum`` of the
   replicated bundle -> ``verify_replicas`` across the group's ranks;
3. the ``coldstart_time`` projection for a 512-host fleet and a 1 TB
   checkpoint.

Run on the CUDA card (stage 2 on a one-rank NCCL group, the checksum as
the CUDA kernel)::

    PYTHONPATH=src python -m repro_torch.examples.checkpoint_broadcast [--bytes N]

or on the host (a one-rank gloo group, the checksum's plain version)::

    PYTHONPATH=src python -m repro_torch.examples.checkpoint_broadcast --device cpu

Launched as several ranks (``torchrun``), stage 2 uses the default process
group that the launcher set up.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core import (
    ClusterTopology, ColdstartEstimate, LocalSwarm, MetaInfo,
    allgather_bundle, coldstart_time, local_stripe, single_rank_group,
)
from ..compat import host_tensor
from ..kernels.checksum import device_checksum, verify_replicas

DEMO_BYTES = 4 << 20
DEMO_HOSTS = 8
PIECE = 1 << 16


def make_bundle(nbytes: int, seed: int = 0) -> np.ndarray:
    """``nbytes`` random bytes from ``seed``, as a uint8 array (the
    generator's raw 64-bit words: about a second a GiB on one core)."""
    words = np.random.default_rng(seed).bit_generator.random_raw(
        -(-nbytes // 8))
    return words.view(np.uint8)[:nbytes]


def swarm_stage(payload):
    """Stage 1: the bundle's pieces through a byte-accurate swarm of
    ``DEMO_HOSTS`` downloaders. Returns (metainfo, swarm, rounds)."""
    data = bytes(payload)
    mi = MetaInfo.from_bytes(data, PIECE, name="ckpt_demo_0")
    swarm = LocalSwarm(mi, dict(mi.split_pieces(data)),
                       [f"host{i}" for i in range(DEMO_HOSTS)], seed=0)
    return mi, swarm, swarm.run()


@dataclasses.dataclass
class Replication:
    """What stage 2 leaves on this rank's device."""

    stripe: torch.Tensor       # this rank's (1, stripe_len) stripe
    replicated: torch.Tensor   # (world, stripe_len): the whole bundle
    length: int                # the payload's length in bytes
    checksum: torch.Tensor     # (2,) of this rank's replica
    checksums: torch.Tensor    # (world, 2): every rank's replica checksum
    agree: bool                # verify_replicas over those


def collective_stage(payload, group=None, device=None) -> Replication:
    """Stage 2: stripe the payload over ``group`` (``None`` = the default
    process group), replicate it with one all-gather, checksum the replica
    on the device, and check that every rank's checksum agrees."""
    stripe = local_stripe(payload, group, device)
    replicated = allgather_bundle(stripe, group)
    checksum = device_checksum(replicated)
    checksums = allgather_bundle(checksum.view(1, 2), group)
    return Replication(
        stripe, replicated, memoryview(payload).nbytes, checksum, checksums,
        verify_replicas(list(checksums)),
    )


def replica_matches(replicated: torch.Tensor, payload) -> bool:
    """Whether the replica's first ``len(payload)`` bytes are the payload
    and the rest is zero padding, compared on the replica's device 256 MiB
    of the payload at a time."""
    flat = replicated.reshape(-1)
    data = host_tensor(memoryview(payload))
    chunk = 1 << 28
    for lo in range(0, data.numel(), chunk):
        part = data[lo:lo + chunk].to(flat.device)
        if not torch.equal(flat[lo:lo + part.numel()], part):
            return False
    return not bool(flat[data.numel():].any())


def projection() -> list[ColdstartEstimate]:
    """Stage 3: projected cold-start wall times of the three strategies
    for a 1 TB checkpoint on a 512-host fleet (two pods of 256)."""
    topo = ClusterTopology(num_pods=2, hosts_per_pod=256)
    return [coldstart_time(topo, 1e12, strat)
            for strat in ("origin_only", "swarm", "collective")]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bytes", type=int, default=DEMO_BYTES,
                    help="size of the bundle that stage 2 replicates")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    payload = make_bundle(DEMO_BYTES)
    print(f"bundle: {DEMO_BYTES / 1e6:.1f} MB, "
          f"{-(-DEMO_BYTES // PIECE)} pieces")

    print(f"\n--- functional swarm broadcast to {DEMO_HOSTS} hosts "
          "(verified bytes) ---")
    t0 = time.perf_counter()
    _, swarm, rounds = swarm_stage(payload)
    print(f"rounds={rounds} "
          f"origin_served={swarm.origin.ledger.uploaded / 1e6:.1f}MB "
          f"ud={swarm.ud_ratio:.1f} wall={time.perf_counter() - t0:.2f}s")

    print("\n--- collective-assisted: stripe + all-gather over a process "
          "group ---")
    owned = not dist.is_initialized()
    group = single_rank_group(args.device) if owned else None
    try:
        bundle = payload if args.bytes == DEMO_BYTES else make_bundle(
            args.bytes)
        t0 = time.perf_counter()
        rep = collective_stage(bundle, group, args.device)
        if rep.replicated.is_cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not replica_matches(rep.replicated, bundle):
            raise SystemExit("the replicated bundle differs from the payload")
        print(f"replicated {rep.length} bytes over "
              f"{dist.get_world_size(group)} rank(s) on "
              f"{rep.replicated.device}; device checksum="
              f"{rep.checksum.tolist()} replicas_agree={rep.agree} "
              f"wall={wall:.2f}s")
    finally:
        if owned:
            dist.destroy_process_group()

    print("\n--- projected wall times, 512-host fleet, 1 TB checkpoint ---")
    for est in projection():
        print(f"{est.strategy:12s} t={est.seconds:8.1f}s  origin_egress="
              f"{est.origin_bytes / 1e12:7.2f} TB")


if __name__ == "__main__":
    main()
