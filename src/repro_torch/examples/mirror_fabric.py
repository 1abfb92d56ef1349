"""Walkthrough: from one melting mirror to a hierarchical delivery network.

Act 1 — the ImageNet problem: a dataset served from several university
mirrors with divergent bandwidth. The web-seed fabric spreads range
requests across them (least-loaded selection) while the swarm amplifies
every delivered byte, so the *aggregate* mirror bill stays ~1 copy.

Act 2 — inside the cluster: pods pulling the same dataset hammer the
spine. A pod-local cache proxy fills once per pod from the mirror tier and
serves its pod over leaf links — cross-pod traffic collapses to ~1 copy
per pod, measured on the shared spine link.

Act 3 — faults, declared: the scenario's event timeline corrupts one range
and kills the fastest mirror mid-download; verified re-fetch + mirror
failover deliver every byte intact.

Every act is a ScenarioSpec — the same JSON-able values the benchmarks
commit under ``benchmarks/scenarios/``.

Run:  PYTHONPATH=src python -m repro_torch.examples.mirror_fabric --hosts-per-pod 6
"""

import argparse
import dataclasses

from ..core import (
    ArrivalSpec, ContentSpec, EventSpec, FabricSpec, ManifestSpec,
    MirrorSpec, OriginPolicy, PodCacheSpec, ScenarioSpec, SwarmConfig,
    TopologySpec,
)


def act1_mirrors(args):
    size = int(args.size_gb * 1e9)
    scenario = ScenarioSpec(
        name="imagenet_mirrors",
        content=ContentSpec(manifests=(
            ManifestSpec("imagenet", size_bytes=size,
                         piece_length=size // 64),
        )),
        fabric=FabricSpec(mirrors=(
            MirrorSpec("origin0", up_bps=12e6, weight=3.0),
            MirrorSpec("origin1", up_bps=6e6, weight=2.0),
            MirrorSpec("origin2", up_bps=2e6, weight=1.0),
        )),
        arrivals=(ArrivalSpec(kind="flash", n=args.peers, up_bps=25e6,
                              down_bps=50e6),),
        policy=OriginPolicy(swarm_fraction=1.0, selection="least_loaded"),
        seed=0,
    )
    print(f"Act 1 — {args.peers} clients, {args.size_gb:.2f} GB, "
          f"3 mirrors (12/6/2 MB/s), least-loaded selection")
    print(f"{'swarm fraction':>14s} {'aggregate egress':>17s} "
          f"{'per-mirror copies':>19s} {'mean dl':>8s}")
    for frac in (0.0, 0.5, 1.0):
        point = dataclasses.replace(
            scenario,
            policy=dataclasses.replace(scenario.policy, swarm_fraction=frac),
        )
        out = point.build("time")
        res = out.run().primary
        per = "/".join(
            f"{o.http_uploaded / size:.2f}"
            for o in out.sim.origin_set.origins.values()
        )
        print(f"{frac:>14.2f} {res.origin_uploaded / size:>10.2f} copies "
              f"{per:>19s} {res.mean_completion_time():>7.0f}s")


def act2_caches(args):
    size = int(args.size_gb * 1e9)
    pods = 2
    n = pods * args.hosts_per_pod
    base = ScenarioSpec(
        name="cluster_caches",
        content=ContentSpec(manifests=(
            ManifestSpec("cluster", size_bytes=size, piece_length=size // 64),
        )),
        fabric=FabricSpec(mirrors=(
            MirrorSpec("origin0", up_bps=12e6),
            MirrorSpec("origin1", up_bps=8e6),
        )),
        topology=TopologySpec(num_pods=pods,
                              hosts_per_pod=args.hosts_per_pod,
                              host_up_bps=25e6, host_down_bps=50e6,
                              spine_bps=float("inf")),
        arrivals=(ArrivalSpec(kind="flash", n=n, up_bps=25e6, down_bps=50e6,
                              topology_hosts=True),),
        policy=OriginPolicy(swarm_fraction=1.0, origin_up_bps=20e6),
        swarm=SwarmConfig(max_neighbors=args.hosts_per_pod - 1),
        seed=1,
    )
    print(f"\nAct 2 — {pods} pods x {args.hosts_per_pod} hosts, "
          f"spine-metered cross-pod traffic")
    print(f"{'stage':>10s} {'cross-pod/pod':>14s} {'mirror egress':>14s} "
          f"{'cache serves':>13s}")
    for stage in ("global", "locality", "cache"):
        frac = {"global": 0.5, "locality": 0.95, "cache": 1.0}[stage]
        point = dataclasses.replace(
            base,
            topology=dataclasses.replace(base.topology, same_pod_frac=frac),
            fabric=dataclasses.replace(
                base.fabric,
                pod_caches=(PodCacheSpec(up_bps=100e6)
                            if stage == "cache" else None),
            ),
        )
        res = point.build("time").run().primary
        assert len(res.completion_time) == n
        print(f"{stage:>10s} "
              f"{res.cross_pod_bytes / size / pods:>7.2f} copies "
              f"{res.origin_uploaded / size:>7.2f} copies "
              f"{res.pod_cache_uploaded / size:>6.2f} copies")


def act3_faults(args):
    scenario = ScenarioSpec(
        name="fault_drill",
        content=ContentSpec(manifests=(
            ManifestSpec("faulty", size_bytes=1 << 21, piece_length=1 << 16,
                         payload="random"),
        )),
        fabric=FabricSpec(mirrors=(
            MirrorSpec("origin0", up_bps=2e6, weight=2.0),
            MirrorSpec("origin1", up_bps=2e6, weight=1.0),
        )),
        arrivals=(ArrivalSpec(kind="flash", n=6, up_bps=2e6,
                              down_bps=4e6),),
        policy=OriginPolicy(swarm_fraction=1.0, origin_up_bps=4e6),
        events=(
            EventSpec(kind="corrupt_once", target="origin0", piece=0),
            EventSpec(kind="mirror_fail", at=20.0, target="origin0"),
        ),
        seed=2,
    )
    out = scenario.build("time")
    res = out.run().primary
    sim = out.sim
    mi = sim.metainfo
    verified = all(
        mi.verify_piece(i, d)
        for pid, a in sim.agents.items()
        if pid not in sim.origin_set.origins
        for i, d in a.store.items()
    )
    wasted = sum(l.wasted for l in res.ledgers.values())
    print(f"\nAct 3 — preferred mirror corrupted one range, then died at "
          f"t=20s (both declared EventSpecs):\n  "
          f"{len(res.completion_time)}/6 clients finished; "
          f"{wasted / 1e3:.0f} kB re-fetched; all pieces verified: {verified}")
    assert verified and len(res.completion_time) == 6


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--peers", type=int, default=12)
    ap.add_argument("--hosts-per-pod", type=int, default=6)
    ap.add_argument("--size-gb", type=float, default=0.25)
    args = ap.parse_args(argv)
    act1_mirrors(args)
    act2_caches(args)
    act3_faults(args)


if __name__ == "__main__":
    main()
