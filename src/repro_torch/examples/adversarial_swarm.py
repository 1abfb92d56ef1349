"""Walkthrough: a swarm under attack, and the quarantine that contains it.

Act 1 — Byzantine poisoners: 10% of the flash crowd corrupts every piece
it serves over the peer wire (their at-rest replicas stay good — this is
wire-level sabotage, not bit rot). Every verify failure is attributed to
the serving source; past the hash-fail threshold the quarantine bans the
peer, the tracker stops handing it out, and its mesh connections drop.
We watch the strike ledger fill and the bans land.

Act 2 — tracker blackout: the control plane goes dark for 30 s mid-crowd
(``tracker_fail``/``tracker_heal`` events). Clients ride their cached
peer lists and re-announce with capped exponential backoff plus
deterministic per-peer jitter; the data plane never stops. We compare
completion against an outage-free baseline.

Act 3 — partition: a pod is cut from the spine mid-download and healed
14 s later. In-flight cross-partition flows abort and retry inside the
side; on heal the two sides reconcile and everyone finishes.

Everything is a ScenarioSpec — the same JSON-able values committed under
``benchmarks/scenarios/adversarial.json`` and pinned by
``BENCH_adversarial.json``.

Run:  PYTHONPATH=src python -m repro_torch.examples.adversarial_swarm
"""

import argparse
import dataclasses
from pathlib import Path

from ..core import EventSpec, ScenarioSpec, TopologySpec

SCENARIO = (Path(__file__).resolve().parents[3] / "benchmarks"
            / "scenarios" / "adversarial.json")


def act1_poisoners(spec):
    point = dataclasses.replace(spec, events=())
    poisoners = point.resolve_poisoners()
    print(f"Act 1 — {len(poisoners)} of {point.arrivals[0].n} clients are "
          f"poisoners ({', '.join(poisoners)}); "
          f"ban threshold {point.adversary.ban_threshold} strikes")
    compiled = point.build("time")
    result = compiled.run()
    q = compiled.quarantines[compiled.sim.metainfo.name]
    out = next(iter(result.outcomes.values()))
    print(f"  completed {out.completed}/{out.clients} in {out.duration:.0f}s")
    for pid in poisoners:
        strikes = q.fails.get(pid, 0)
        banned = "BANNED" if q.is_banned(pid) else "live"
        print(f"  {pid}: {strikes} strikes -> {banned}")
    print(f"  poisoned waste: {q.wasted_bytes / 1e6:.2f} MB thrown away "
          f"({q.wasted_bytes / out.total_downloaded * 100:.1f}% of goodput)")
    assert set(q.banned) == set(poisoners)
    mi = compiled.sim.metainfo
    corrupt = sum(
        1
        for pid, a in compiled.sim.agents.items()
        if pid not in compiled.sim.origin_set.origins and a.store is not None
        for i, d in a.store.items()
        if not mi.verify_piece(i, d)
    )
    print(f"  corrupt bytes in finished pieces: {corrupt}")
    assert corrupt == 0


def act2_blackout(spec):
    print("\nAct 2 — tracker dark from t=10s to t=40s, honest swarm:")
    honest = dataclasses.replace(spec, adversary=None, events=())
    dark = dataclasses.replace(spec, adversary=None)
    th = next(iter(honest.build("time").run().outcomes.values())).duration
    res = dark.build("time").run()
    out = next(iter(res.outcomes.values()))
    print(f"  healthy baseline: all done in {th:.0f}s")
    print(f"  30s blackout:     {out.completed}/{out.clients} done in "
          f"{out.duration:.0f}s (delta {out.duration - th:+.1f}s — cached "
          f"peer lists kept the data plane flowing)")
    assert out.completed == out.clients


def act3_partition(spec):
    print("\nAct 3 — pod 1 cut from the spine t=8s..22s:")
    point = dataclasses.replace(
        spec,
        adversary=None,
        topology=TopologySpec(num_pods=2, hosts_per_pod=10,
                              host_up_bps=2e6, host_down_bps=4e6,
                              spine_bps=float("inf"), same_pod_frac=0.8),
        arrivals=(dataclasses.replace(spec.arrivals[0],
                                      topology_hosts=True),),
        events=(
            EventSpec(kind="partition", at=8.0, target="pods:1"),
            EventSpec(kind="partition_heal", at=22.0, target="pods:1"),
        ),
    )
    compiled = point.build("time")
    result = compiled.run()
    out = next(iter(result.outcomes.values()))
    print(f"  {out.completed}/{out.clients} completed in {out.duration:.0f}s; "
          f"cross-partition flows aborted and retried in-side, both sides "
          f"reconciled on heal")
    assert out.completed == out.clients
    assert not compiled.sim.net.partitioned


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", type=Path, default=SCENARIO,
                    help="adversarial ScenarioSpec JSON to replay")
    args = ap.parse_args(argv)
    spec = ScenarioSpec.load(args.scenario)
    act1_poisoners(spec)
    act2_blackout(spec)
    act3_partition(spec)


if __name__ == "__main__":
    main()
