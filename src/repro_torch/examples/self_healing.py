"""Walkthrough: a swarm that notices decay and heals itself.

Act 1 — the silent failure mode: a flash crowd finishes, sessions end,
and a whole pod (cache included) loses power. Nothing is "down" — the
tracker still answers, the mirrors still serve — but the replica count
of the coldest pieces just fell off a cliff. We run the fault twice,
with and without the repair controller, and watch the fleet-wide minimum
replication through the metrics sampler.

Act 2 — the repair ledger: where did the healing bytes come from? The
controller prices every re-seed through the existing tier ladder
(mirrors -> pod caches -> peers) and ledgers bytes by serving tier, so
durability has a bill you can read.

Act 3 — churn storm: a burst of correlated departures (declared as a
single ``churn_storm`` EventSpec) against a population that does not
linger after finishing. The controller keeps re-seeding as the floor
moves under it.

Everything is a ScenarioSpec — the same JSON-able values committed under
``benchmarks/scenarios/durability.json`` and pinned by
``BENCH_durability.json``.

Run:  PYTHONPATH=src python -m repro_torch.examples.self_healing
"""

import argparse
import dataclasses
from pathlib import Path

import numpy as np

from ..core import EventSpec, ScenarioSpec, TelemetrySpec

SCENARIO = (Path(__file__).resolve().parents[3] / "benchmarks"
            / "scenarios" / "durability.json")

TELEMETRY = TelemetrySpec(enabled=True, trace=False, metrics=True,
                          sample_interval=1.0)


def replication_floor(result):
    s = result.metrics.series()
    return s["t"], s["min_replication"]


def act1_pod_loss(spec):
    target = spec.repair.target_replication
    print(f"Act 1 — pod 2 (cache + 6 clients) dies at t=10s mid-crowd; "
          f"target replication {target}")
    print(f"{'t':>4s} {'with repair':>12s} {'without':>8s}")
    runs = {}
    for label, point in (
        ("repair", dataclasses.replace(spec, telemetry=TELEMETRY)),
        ("organic", dataclasses.replace(spec, repair=None,
                                        telemetry=TELEMETRY)),
    ):
        compiled = point.build("time")
        runs[label] = (compiled, compiled.run())
    t_r, m_r = replication_floor(runs["repair"][1])
    t_o, m_o = replication_floor(runs["organic"][1])
    for t in range(8, 18):
        r = m_r[np.searchsorted(t_r, t)] if t <= t_r[-1] else m_r[-1]
        o = m_o[np.searchsorted(t_o, t)] if t <= t_o[-1] else m_o[-1]
        marker = "  <- fault" if t == 10 else ""
        print(f"{t:>3d}s {r:>12.0f} {o:>8.0f}{marker}")
    return runs["repair"][0]


def act2_ledger(compiled):
    sim = compiled.sim
    ctrl = compiled.repairs[sim.metainfo.name]
    summ = ctrl.summary()
    print(f"\nAct 2 — the repair bill, by serving tier "
          f"({summ['repairs_done']} re-seeds, episode closed in "
          f"{summ['time_to_repair']:.0f}s):")
    for tier, nbytes in summ["repair_bytes"].items():
        bar = "#" * int(nbytes / 5e5)
        print(f"  {tier:>10s} {nbytes / 1e6:>6.2f} MB {bar}")
    mi = sim.metainfo
    corrupt = sum(
        1
        for pid, a in sim.agents.items()
        if pid not in sim.origin_set.origins and a.store is not None
        for i, d in a.store.items()
        if not mi.verify_piece(i, d)
    )
    print(f"  corrupt replicas at rest: {corrupt} "
          f"(read-repair evicted {summ['evictions']})")
    assert corrupt == 0


def act3_churn_storm(spec):
    point = dataclasses.replace(
        spec,
        telemetry=TELEMETRY,
        arrivals=(dataclasses.replace(spec.arrivals[0], seed_linger=0.0),),
        events=(EventSpec(kind="churn_storm", at=8.0, count=6, spread=2.0,
                          seed=23),),
    )
    compiled = point.build("time")
    compiled.run()
    ctrl = compiled.repairs[compiled.sim.metainfo.name]
    summ = ctrl.summary()
    print(f"\nAct 3 — churn storm: 6 sessions end in a ~2s burst at t=8s, "
          f"finished peers leave immediately:\n  "
          f"floor dipped to {summ['min_replication_low']:.0f} replicas; "
          f"{summ['repairs_done']} re-seeds scheduled against the shrinking "
          f"swarm ({summ['repairs_failed']} lost to further churn)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", type=Path, default=SCENARIO,
                    help="durability ScenarioSpec JSON to replay")
    args = ap.parse_args(argv)
    spec = ScenarioSpec.load(args.scenario)
    compiled = act1_pod_loss(spec)
    act2_ledger(compiled)
    act3_churn_storm(spec)


if __name__ == "__main__":
    main()
