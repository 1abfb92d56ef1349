"""Walkthrough: tail latency, and hedging it away.

A download is only as fast as its slowest piece. When one mirror is slow
(mis-provisioned, far away, overloaded) and the client's selection policy
prefers it, the whole crowd's p99 completion time crawls at that mirror's
pace. Client-side **mirror hedging** — the HTTP analogue of endgame mode —
duplicates tail range requests to the next ranked mirror, cancels the
loser, and ledgers the cancelled bytes as an explicit insurance premium.

The slow-mirror deployment is declared once as a ScenarioSpec; the unhedged
and hedged runs are the same scenario with one policy knob flipped.

Run:  PYTHONPATH=src python -m repro_torch.examples.tail_hedging --peers 12
"""

import argparse
import dataclasses

from ..core import (
    ArrivalSpec, ContentSpec, FabricSpec, ManifestSpec, MirrorSpec,
    OriginPolicy, ScenarioSpec,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--peers", type=int, default=12)
    ap.add_argument("--size-gb", type=float, default=0.25)
    ap.add_argument("--tail", type=float, default=0.25,
                    help="hedge_tail_fraction (fraction of pieces hedged)")
    args = ap.parse_args(argv)
    size = int(args.size_gb * 1e9)

    # static weights prefer the slow mirror — the realistic "nearest mirror
    # is not the fastest mirror" trap
    scenario = ScenarioSpec(
        name="tail_hedging",
        content=ContentSpec(manifests=(
            ManifestSpec("tail", size_bytes=size, piece_length=size // 32),
        )),
        fabric=FabricSpec(mirrors=(
            MirrorSpec("near", up_bps=3e6, weight=2.0),
            MirrorSpec("far", up_bps=60e6, weight=1.0),
        )),
        arrivals=(ArrivalSpec(kind="flash", n=args.peers, up_bps=25e6,
                              down_bps=50e6),),
        policy=OriginPolicy(swarm_fraction=0.0, origin_up_bps=3e6,
                            selection="static",
                            hedge_tail_fraction=args.tail),
        seed=7,
    )

    print(f"{args.peers} clients, {args.size_gb:.2f} GB, slow preferred "
          f"mirror (3 MB/s) + fast alternate (60 MB/s)")
    print(f"{'mode':>10s} {'p50':>7s} {'p95':>7s} {'p99':>7s} "
          f"{'premium':>10s}")
    results = {}
    for hedge in (False, True):
        point = dataclasses.replace(
            scenario,
            policy=dataclasses.replace(scenario.policy, hedge=hedge),
        )
        res = point.build("time").run().primary
        assert len(res.completion_time) == args.peers
        results[hedge] = res
        pct = res.completion_percentiles()
        label = "hedged" if hedge else "unhedged"
        print(f"{label:>10s} {pct['p50']:>6.0f}s {pct['p95']:>6.0f}s "
              f"{pct['p99']:>6.0f}s "
              f"{res.hedge_cancelled_bytes / 1e6:>8.1f}MB")

    off, on = results[False], results[True]
    p99_off = off.completion_percentiles()["p99"]
    p99_on = on.completion_percentiles()["p99"]
    counts, edges = on.fetch_latency_histogram(bins=8)
    print(f"\nhedging cut p99 by {(1 - p99_on / p99_off) * 100:.0f}% "
          f"({p99_off:.0f}s -> {p99_on:.0f}s) for "
          f"{on.hedge_cancelled_bytes / size:.3f} copies of premium")
    print(f"hedged fetch-latency histogram (s): "
          + " ".join(f"{e:.0f}:{c}" for e, c in zip(edges, counts)))
    assert p99_on < p99_off
    assert on.hedge_cancelled_bytes > 0 and off.hedge_cancelled_bytes == 0


if __name__ == "__main__":
    main()
