"""Walkthrough: turning a plain HTTP mirror into a web-seed hybrid origin.

The paper's pitch in one script: a university mirror serving a dataset over
HTTP melts under a flash crowd; pointing the same clients at the same
server through the web-seed subsystem re-routes piece requests to other
downloaders, so origin egress collapses to ~1 copy while downloads get
faster. The whole deployment is *declared* once as a ScenarioSpec; the
sweep just replaces the swarm-routed fraction. Finishes with a cold start
from a bare origin with real verified bytes (the same scenario compiled to
the byte-domain engine).

Run:  PYTHONPATH=src python -m repro_torch.examples.hybrid_origin --peers 16
"""

import argparse
import dataclasses

from ..core import (
    ArrivalSpec, ContentSpec, FabricSpec, ManifestSpec, MirrorSpec,
    OriginPolicy, ScenarioSpec, simulate_http,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--peers", type=int, default=16)
    ap.add_argument("--size-gb", type=float, default=1.0)
    ap.add_argument("--mode", default="swarm_first",
                    choices=["swarm_first", "http_first"])
    args = ap.parse_args(argv)

    origin_bps = 20e6
    scenario = ScenarioSpec(
        name="hybrid_origin",
        content=ContentSpec(manifests=(
            ManifestSpec("mirror", size_bytes=int(args.size_gb * 1e9),
                         piece_length=int(16e6)),
        )),
        fabric=FabricSpec(mirrors=(MirrorSpec("origin", up_bps=origin_bps),)),
        arrivals=(ArrivalSpec(kind="flash", n=args.peers, up_bps=25e6,
                              down_bps=50e6),),
        policy=OriginPolicy(mode=args.mode, swarm_fraction=1.0,
                            origin_up_bps=origin_bps),
        seed=0,
    )
    mi, _ = scenario.content.manifests[0].build()
    arrivals = scenario.arrivals[0].generate()

    http = simulate_http(mi, arrivals, origin_bps, 50e6)
    print(f"{args.peers} clients, {args.size_gb:.1f} GB dataset, "
          f"{origin_bps / 1e6:.0f} MB/s origin ({args.mode})")
    print(f"{'swarm fraction':>14s} {'origin egress':>14s} "
          f"{'via HTTP':>10s} {'mean dl time':>13s} {'U/D':>6s}")
    print(f"{'pure HTTP':>14s} {http.origin_uploaded / 1e9:>11.1f} GB "
          f"{http.origin_uploaded / 1e9:>7.1f} GB "
          f"{http.mean_completion_time():>12.0f}s {'1.0':>6s}")
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        point = dataclasses.replace(
            scenario,
            policy=dataclasses.replace(scenario.policy, swarm_fraction=frac),
        )
        res = point.build("time").run().primary
        print(f"{frac:>14.2f} {res.origin_uploaded / 1e9:>11.1f} GB "
              f"{res.origin_http_uploaded / 1e9:>7.1f} GB "
              f"{res.mean_completion_time():>12.0f}s "
              f"{res.ud_ratio:>6.1f}")

    # byte-domain cold start: the same declarative API, real verified bytes,
    # bare origin, zero seeded peers
    cold = ScenarioSpec(
        name="cold_start",
        content=ContentSpec(manifests=(
            ManifestSpec("cold", size_bytes=1 << 22, piece_length=1 << 16,
                         payload="random"),
        )),
        fabric=FabricSpec(mirrors=(MirrorSpec("origin", up_bps=50e6),)),
        arrivals=(ArrivalSpec(kind="flash", n=8, up_bps=25e6, down_bps=50e6,
                              prefix="host"),),
        policy=OriginPolicy(swarm_fraction=1.0),
        seed=0,
    )
    result = cold.build("byte").run()
    out = result.outcomes["cold"]
    swarm = out.raw
    assert out.completed == 8
    print(f"\ncold start (byte-domain, 8 hosts, {(1 << 22) >> 20} MiB): "
          f"{result.sim_time:.0f} rounds, origin served "
          f"{swarm.http_uploaded / (1 << 22):.2f} copies over HTTP ranges, "
          f"swarm amplification U/D = {out.ud_ratio:.1f}")


if __name__ == "__main__":
    main()
