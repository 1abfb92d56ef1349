"""The paper's own scenario: N researchers downloading a dataset, HTTP vs
HTTP+P2P, with live U/D accounting (Eq. 1) and Table-1-style projection.

The deployment is one declarative ScenarioSpec: a single origin that also
speaks the peer protocol (``serve_peer_protocol=True`` at swarm fraction 1
is exactly the paper's seeded-origin swarm), staggered researcher
arrivals that linger seeding for an hour after finishing.

Run:  PYTHONPATH=src python -m repro_torch.examples.dataset_swarm --downloads 24
"""

import argparse

from ..core import (
    ArrivalSpec, ContentSpec, FabricSpec, ManifestSpec, MirrorSpec,
    OriginPolicy, ScenarioSpec, accounting, project_row, simulate_http,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--downloads", type=int, default=24)
    ap.add_argument("--size-gb", type=float, default=8.0)
    args = ap.parse_args(argv)

    size = args.size_gb * 1e9
    scenario = ScenarioSpec(
        name="dataset_swarm",
        content=ContentSpec(manifests=(
            ManifestSpec("dataset", size_bytes=int(size),
                         piece_length=int(32e6)),
        )),
        fabric=FabricSpec(mirrors=(MirrorSpec("origin", up_bps=10e6),)),
        arrivals=(ArrivalSpec(kind="staggered", n=args.downloads,
                              interval=120.0, up_bps=25e6, down_bps=50e6,
                              seed_linger=3600.0),),
        policy=OriginPolicy(swarm_fraction=1.0, origin_up_bps=10e6,
                            serve_peer_protocol=True),
        seed=0,
    )
    mi, _ = scenario.content.manifests[0].build()
    arrivals = scenario.arrivals[0].generate()

    http = simulate_http(mi, arrivals, origin_up_bps=10e6,
                         client_down_bps=50e6)
    res = scenario.build("time").run().primary

    cost = accounting.CostModel()
    print(f"dataset: {args.size_gb:.1f} GB, {args.downloads} downloads")
    print(f"{'':16s}{'origin egress':>16s}{'origin bill':>14s}{'mean dl time':>14s}")
    print(f"{'HTTP':16s}{http.origin_uploaded/1e9:>13.1f} GB"
          f"{cost.egress_cost(http.origin_uploaded):>13.2f}$"
          f"{http.mean_completion_time():>13.0f}s")
    print(f"{'HTTP + swarm':16s}{res.origin_uploaded/1e9:>13.1f} GB"
          f"{cost.egress_cost(res.origin_uploaded):>13.2f}$"
          f"{res.mean_completion_time():>13.0f}s")
    print(f"\nmeasured U/D (Eq. 1) = {res.ud_ratio:.1f}")
    row = project_row("this-dataset", size, 100, res.ud_ratio)
    print(f"Table-1-style projection at 100 downloads: save "
          f"${row.cost_savings:.2f} in egress; "
          f"{row.http_hours:.2f}h -> {row.at_hours:.3f}h per download")


if __name__ == "__main__":
    main()
