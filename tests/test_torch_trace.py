"""Trace parity: the port's ported core records the reference's traces and
its ``TraceChecker`` holds them clean.

Each scenario is built once in the JAX package's ``repro.core`` (the
specs of ``tests/test_telemetry.py:321``, ``tests/test_adversarial.py:321,
391, 414`` and a repair scenario after ``tests/test_repair.py``), carried to
the port through ``ScenarioSpec.to_dict``/``from_dict``, and run in both
packages on the CPU. The port's events must equal the reference's one for
one (the engines are deterministic by seed), the port's
``TraceChecker(...).check()`` must return ``[]``, and on the same events it
must return what the reference's returns, also on traces with faults put
in.
"""

import dataclasses
from pathlib import Path

import pytest

import repro.core as jcore
import repro_torch.core as pcore

SCENARIO_DIR = Path(__file__).resolve().parent.parent / "benchmarks" / "scenarios"
COMMITTED = [
    "webseed_hybrid.json", "mirror_fabric.json", "tail_latency.json",
    "multi_torrent_fairness.json",
]


def _events(recorder) -> list[dict]:
    return [ev.to_dict() for ev in recorder.events]


def _port_spec(spec):
    return pcore.ScenarioSpec.from_dict(spec.to_dict())


def _port_events(events):
    return [pcore.TraceEvent(**dataclasses.asdict(ev)) for ev in events]


def _hold(jrec, prec, **check):
    """The two packages' traces are equal, clean, and checked alike."""
    assert _events(prec) == _events(jrec)
    assert prec.events, "no events recorded"
    got = pcore.TraceChecker(prec).check(**check)
    assert got == []
    assert got == jcore.TraceChecker(jrec).check(**check)


def _run_both(spec, engine="time"):
    jout = spec.build(engine)
    jres = jout.run()
    pout = _port_spec(spec).build(engine)
    pres = pout.run()
    return jout, jres, pout, pres


@pytest.mark.parametrize("fname", COMMITTED)
def test_committed_scenarios_trace_clean_and_equal(fname):
    spec = jcore.ScenarioSpec.load(SCENARIO_DIR / fname)
    tel = spec.telemetry or jcore.TelemetrySpec()
    spec = dataclasses.replace(
        spec, telemetry=dataclasses.replace(tel, enabled=True, metrics=False))
    _, jres, _, pres = _run_both(spec)
    hedged = pres.stats.hedge_cancelled_bytes if pres.stats else 0.0
    assert hedged == (jres.stats.hedge_cancelled_bytes if jres.stats else 0.0)
    _hold(jres.trace, pres.trace, hedge_cancelled_bytes=hedged)


def adv_spec(**over):
    base = dict(
        content=jcore.ContentSpec(manifests=(
            jcore.ManifestSpec("ds", 1 << 21, 1 << 17, payload="random"),
        )),
        fabric=jcore.FabricSpec(mirrors=(jcore.MirrorSpec("origin",
                                                          up_bps=8e6),)),
        arrivals=(jcore.ArrivalSpec(kind="flash", n=6, up_bps=2e6,
                                    down_bps=4e6),),
        policy=jcore.OriginPolicy(swarm_fraction=1.0, origin_up_bps=8e6),
        swarm=jcore.SwarmConfig(max_neighbors=8),
        seed=3,
    )
    base.update(over)
    return jcore.ScenarioSpec(**base)


def test_poisoners_banned_trace_clean_and_equal():
    spec = adv_spec(
        adversary=jcore.AdversarySpec(poisoners=("peer0001",),
                                      ban_threshold=1),
        telemetry=jcore.TelemetrySpec(enabled=True),
    )
    jout, _, pout, pres = _run_both(spec)
    assert next(iter(pres.outcomes.values())).completed == 6
    assert pout.quarantines["ds"].is_banned("peer0001")
    _hold(jout.recorder, pout.recorder)


def test_tracker_outage_trace_clean_and_equal():
    spec = adv_spec(
        arrivals=(jcore.ArrivalSpec(kind="staggered", n=6, up_bps=2e6,
                                    down_bps=4e6, interval=1.0),),
        events=(jcore.EventSpec(kind="tracker_fail", at=2.0),
                jcore.EventSpec(kind="tracker_heal", at=12.0)),
        telemetry=jcore.TelemetrySpec(enabled=True),
    )
    jout, _, pout, pres = _run_both(spec)
    assert next(iter(pres.outcomes.values())).completed == 6
    kinds = [e.kind for e in pout.recorder.events]
    assert "tracker_fail" in kinds and "tracker_heal" in kinds
    _hold(jout.recorder, pout.recorder)


def test_partition_and_heal_trace_clean_and_equal():
    spec = adv_spec(
        topology=jcore.TopologySpec(num_pods=2, hosts_per_pod=4,
                                    host_up_bps=2e6, host_down_bps=4e6,
                                    spine_bps=float("inf"),
                                    same_pod_frac=0.8),
        arrivals=(jcore.ArrivalSpec(kind="flash", n=8, up_bps=2e6,
                                    down_bps=4e6, topology_hosts=True),),
        events=(jcore.EventSpec(kind="partition", at=2.0, target="pods:1"),
                jcore.EventSpec(kind="partition_heal", at=10.0,
                                target="pods:1")),
        telemetry=jcore.TelemetrySpec(enabled=True),
    )
    jout, _, pout, pres = _run_both(spec)
    assert next(iter(pres.outcomes.values())).completed == 8
    topo = _port_spec(spec).topology.build()
    pod_of = {h.name: topo.addr_of(h.name).pod for h in topo.hosts()}
    _hold(jout.recorder, pout.recorder, pod_of=pod_of)
    # a transfer put in across the partition while it stands is caught,
    # and alike
    a = next(h for h, pod in pod_of.items() if pod == 0)
    b = next(h for h, pod in pod_of.items() if pod == 1)
    faults = [
        jcore.TraceEvent(0.0, "peer_join", torrent="x", client=a),
        jcore.TraceEvent(0.0, "peer_join", torrent="x", client=b),
        jcore.TraceEvent(0.5, "request_issued", torrent="x", client=a,
                         origin=b, piece=0),
        jcore.TraceEvent(5.0, "piece_done", torrent="x", client=a,
                         origin=b, piece=0),
    ]
    jev = sorted([*jout.recorder.events, *faults], key=lambda ev: ev.t)
    want = jcore.TraceChecker(jev).check(pod_of=pod_of)
    assert any("cross-partition" in p for p in want)
    assert pcore.TraceChecker(_port_events(jev)).check(pod_of=pod_of) == want


def test_repair_scenario_trace_clean_and_equal():
    spec = adv_spec(
        repair=jcore.RepairSpec(target_replication=3, scan_interval=1.0),
        events=(jcore.EventSpec(kind="churn_storm", at=3.0, count=2,
                                spread=1.0, seed=9),),
        telemetry=jcore.TelemetrySpec(enabled=True),
    )
    jout, _, pout, _ = _run_both(spec)
    _hold(jout.recorder, pout.recorder)


def test_checker_flags_repair_done_without_schedule_alike():
    """``tests/test_repair.py:259`` through both checkers."""
    events = [
        jcore.TraceEvent(0.0, "peer_join", torrent="a", client="p0"),
        jcore.TraceEvent(2.0, "repair_done", torrent="a", client="p0",
                         piece=4, nbytes=100.0, info="origin"),
    ]
    got = pcore.TraceChecker(_port_events(events)).check()
    assert any("repair_done without a prior" in p for p in got)
    assert got == jcore.TraceChecker(events).check()
    events.insert(1, jcore.TraceEvent(
        1.0, "repair_scheduled", torrent="a", client="p0", piece=4,
        nbytes=100.0))
    assert pcore.TraceChecker(_port_events(events)).check() == []
    assert jcore.TraceChecker(events).check() == []
