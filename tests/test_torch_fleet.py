"""The port's fleet engine and device state vs the JAX package.

- ``FleetDeviceState`` (started from the JAX state's arrays) tracks the
  same incremental updates and builds the same candidates, index-exact;
- the numpy backend is the float64 goldens path, copied: its
  ``FleetResult`` is identical to the reference's and it reproduces the
  ``scaling/fleet_n2000`` golden string of ``BENCH_swarm_scaling.json``;
- the float32 backends on ``device="cpu"`` (the kernels' plain versions)
  stay inside the bands the reference holds its Pallas backend to
  (``tests/test_kernels_swarm.py``), against both the JAX Pallas backend
  and the numpy backend;
- without CUDA a float32 backend asked for no particular device raises.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core.scenario import ScenarioSpec as JaxScenarioSpec
from repro.kernels.swarm import FleetDeviceState as JaxFleetDeviceState
from repro_torch.core.fleet import FleetSpec, FleetSwarmSim
from repro_torch.core.metainfo import MetaInfo
from repro_torch.core.piece_selection import batched_rarest
from repro_torch.core.scenario import ScenarioSpec
from repro_torch.core.webseed import MirrorSpec
from repro_torch.kernels.swarm import FleetDeviceState

ROOT = pathlib.Path(__file__).parent.parent
SCENARIOS = ROOT / "benchmarks" / "scenarios"
SIZE = 4e9


def _smoke(backend, n=200):
    spec = json.loads((SCENARIOS / "fleet_smoke.json").read_text())
    spec["arrivals"][0]["n"] = n
    spec["fleet"] = {"dt": 1.0, "fanout": None, "backend": backend}
    return spec


def _run(spec_cls, spec_dict, **build):
    compiled = spec_cls.from_dict(spec_dict).build("fleet", **build)
    return next(iter(compiled.sims.values())).run()


# ------------------------------------------------------------------ device state


def _unique_pairs(rng, have, count):
    n, P = have.shape
    flat = np.unique(rng.integers(0, n * P, count))
    rows, pieces = flat // P, flat % P
    newly = ~have[rows, pieces]
    return rows[newly], pieces[newly]


def test_device_state_from_jax_state_tracks_incremental_updates():
    rng = np.random.default_rng(20)
    n, P = 50, 30
    jitter = rng.random((n, P), dtype=np.float32)
    swarm_class = rng.random(P) < 0.7
    jdev = JaxFleetDeviceState(jitter, swarm_class)
    have = np.zeros((n, P), dtype=bool)
    for _ in range(3):
        rows, pieces = _unique_pairs(rng, have, int(rng.integers(1, 12)))
        have[rows, pieces] = True
        jdev.add_pieces(rows, pieces)
    # carry the JAX state across mid-run, then update both the same way
    tdev = FleetDeviceState.from_arrays(
        np.asarray(jdev.have), np.asarray(jdev.jitter), np.asarray(jdev.repl),
        np.asarray(jdev.swarm_class), device="cpu",
    )
    for _ in range(4):
        rows, pieces = _unique_pairs(rng, have, int(rng.integers(1, 12)))
        have[rows, pieces] = True
        jdev.add_pieces(rows, pieces)
        tdev.add_pieces(rows, pieces)
    np.testing.assert_array_equal(tdev.have.numpy(), np.asarray(jdev.have))
    np.testing.assert_array_equal(tdev.have.numpy(), have)
    np.testing.assert_array_equal(tdev.repl.numpy(), np.asarray(jdev.repl))
    drop = np.unique(rng.integers(0, n, 7))
    jdev.drop_rows(drop)
    tdev.drop_rows(drop)
    np.testing.assert_array_equal(tdev.repl.numpy(), np.asarray(jdev.repl))
    np.testing.assert_array_equal(
        tdev.repl.numpy(), have.sum(axis=0) - have[drop].sum(axis=0)
    )


@pytest.mark.parametrize("stream,mode,fallback", [
    ("http", "swarm_first", True),
    ("http", "swarm_first", False),
    ("http", "http_first", False),
    ("swarm", "swarm_first", True),
])
def test_device_select_matches_engine_cand_build(stream, mode, fallback):
    rng = np.random.default_rng(21)
    n, P = 60, 45
    jitter = rng.random((n, P), dtype=np.float32)
    swarm_class = rng.random(P) < 0.6
    have = np.zeros((n, P), dtype=bool)
    rows_h, pieces_h = _unique_pairs(rng, have, 200)
    have[rows_h, pieces_h] = True
    repl = have.sum(axis=0)
    tdev = FleetDeviceState(jitter, swarm_class, device="cpu")
    tdev.add_pieces(rows_h, pieces_h)
    jdev = JaxFleetDeviceState(jitter, swarm_class)
    jdev.add_pieces(rows_h, pieces_h)

    rows = np.unique(rng.integers(0, n, 20))
    other = np.where(rng.random(rows.size) < 0.5,
                     rng.integers(0, P, rows.size), -1)
    # the engine's numpy cand build (FleetSwarmSim._select)
    missing = ~have[rows]
    if stream == "http":
        if mode == "http_first":
            cand = missing.copy()
        else:
            cand = missing & ~swarm_class[None, :]
            if fallback:
                cand |= missing & swarm_class[None, :] & (repl == 0)[None, :]
    else:
        cand = missing & swarm_class[None, :] & (repl > 0)[None, :]
    has_other = other >= 0
    cand[np.flatnonzero(has_other), other[has_other]] = False
    kw = dict(stream=stream, mode=mode, fallback=fallback)
    got = tdev.select(rows, other, **kw)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, batched_rarest(cand, repl, jitter[rows]))
    np.testing.assert_array_equal(got, jdev.select(rows, other, **kw))


# ------------------------------------------------------------------ numpy backend


def test_numpy_backend_result_identical_to_reference():
    ref = _run(JaxScenarioSpec, _smoke("numpy"))
    got = _run(ScenarioSpec, _smoke("numpy"))
    assert got.completed == ref.completed == 200
    for f in dataclasses.fields(ref):
        if f.name == "phase_seconds":  # wall-clock, not an outcome
            assert set(got.phase_seconds) == set(ref.phase_seconds)
            continue
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_numpy_backend_reproduces_fleet_n2000_golden():
    golden = next(
        r["derived"]
        for r in json.loads((ROOT / "BENCH_swarm_scaling.json").read_text())[
            "rows"]
        if r["name"] == "scaling/fleet_n2000"
    )
    spec = ScenarioSpec.load(SCENARIOS / "fleet_scaling.json")
    spec = dataclasses.replace(
        spec, arrivals=(dataclasses.replace(spec.arrivals[0], n=2000),)
    )
    res = spec.build("fleet").run().primary
    done = np.isfinite(res.completed_at)
    derived = (
        f"t_all={float(res.completed_at[done].max()):.0f}s "
        f"ud={res.ud_ratio:.1f} ticks={res.ticks} "
        f"copies={res.origin_uploaded / SIZE:.2f} "
        f"done={int(done.sum())}/{res.n}"
    )
    assert derived == golden


# ------------------------------------------------------------------ float32 backends


def _assert_bands(dev, ref):
    """The reference's own float32-vs-float64 bands
    (``tests/test_kernels_swarm.py`` engine parity)."""
    assert ref.completed == dev.completed == dev.n
    assert abs(dev.ticks - ref.ticks) <= max(5, 0.02 * ref.ticks)
    np.testing.assert_array_equal(dev.downloaded, ref.downloaded)
    np.testing.assert_allclose(
        dev.mirror_uploaded, ref.mirror_uploaded, atol=2 * 32e6, rtol=0.02
    )
    for q in (50, 90, 99):
        lo = np.percentile(ref.durations, q)
        hi = np.percentile(dev.durations, q)
        assert abs(hi - lo) <= max(5 * dev.dt, 0.03 * lo), (q, lo, hi)
    assert abs(dev.uploaded_wire.sum() - ref.uploaded_wire.sum()) \
        <= 0.02 * ref.uploaded_wire.sum()


def test_pallas_backend_on_cpu_within_reference_bands():
    port = _run(ScenarioSpec, _smoke("pallas"), device="cpu")
    _assert_bands(port, _run(ScenarioSpec, _smoke("numpy")))
    # the JAX Pallas backend runs its kernels in interpret mode, a few
    # seconds per hundred ticks: hold the two float32 paths to each other
    # on a 100-peer crowd
    port_small = _run(ScenarioSpec, _smoke("pallas", n=100), device="cpu")
    _assert_bands(port_small, _run(JaxScenarioSpec, _smoke("pallas", n=100)))
    assert set(port.phase_seconds) == {
        "select", "waterfill", "bookkeeping", "telemetry"
    }


def test_jit_backend_on_cpu_within_reference_bands():
    port = _run(ScenarioSpec, _smoke("jit"), device="cpu")
    _assert_bands(port, _run(ScenarioSpec, _smoke("numpy")))


# ------------------------------------------------------------------ devices


def _tiny_sim(backend, **kw):
    mi = MetaInfo.from_sizes_only(int(64e6), int(8e6), name="x")
    return FleetSwarmSim(mi, fleet=FleetSpec(backend=backend), **kw)


@pytest.mark.parametrize("backend", ["pallas", "jit"])
def test_float32_backend_without_cuda_raises(backend, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _tiny_sim(backend)
    spec = _smoke(backend)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScenarioSpec.from_dict(spec).build("fleet")


def test_device_rules_for_host_engines():
    with pytest.raises(ValueError, match="host float64 path"):
        _tiny_sim("numpy", device="cuda")
    spec = ScenarioSpec.from_dict(_smoke("numpy"))
    with pytest.raises(ValueError, match="runs on the host"):
        spec.build("time", device="cpu")
    # the numpy backend on the host runs as before
    sim = _tiny_sim("numpy", device="cpu")
    sim.add_mirrors([MirrorSpec("origin", up_bps=50e6)])
    sim.add_peers([("p0", 0.0)], up_bps=25e6, down_bps=50e6)
    assert sim.run().completed == 1
