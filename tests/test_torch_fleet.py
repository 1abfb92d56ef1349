"""The port's fleet engine and device state vs the JAX package.

- ``FleetDeviceState`` (started from the JAX state's arrays) tracks the
  same incremental updates and builds the same candidates, index-exact,
  its have-matrix and jitter kept at a padded row pitch whose padding
  never changes; ``select_rows_ref``, the plain version of K1's gathered
  form, picks what the JAX state's ``select`` picks (the Pallas kernel in
  interpret mode) on every stream rule and edge case;
- the numpy backend is the float64 goldens path, copied: its
  ``FleetResult`` is identical to the reference's and it reproduces the
  ``scaling/fleet_n2000`` golden string of ``BENCH_swarm_scaling.json``;
- the float32 backends on ``device="cpu"`` (the kernels' plain versions)
  stay inside the bands the reference holds its Pallas backend to
  (``tests/test_kernels_swarm.py``), against both the JAX Pallas backend
  and the numpy backend;
- without CUDA a float32 backend asked for no particular device raises;
- a fleet scenario that names no backend runs the device tick, so a
  committed file built as a user builds it needs CUDA.
"""

import dataclasses
import json
import pathlib
import warnings

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
from repro_torch.kernels.swarm import FleetDeviceState, select_rows_ref

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


STREAM_RULES = [
    ("http", "swarm_first", True),
    ("http", "swarm_first", False),
    ("http", "http_first", False),
    ("swarm", "swarm_first", True),
]


def _edge_state(rng, n, P):
    """A seeded state with the gathered form's edge cases in it: a row that
    holds every piece, rows missing one piece (the ``other`` of
    :func:`_edge_rows` takes it away), replica counts at 0 (pieces 0-2:
    the origin's fallback rescue) and near ``n``. The counts are set, not
    summed from ``have``. Returns (have, jitter, swarm_class, repl)."""
    jitter = rng.random((n, P), dtype=np.float32)
    # quantized jitter forces ties down to the piece index
    jitter[: n // 4] = (rng.integers(0, 3, (n // 4, P)) / 4.0)
    swarm_class = rng.random(P) < 0.6
    swarm_class[:2] = [True, False]
    have = rng.random((n, P)) < 0.5
    have[1] = True                     # all-masked on every stream
    have[2] = True
    have[2, 1] = False                 # only piece 1 (origin-routed)
    have[3] = True
    have[3, 5] = False                 # only piece 5
    repl = have.sum(axis=0)
    repl[3::4] = n - 1 - np.arange(repl[3::4].size) % 3  # near n
    repl[5] = n - 2
    repl[:3] = 0                       # counted as served by nobody
    return have, jitter, swarm_class, repl


def _edge_rows(rng, n, P, k):
    """``k`` rows with repeats (always rows 1-3 among them) and their
    ``other``: -1, a random piece, or the row's only candidate."""
    rows = rng.integers(0, n, k)
    rows[: min(k, 3)] = [1, 2, 3][: min(k, 3)]
    other = np.where(rng.random(k) < 0.5, rng.integers(0, P, k), -1)
    other[rows == 2] = np.where(rng.random(int((rows == 2).sum())) < 0.5,
                                1, -1)
    other[rows == 3] = np.where(rng.random(int((rows == 3).sum())) < 0.5,
                                5, -1)
    return rows, other


@pytest.mark.parametrize("stream,mode,fallback", STREAM_RULES)
@pytest.mark.parametrize("n,P", [(40, 45), (24, 16), (30, 37)])
def test_select_rows_ref_matches_jax_state_select(stream, mode, fallback, n,
                                                  P):
    rng = np.random.default_rng(31 + n + P)
    have, jitter, swarm_class, repl = _edge_state(rng, n, P)
    jdev = JaxFleetDeviceState(jitter, swarm_class)
    rows_h, pieces_h = np.nonzero(have)
    jdev.add_pieces(rows_h, pieces_h)
    jdev.repl = jdev.repl + np.asarray(repl - have.sum(axis=0),
                                       dtype=np.int32)
    np.testing.assert_array_equal(np.asarray(jdev.repl), repl)
    tdev = FleetDeviceState.from_arrays(have, jitter, repl, swarm_class,
                                        device="cpu")
    kw = dict(stream=stream, mode=mode, fallback=fallback)
    for k in (1, 7, 300):
        rows, other = _edge_rows(rng, n, P, k)
        got = select_rows_ref(
            tdev.have, tdev.jitter, tdev.repl, tdev.swarm_class,
            torch.from_numpy(rows), torch.from_numpy(other), **kw)
        assert got.dtype == torch.int32 and got.shape == (k,)
        want = jdev.select(rows, other, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tdev.select(rows, other, **kw), want)
        # rows holding every piece pick nothing; a row's only candidate
        # taken by its other stream leaves it nothing either
        got = got.numpy()
        assert (got[rows == 1] == -1).all()
        assert (got[(rows == 2) & (other == 1)] == -1).all()
        assert (got[(rows == 3) & (other == 5)] == -1).all()


@pytest.mark.parametrize("P", [16, 37, 130])
def test_padded_state_tracks_jax_state(P):
    rng = np.random.default_rng(40 + P)
    n = 30
    jitter = rng.random((n, P), dtype=np.float32)
    swarm_class = rng.random(P) < 0.7
    jdev = JaxFleetDeviceState(jitter, swarm_class)
    tdev = FleetDeviceState(jitter, swarm_class, device="cpu")
    pitch = -(-P // 16) * 16
    assert tdev.pitch == pitch
    assert tdev.have.shape == tdev.jitter.shape == (n, P)
    assert tdev.have.stride() == tdev.jitter.stride() == (pitch, 1)
    have = np.zeros((n, P), dtype=bool)
    for step in range(5):
        rows, pieces = _unique_pairs(rng, have, int(rng.integers(1, 40)))
        have[rows, pieces] = True
        jdev.add_pieces(rows, pieces)
        tdev.add_pieces(rows, pieces)
        if step == 2:
            drop = np.unique(rng.integers(0, n, 4))
            jdev.drop_rows(drop)
            tdev.drop_rows(drop)
    np.testing.assert_array_equal(tdev.have.numpy(), np.asarray(jdev.have))
    np.testing.assert_array_equal(tdev.repl.numpy(), np.asarray(jdev.repl))
    np.testing.assert_array_equal(tdev.jitter.numpy(), jitter)
    # the padding columns of the buffers behind the views never change
    full_have = tdev.have.as_strided((n, pitch), (pitch, 1))
    full_jit = tdev.jitter.as_strided((n, pitch), (pitch, 1))
    assert not full_have[:, P:].any() and not full_jit[:, P:].any()
    rows = rng.integers(0, n, 25)
    other = np.where(rng.random(25) < 0.5, rng.integers(0, P, 25), -1)
    for stream, mode, fallback in STREAM_RULES:
        kw = dict(stream=stream, mode=mode, fallback=fallback)
        np.testing.assert_array_equal(tdev.select(rows, other, **kw),
                                      jdev.select(rows, other, **kw))


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
        spec, arrivals=(dataclasses.replace(spec.arrivals[0], n=2000),),
        fleet=dataclasses.replace(spec.fleet, backend="numpy"),
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


@pytest.mark.parametrize("kw,backend", [
    ({}, "pallas"),
    ({"backend": "numpy"}, "numpy"),
    ({"backend": "jit"}, "jit"),
    ({"jit": True}, "jit"),
])
def test_fleet_spec_backend_resolution(kw, backend):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        spec = FleetSpec(**kw)
    assert (spec.backend, spec.jit) == (backend, backend == "jit")
    assert FleetSpec.from_dict(spec.to_dict()) == spec


def test_committed_fleet_file_runs_the_device_tick(monkeypatch):
    spec = ScenarioSpec.load(SCENARIOS / "fleet_smoke.json")
    assert "backend" not in json.loads(
        (SCENARIOS / "fleet_smoke.json").read_text())["fleet"]
    assert spec.fleet.backend == "pallas"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spec.build("fleet")
    dev = next(iter(spec.build("fleet", device="cpu").sims.values())).run()
    host = dataclasses.replace(
        spec, fleet=dataclasses.replace(spec.fleet, backend="numpy"))
    _assert_bands(dev, next(iter(host.build("fleet").sims.values())).run())


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
