"""Every committed scenario, built by both packages on the host engines.

The port's ``core`` is a copy of the reference's framework-free modules,
so the time and byte engines must give the same ``ScenarioResult`` and the
same per-client finish times on every committed scenario they accept, and
refuse the others with the same error. The ``fleet_*`` files are left out
on the time engine (2000-client object-engine runs take minutes); the
fleet engine is compared in ``test_torch_fleet.py``.
"""

import json
import pathlib

import pytest

from repro.core.scenario import ScenarioSpec as JaxScenarioSpec
from repro_torch.core.scenario import ScenarioSpec

SCENARIOS = pathlib.Path(__file__).parent.parent / "benchmarks" / "scenarios"
CASES = [
    (path.name, engine)
    for path in sorted(SCENARIOS.glob("*.json"))
    for engine in ("time", "byte")
    if not (engine == "time" and path.name.startswith("fleet_"))
]


def _finish_times(result, engine):
    out = {}
    for name, outcome in result.outcomes.items():
        raw = outcome.raw
        out[name] = (
            dict(raw.finish_at) if engine == "time"
            else dict(raw.completed_round)
        )
    return out


def _build_and_run(spec_cls, path, engine):
    try:
        compiled = spec_cls.load(path).build(engine)
    except ValueError as e:
        return None, str(e)
    return compiled.run(), None


@pytest.mark.parametrize("name,engine", CASES)
def test_host_engines_match_reference(name, engine):
    path = SCENARIOS / name
    ref, ref_err = _build_and_run(JaxScenarioSpec, path, engine)
    got, got_err = _build_and_run(ScenarioSpec, path, engine)
    assert got_err == ref_err
    if ref is None:
        return
    assert got.to_dict() == ref.to_dict()
    assert _finish_times(got, engine) == _finish_times(ref, engine)
    if len(ref.outcomes) == 1:
        assert type(got.primary).__name__ == type(ref.primary).__name__


def test_scenario_specs_round_trip_identically():
    """Every field equal, with one intended difference: a ``fleet`` block
    that names no backend resolves to the device tick (``"pallas"``) in
    the port and to ``"numpy"`` in the reference."""
    for path in sorted(SCENARIOS.glob("*.json")):
        got = ScenarioSpec.load(path).to_dict()
        want = JaxScenarioSpec.load(path).to_dict()
        fleet = json.loads(path.read_text()).get("fleet")
        if fleet is not None and fleet.get("backend") is None:
            assert got["fleet"]["backend"] == "pallas", path.name
            assert want["fleet"]["backend"] == "numpy", path.name
            got["fleet"]["backend"] = "numpy"
        assert got == want, path.name
