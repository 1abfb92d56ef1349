"""``BENCHMARK.json`` against the rules it is written to: its keys, names,
units and bounds, and that each cell's files are where the harness looks
for them."""

import json
import re
from pathlib import Path

import pytest

from portbench import cell as cells

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|_rank$"
                   r"|expan|top_k|d_model|d_ff|width)")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p and
               not p.endswith("_torch") for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in data["model"] and not WIDTH.search(key), key
            assert data["published"][key] != data["model"][key]


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert {w["config"] for w in BENCH["workloads"]} == configs


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells_ = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"] if "workloads" in m else []) <= cells_
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e
            mover = next(x for x in BENCH["end_to_end"]
                         if x["name"] == m["moves"])
            assert set(m["workloads"]) <= set(mover.get("workloads", cells_))
    assert "setup_s" in e2e
    for w in cells_:
        c = cells.find(w)
        assert any(m["name"] != "setup_s" for m in c.metrics(False))
        assert c.metrics(True)
