"""Every cell of ``BENCHMARK.json`` run through the harness on the CPU at
the tests' size (:mod:`portbench.tiny`): the result line's keys, the
metrics it reports, and its compared numbers beside their limits."""

import json
import time

import pytest
import torch

from portbench import cell as cells
from portbench import harness, run, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", tiny.names())
def test_cell_runs_and_prints_the_result_line(name, trace, two_threads):
    c = tiny.cell(name)
    res = run.execute(c, 2**31 + 12345, 0.5, bool(trace), "cpu", time.time())
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(c.limits["checks"])
    for check in line["checks"].values():
        assert check["value"] <= check["limit"]
    assert line["device"]["count"] == 1
    want = {m["name"] for m in c.metrics(bool(trace))}
    got = set(line["metrics"])
    if trace:
        # the CPU has no device trace: only the host-side readers read
        assert got <= want and got
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want and "setup_s" in got
    for m in c.metrics(bool(trace)):
        if m["name"] in got:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = cells.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(cells.reader(m["name"]), "read"), m["name"]
    for w in bench["workloads"]:
        c = cells.find(w["name"])
        assert c.limits["checks"]
        assert c.traffic["driver"] in ("serve", "train")


def test_check_lines_name_each_number_and_its_limit():
    lines = harness.check_lines({"logit_gap": {"value": 0.25, "limit": 0.5}})
    assert lines == ["check logit_gap 0.25 limit 0.5"]
