"""A cell of the benchmark, found by name in ``BENCHMARK.json``: its
configuration (``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<traffic>.json``), its limits
(``portbench/limits/<workload>.json``) and the metrics it reports
(``portbench/metrics/<metric>.py``, one reader a metric).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def model(self) -> dict:
        """The program's model configuration, as run."""
        return self.config["model"]

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports in a run: the end-to-end ones, or
        with ``trace`` the per-layer ones."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool if self.name in m.get("workloads", [self.name])]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json``; ``KeyError`` if there
    is none."""
    bench = benchmark(root)
    match = [w for w in bench["workloads"] if w["name"] == name]
    if not match:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = match[0]
    return Cell(
        name=w["name"], chips=int(w["chips"]),
        config=load_json(PACKAGE / "configs" / f"{w['config']}.json"),
        traffic=load_json(PACKAGE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(PACKAGE / "limits" / f"{w['name']}.json"),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def reader(metric: str) -> ModuleType:
    """The module ``portbench/metrics/<metric>.py`` (a name may hold dots,
    so it is loaded by path)."""
    path = PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise KeyError(f"no reader for metric {metric!r} ({path})")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
